"""The plain reference: Python's zlib, which shares no code with the port."""
