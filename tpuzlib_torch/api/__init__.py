"""Public API of the port: the checksums (checksums.py), compression
(deflate_api.py: deflate(), the Deflater and their options) and
decompression (inflate_api.py: inflate(), the Inflater, its options and
verdict)."""
