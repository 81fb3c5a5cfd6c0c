"""Host utilities: the allocator tuning of the one-shot codec paths (mem.py)."""
