"""Host C++ of the inflate path, built with g++ on first use (bindings.py)."""
