"""Host-side parallel layers: block discovery for the device inflate
(speculative.py) and concatenated gzip members (members.py)."""
