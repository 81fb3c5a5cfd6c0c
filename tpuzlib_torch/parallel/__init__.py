"""Host-side block discovery for the device inflate."""
