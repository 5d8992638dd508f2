"""Host-side sparse formats of the port."""
