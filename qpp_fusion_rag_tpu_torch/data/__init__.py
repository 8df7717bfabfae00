"""Host-side data generators of the port (numpy only)."""
