"""Host-side utilities of the port (table-layout conversion)."""
