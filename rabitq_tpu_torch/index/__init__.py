"""Index construction, device layout and search of the port."""
