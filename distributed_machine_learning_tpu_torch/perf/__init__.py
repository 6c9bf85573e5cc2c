"""Performance accounting of the port."""
