"""Pipeline entry points of the port."""
