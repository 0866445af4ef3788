"""Serving surface of the port (so far the versioned model snapshot)."""
