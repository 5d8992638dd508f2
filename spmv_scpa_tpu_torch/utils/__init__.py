"""Device helpers."""
