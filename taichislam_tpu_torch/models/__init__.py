"""Map types with the reference public API."""
