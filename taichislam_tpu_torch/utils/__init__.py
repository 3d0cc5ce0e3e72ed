"""Host-side helpers (numpy only)."""
