"""Mixed-precision helpers (loss scaling)."""
