"""Native host libraries of the port (CPU Adam, async file I/O)."""
