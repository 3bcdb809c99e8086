"""Data generators the port keeps its own copies of (numpy only)."""
