"""Optimizers of the port (``repro.optim``'s counterparts)."""
