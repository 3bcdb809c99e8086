"""Serving step builders (``steps``)."""
