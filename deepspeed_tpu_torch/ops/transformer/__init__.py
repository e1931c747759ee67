"""Transformer kernels of the port (paged attention)."""
