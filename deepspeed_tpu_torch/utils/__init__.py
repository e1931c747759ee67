"""Shared helpers of the port (logging, device resolution)."""
