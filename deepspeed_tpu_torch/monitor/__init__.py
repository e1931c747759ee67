"""Monitoring helpers of the port (the latency histogram, the bounded ring)."""
