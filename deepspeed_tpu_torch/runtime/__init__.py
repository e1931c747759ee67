"""Runtime helpers of the port (block quantizer, health sentinels)."""
