"""Communication-layer helpers of the port (the block quantizer)."""
