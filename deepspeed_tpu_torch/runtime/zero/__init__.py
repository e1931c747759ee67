"""ZeRO (counterpart of ``deepspeed_tpu/runtime/zero``): the config (stages
0-3 share one placement on one device), and the optimizer offload tier
(``offload_engine.py``, ``wire.py``)."""
