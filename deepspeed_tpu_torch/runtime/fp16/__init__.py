"""fp16 mixed precision: the dynamic loss scaler (``loss_scaler.py``).

Counterpart of ``deepspeed_tpu/runtime/fp16``; its ``onebit`` optimizers
are not ported."""
