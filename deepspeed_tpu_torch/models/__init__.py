"""Model zoo of the port (counterpart of ``deepspeed_tpu/models/__init__.py``;
GPT-2 presets only so far)."""

from .gpt2 import GPT2, GPT2Config, PRESETS as GPT2_PRESETS, params_from_jax


def build(name, **overrides):
    """Model factory by preset name (GPT-2 presets)."""
    if name in GPT2_PRESETS:
        return GPT2(preset=name, **overrides)
    raise ValueError(f"Unknown model preset {name!r}; GPT-2 presets: "
                     f"{sorted(GPT2_PRESETS)}")


__all__ = ["GPT2", "GPT2Config", "GPT2_PRESETS", "build", "params_from_jax"]
