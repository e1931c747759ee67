"""Model zoo of the port (counterpart of ``deepspeed_tpu/models/__init__.py``;
the GPT-2 and BERT families so far)."""

from .gpt2 import GPT2, GPT2Config, PRESETS as GPT2_PRESETS, params_from_jax
from .bert import Bert, BertConfig, PRESETS as BERT_PRESETS, bert_params_from_jax


def build(name, **overrides):
    """Model factory by preset name (GPT-2 and ``bert-*`` presets, as
    ``build`` 6-31)."""
    if name in GPT2_PRESETS:
        return GPT2(preset=name, **overrides)
    if name.startswith("bert"):
        if name not in BERT_PRESETS:
            raise ValueError(f"Unknown preset {name!r} for its model family; BERT "
                             f"presets: {sorted(BERT_PRESETS)}")
        return Bert(preset=name, **overrides)
    raise ValueError(f"Unknown model preset {name!r}; GPT-2 presets: "
                     f"{sorted(GPT2_PRESETS)}, BERT presets: {sorted(BERT_PRESETS)}")


__all__ = ["GPT2", "GPT2Config", "GPT2_PRESETS", "Bert", "BertConfig", "BERT_PRESETS",
           "build", "params_from_jax", "bert_params_from_jax"]
