"""Checkpoint serialization, the atomic commit protocol and constants
(counterpart of ``deepspeed_tpu/checkpoint/__init__.py``)."""

from . import constants
from . import atomic
from .serialization import save_tree, load_tree, restore_like, place_like

__all__ = ["constants", "atomic", "save_tree", "load_tree", "restore_like", "place_like"]
