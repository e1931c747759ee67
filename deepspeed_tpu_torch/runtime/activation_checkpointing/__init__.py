"""Activation checkpointing (counterpart of
``deepspeed_tpu/runtime/activation_checkpointing``)."""

from . import checkpointing

__all__ = ["checkpointing"]
