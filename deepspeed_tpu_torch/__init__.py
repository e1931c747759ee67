"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

Counterpart of ``deepspeed_tpu/__init__.py``.  The port mirrors the JAX
package's module paths (``models/gpt2.py``, ``inference/serving.py``,
``ops/transformer/paged_attention.py`` ...) so each file names its
reference, and it imports neither ``jax`` nor anything of
``deepspeed_tpu``.

Deliberate difference: importing the package is light.  The JAX facade
imports the training engine eagerly; here nothing below the package is
imported until a caller asks for it (``deepspeed_tpu_torch.inference``,
``deepspeed_tpu_torch.models``), and no kernel is built at import time —
CUDA sources compile at the first launch (``ops/op_builder/cuda.py``).
"""

from .version import __version__

__all__ = ["__version__"]
