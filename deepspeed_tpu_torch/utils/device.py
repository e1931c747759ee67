"""Device resolution for the port's entry points.

``GPT2``, ``InferenceEngine`` and ``ServingEngine`` run on ``cuda``
unless the caller passes ``device="cpu"`` (as the tests do).  With no
CUDA device and no explicit device they raise: the port never falls
back to the CPU quietly.
"""

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
