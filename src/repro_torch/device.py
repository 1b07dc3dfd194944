"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device=None) -> torch.device:
    """``device`` (default ``"cuda"``) -> ``torch.device``.

    Raises when a CUDA device is asked for and none is present: the port
    never carries on on the CPU unless the caller asked for it.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch route on the CPU")
    return dev


def default_backend(device) -> str:
    """The kernels on the card, the plain route on the CPU."""
    return "cuda" if torch.device(device).type == "cuda" else "torch"
