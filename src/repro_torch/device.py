"""Where the port's entry points put their tensors.

Every entry point takes ``device=None``, which means ``cuda``: the port
runs on the card unless the caller asks for the CPU (``device="cpu"``, as
the tests do).  Without a card, ``None`` or ``"cuda"`` raises; the port
never falls back to the CPU on its own.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises ``RuntimeError`` for CUDA without a
    card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to "
                           "run the plain versions on the CPU")
    return dev
