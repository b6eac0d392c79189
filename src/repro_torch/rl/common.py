"""Shared RL helpers of the port (the subset the behaviour policy needs).

Counterpart of ``repro/rl/common.py:114-116``.
"""
from __future__ import annotations

import torch


def linear_epsilon(step: torch.Tensor, start: float, end: float,
                   decay_steps: int) -> torch.Tensor:
    """epsilon annealed linearly from ``start`` to ``end`` over
    ``decay_steps`` (a tensor ``step``, so no host sync).  The divisor is
    a tensor, so the card divides correctly rounded, as the CPU does."""
    step = step.to(torch.float32)
    frac = torch.clamp(step / step.new_full((), float(max(decay_steps, 1))),
                       0.0, 1.0)
    return start + frac * (end - start)
