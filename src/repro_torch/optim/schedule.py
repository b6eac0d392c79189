"""Learning-rate schedules (multipliers of the base lr) and the DQN
epsilon decay.

Counterpart of ``repro/optim/schedule.py``: each factory returns a
function of the step (an integer tensor) giving a float32 tensor on the
step's device.
"""
from __future__ import annotations

import math

import torch


def constant():
    """Always 1."""
    return lambda step: torch.ones((), dtype=torch.float32,
                                   device=step.device)


def linear_warmup(warmup_steps: int):
    """``min(1, step / warmup_steps)``."""
    def fn(step):
        s = step.to(torch.float32)
        return torch.clamp(s / max(warmup_steps, 1), max=1.0)
    return fn


def warmup_cosine(warmup_steps: int, total_steps: int,
                  final_fraction: float = 0.1):
    """Linear warmup, then a cosine from 1 down to ``final_fraction`` at
    ``total_steps``."""
    def fn(step):
        s = step.to(torch.float32)
        warm = torch.clamp(s / max(warmup_steps, 1), max=1.0)
        frac = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_fraction + (1 - final_fraction) * 0.5 \
            * (1 + torch.cos(math.pi * frac))
        return warm * cos
    return fn


def linear_epsilon(start: float, end: float, fraction_steps: int):
    """Epsilon-greedy exploration decay: ``start`` to ``end`` over
    ``fraction_steps``, then flat."""
    def fn(step):
        frac = torch.clamp(step.to(torch.float32) / max(fraction_steps, 1),
                           0.0, 1.0)
        return start + frac * (end - start)
    return fn
