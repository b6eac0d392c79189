"""Mixed / half-precision training (QuaRL Sec. 5; Micikevicius 2017).

Counterpart of ``repro/core/mixed_precision.py``.  Master weights stay
float32; the forward and backward passes run in the config's compute
dtype (``to_compute`` casts every floating leaf, and autograd carries the
gradient back through the cast to the float32 masters).
``DynamicLossScale`` is the standard schedule: halve on non-finite
gradients and skip the update, double after ``growth_interval`` clean
steps.  Everything stays on the device: no host sync.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core.ptq import tree_map, tree_tensors
from repro_torch.core.qconfig import MixedPrecisionConfig

Tree = Any


def cast_floating(tree: Tree, dtype: torch.dtype) -> Tree:
    """Every floating tensor of ``tree`` cast to ``dtype``; other leaves
    as they are."""
    def one(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dtype)
        return x
    return tree_map(one, tree)


def to_compute(params: Tree, mp: MixedPrecisionConfig) -> Tree:
    """``params`` in ``mp``'s compute dtype (unchanged when ``mp`` is
    off)."""
    if not mp.enabled:
        return params
    return cast_floating(params, getattr(torch, mp.compute_dtype))


class DynamicLossScale(NamedTuple):
    """The loss scale (float32 scalar) and the clean steps since it last
    changed (int32 scalar)."""

    scale: torch.Tensor
    good_steps: torch.Tensor

    @staticmethod
    def init(initial: float = 2.0 ** 15, device=None) -> "DynamicLossScale":
        """Scale ``initial``, no clean steps yet."""
        return DynamicLossScale(
            torch.tensor(initial, dtype=torch.float32, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def all_finite(tree: Tree) -> torch.Tensor:
    """A bool scalar: every floating leaf finite (true for a tree with
    none)."""
    flags = [torch.isfinite(x).all() for _, x in tree_tensors(tree)
             if x.is_floating_point()]
    if not flags:
        return torch.ones((), dtype=torch.bool)
    return torch.stack(flags).all()


def scale_loss(loss: torch.Tensor,
               ls: Optional[DynamicLossScale]) -> torch.Tensor:
    """``loss * scale`` (in the loss's dtype), or ``loss`` without a
    scale."""
    return loss if ls is None else loss * ls.scale.to(loss.dtype)


def unscale_grads(grads: Tree, ls: Optional[DynamicLossScale]) -> Tree:
    """Every gradient times ``1 / scale``, in float32, back in its own
    dtype."""
    if ls is None:
        return grads
    inv = 1.0 / ls.scale
    return tree_map(lambda g: (g.to(torch.float32) * inv).to(g.dtype),
                    grads)


def update_loss_scale(ls: DynamicLossScale, grads_finite: torch.Tensor,
                      growth_interval: int = 2000, factor: float = 2.0,
                      min_scale: float = 1.0) -> DynamicLossScale:
    """The next scale: times ``factor`` after ``growth_interval`` clean
    steps, divided by it (not below ``min_scale``) on a non-finite step,
    else unchanged."""
    grew = ls.good_steps + 1 >= growth_interval
    new_scale = torch.where(
        grads_finite, torch.where(grew, ls.scale * factor, ls.scale),
        torch.clamp(ls.scale / factor, min=min_scale))
    new_good = torch.where(grads_finite & ~grew, ls.good_steps + 1,
                           torch.zeros_like(ls.good_steps))
    return DynamicLossScale(new_scale, new_good)


def select_tree(pred: torch.Tensor, on_true: Tree, on_false: Tree) -> Tree:
    """Leaf by leaf ``where(pred, a, b)`` over matching trees (skip the
    update on a non-finite step)."""
    return tree_map(lambda a, b: torch.where(pred, a, b), on_true, on_false)
