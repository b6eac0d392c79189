"""Adam with global-norm gradient clipping, on param trees (fp32 path).

Counterpart of ``repro/optim/adam.py:82-185``.  Params, gradients and the
moments are nested dicts of f32 tensors (``core.ptq.tree_map``);
``adam_update`` is functional, returning new params and state.  The
update keeps the reference's expression order,

    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g**2
    p = p - lr * ((m / bc1) / (sqrt(v / bc2) + eps))

with ``bc = 1 - b ** step`` in float32 on the device (no host sync).
Scalar divisions divide a tensor by a tensor, so the card rounds them
correctly, as the CPU does.  The LM trainer's extras -- 8-bit moments
(``eightbit=True`` raises until then), weight decay and an lr schedule
-- come with the LM half (ROADMAP queue A, item 13).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.ptq import tree_map, tree_tensors

Tree = Any


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    """Adam's hyperparameters (the reference's fields and defaults)."""

    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    grad_clip: Optional[float] = 1.0
    eightbit: bool = False


class AdamState(NamedTuple):
    """Step count (0-d int32) and the first and second moments."""

    step: torch.Tensor
    m: Tree
    v: Tree


def _check(config: AdamConfig) -> None:
    if config.eightbit:
        raise NotImplementedError(
            "8-bit Adam moments are not ported yet (ROADMAP queue A, "
            "item 13)")


def adam_init(params: Tree, config: AdamConfig) -> AdamState:
    """Zero moments shaped like ``params``, on their device."""
    _check(config)
    device = next(t for _, t in tree_tensors(params)).device
    return AdamState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params),
        v=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params))


def global_norm(tree: Tree) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every leaf, summed leaf by leaf in
    the reference's order (sorted keys)."""
    total = 0
    for _, x in tree_tensors(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    """Scale ``grads`` by ``min(1, max_norm / max(norm, 1e-12))``."""
    norm = global_norm(grads)
    factor = torch.clamp(
        torch.full_like(norm, max_norm) / torch.clamp(norm, min=1e-12),
        max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * factor).to(g.dtype),
                    grads), norm


def adam_update(grads: Tree, state: AdamState, params: Tree,
                config: AdamConfig) -> Tuple[Tree, AdamState, dict]:
    """One Adam step: ``(new_params, new_state, stats)``; ``stats`` holds
    the pre-clip ``grad_norm`` when clipping is on."""
    _check(config)
    stats = {}
    if config.grad_clip is not None:
        grads, stats["grad_norm"] = clip_by_global_norm(grads,
                                                        config.grad_clip)
    step = state.step + 1
    lr, b1, b2 = config.lr, config.b1, config.b2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.full_like(stepf, b1) ** stepf
    bc2 = 1.0 - torch.full_like(stepf, b2) ** stepf

    def leaf(p, mm, vv, g):
        g32 = g.to(torch.float32)
        mm = b1 * mm + (1 - b1) * g32
        vv = b2 * vv + (1 - b2) * torch.square(g32)
        delta = (mm / bc1) / (torch.sqrt(vv / bc2) + config.eps)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), mm, vv

    out = tree_map(leaf, params, state.m, state.v, grads)
    return (_pick(out, 0), AdamState(step, _pick(out, 1), _pick(out, 2)),
            stats)


def _pick(tree, i: int):
    """Field ``i`` of every ``(p, m, v)`` triple of a tree of dicts."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
