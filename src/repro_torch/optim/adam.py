"""Adam / AdamW with global-norm clipping and optional 8-bit moments, on
param trees.

Counterpart of ``repro/optim/adam.py``.  Params, gradients and the
moments are nested dicts of tensors (``core.ptq.tree_map``);
``adam_update`` is functional, returning new params and state (the RL
learners keep the pre-step params: DQN's warm-up picks between old and
new); ``adam_update_`` writes the same values into the params' and the
moments' own storage and returns the same tensors, the counterpart of
the reference's LM step donating params and moments
(``donate_argnums=(0, 1, 3)``), so a step holds one copy of each.  The
update keeps the reference's expression order,

    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g**2
    p = p - lr * ((m / bc1) / (sqrt(v / bc2) + eps) [+ wd * p])

with ``bc = 1 - b ** step`` in float32 on the device (no host sync) and
``lr`` times ``schedule(step)`` when a schedule is given.  Scalar
divisions divide a tensor by a tensor, so the card rounds them
correctly, as the CPU does.

8-bit moments (``eightbit=True``): each moment is stored as int8 codes
of the parameter's shape and one float32 scale per 256-value block of
the last axis (``BlockQuantized``, ``block_quantize``: one max, one
division and a round-half-even, bitwise the reference's), dequantized,
updated and requantized inside the step, leaf by leaf: the float32
moments are transient, the codes persist (about 2.03 bytes a parameter
for both moments against 8).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.ptq import tree_map, tree_tensors

Tree = Any
BLOCK = 256


# ---------------------------------------------------------------------------
# block-wise quantized tensors (the 8-bit moments)
# ---------------------------------------------------------------------------

class BlockQuantized(NamedTuple):
    """A tensor as int8 ``codes`` of its own shape and one float32 scale
    per block of its last axis (``scales``: ``shape[:-1] + (blocks,)``);
    ``shape`` is the source's."""

    codes: torch.Tensor
    scales: torch.Tensor
    shape: Tuple[int, ...]


def _block_size(last_dim: int) -> int:
    return BLOCK if last_dim % BLOCK == 0 else last_dim


def _blocks(x: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    if not shape:
        return x.reshape(1, 1)
    # models.common.reshape: a DTensor whose split the blocks do not
    # divide is gathered first
    from repro_torch.models import common
    return common.reshape(x, *(tuple(shape[:-1])
                               + (-1, _block_size(shape[-1]))))


def block_quantize(x: torch.Tensor) -> BlockQuantized:
    """Symmetric int8 codes per block of the last axis: ``scale =
    amax / 127`` (1 for an all-zero block), ``codes = clip(round(x /
    scale), -127, 127)``, round half to even."""
    shape = tuple(x.shape)
    xb = _blocks(x.to(torch.float32), shape)
    amax = torch.amax(torch.abs(xb), dim=-1, keepdim=True)
    scales = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    codes = torch.clamp(torch.round(xb / scales), -127, 127).to(torch.int8)
    return BlockQuantized(codes.reshape(shape), scales[..., 0], shape)


def block_dequantize(q: BlockQuantized,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``codes * scale``, back in the source's shape."""
    out = _blocks(q.codes, q.shape).to(torch.float32) * q.scales[..., None]
    return out.reshape(q.shape).to(dtype)


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdamConfig:
    """Adam's hyperparameters (the reference's fields and defaults):
    ``weight_decay`` makes it AdamW, ``eightbit`` stores the moments as
    ``BlockQuantized``, ``schedule`` maps the step to an lr multiplier."""

    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: Optional[float] = 1.0
    eightbit: bool = False
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


class AdamState(NamedTuple):
    """Step count (0-d int32) and the first and second moments (float32
    tensors, or ``BlockQuantized`` with ``eightbit``)."""

    step: torch.Tensor
    m: Tree
    v: Tree


def _map(fn, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of nested dicts and lists (a
    ``BlockQuantized`` is one leaf)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, *xs) for xs in zip(tree, *rest)]
    return fn(tree, *rest)


def adam_init(params: Tree, config: AdamConfig) -> AdamState:
    """Zero moments shaped like ``params``, on their device; m and v are
    distinct tensors."""
    device = next(t for _, t in tree_tensors(params)).device

    def zeros(p):
        z = torch.zeros_like(p, dtype=torch.float32)
        return block_quantize(z) if config.eightbit else z
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                     m=_map(zeros, params), v=_map(zeros, params))


def moment_bytes(state: AdamState) -> int:
    """Bytes the two moments hold (codes and scales with ``eightbit``)."""
    total = 0
    for tree in (state.m, state.v):
        leaves = []
        _map(leaves.append, tree)
        for x in leaves:
            parts = (x.codes, x.scales) if isinstance(x, BlockQuantized) \
                else (x,)
            total += sum(t.numel() * t.element_size() for t in parts)
    return total


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


def _prepare(grads: Tree, state: AdamState, config: AdamConfig):
    """The clipped grads, the stats, the new step and the leaf update."""
    stats = {}
    if config.grad_clip is not None:
        grads, stats["grad_norm"] = clip_by_global_norm(grads,
                                                        config.grad_clip)
    step = state.step + 1
    lr, b1, b2 = config.lr, config.b1, config.b2
    if config.schedule is not None:
        lr = lr * config.schedule(step)
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.full_like(stepf, b1) ** stepf
    bc2 = 1.0 - torch.full_like(stepf, b2) ** stepf

    def leaf(p, m_q, v_q, g):
        mm = block_dequantize(m_q) if config.eightbit else m_q
        vv = block_dequantize(v_q) if config.eightbit else v_q
        g32 = g.to(torch.float32)
        mm = b1 * mm + (1 - b1) * g32
        vv = b2 * vv + (1 - b2) * torch.square(g32)
        delta = (mm / bc1) / (torch.sqrt(vv / bc2) + config.eps)
        if config.weight_decay:
            delta = delta + config.weight_decay * p.to(torch.float32)
        new_p = (p.to(torch.float32) - lr * delta).to(p.dtype)
        if config.eightbit:
            return new_p, block_quantize(mm), block_quantize(vv)
        return new_p, mm, vv
    return grads, stats, step, leaf


def adam_update(grads: Tree, state: AdamState, params: Tree,
                config: AdamConfig) -> Tuple[Tree, AdamState, dict]:
    """One Adam step: ``(new_params, new_state, stats)``; ``stats`` holds
    the pre-clip ``grad_norm`` when clipping is on."""
    grads, stats, step, leaf = _prepare(grads, state, config)
    out = _map(leaf, params, state.m, state.v, grads)
    return (_pick(out, 0), AdamState(step, _pick(out, 1), _pick(out, 2)),
            stats)


def adam_update_(grads: Tree, state: AdamState, params: Tree,
                 config: AdamConfig) -> Tuple[Tree, AdamState, dict]:
    """``adam_update`` in place: each param, moment (8-bit codes and
    scales too) and the step count take their new values in their own
    storage, leaf by leaf (one leaf's float32 temporaries at a time), and
    the same ``params`` and ``state`` come back with the stats.  Bitwise
    ``adam_update``'s values."""
    grads, stats, step, leaf = _prepare(grads, state, config)

    def write(p, m_q, v_q, g):
        new_p, new_m, new_v = leaf(p, m_q, v_q, g)
        p.copy_(new_p)
        for old, new in ((m_q, new_m), (v_q, new_v)):
            if config.eightbit:
                old.codes.copy_(new.codes)
                old.scales.copy_(new.scales)
            else:
                old.copy_(new)
    _map(write, params, state.m, state.v, grads)
    state.step.copy_(step)
    return params, state, stats


def _pick(tree, i: int):
    """Field ``i`` of every ``(p, m, v)`` triple of a ``_map`` tree."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]
