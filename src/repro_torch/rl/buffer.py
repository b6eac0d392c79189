"""Replay buffers: fixed-size circular buffers of transitions on the
device, uniform or prioritized, single, sharded or double.

Counterpart of ``repro/rl/buffer.py``.

* **Uniform** -- ``replay_init`` / ``replay_add_batch`` /
  ``replay_sample``: every written transition is equally likely.
  ``replay_sample`` draws with replacement from the written prefix
  ``[0, max(size, 1))``, the reference's contract, with the bound read on
  the device, so sampling never waits on the host.
* **Prioritized** (PER) -- ``per_init`` / ``per_add`` / ``per_sample`` /
  ``per_update_priorities``: transitions are drawn in proportion to
  ``(|td| + eps) ** alpha`` held in a sum-tree, with importance-sampling
  weights.  The tree is summed pair by pair up the levels, in the
  reference's order, so its totals and ``sum_tree_find`` are bitwise the
  reference's on the same priorities and the same uniforms.
  ``alpha == 0`` is exactly uniform and takes the uniform path
  (``use_prioritized``), so it is bitwise ``replay="uniform"``.
* **Sharded** -- ``n_shards`` independent buffers stacked on a leading
  axis (one per actor of the actor-learner topologies): data
  ``(n_shards, capacity, ...)``, cursors ``(n_shards,)``, one sum-tree a
  shard.  Every function below takes the leading shard axis as it comes,
  so the ``*_sharded`` names are the same functions as the single ones
  (the reference ``vmap``s them).
* **Double buffer** (``DoubleBuffer``) -- the async topology's two
  independent sharded slots: a write slot the actors fill and a read slot
  the learner drains, swapped at sync points by exchanging references.

Every write is out of place, as in the reference: the old state stays as
it was.  The async topology keeps it so for its write slot too: one
write path serves all three topologies, and a slot that changes hands at
a swap is handed to the other CUDA stream by ``record_stream``
(``rl.actor_learner``), so the caching allocator never reuses its memory
under a pending read.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple

import torch

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.core.ptq import tree_flatten, tree_map
from repro_torch.device import resolve_device

REPLAY_MODES = ("uniform", "prioritized")


def validate_replay(replay: str) -> str:
    """Return ``replay`` if it is one of ``REPLAY_MODES``, else raise
    ``ValueError``."""
    if replay not in REPLAY_MODES:
        raise ValueError(f"replay must be one of {REPLAY_MODES}, "
                         f"got {replay!r}")
    return replay


def use_prioritized(replay: str, priority_exponent: float) -> bool:
    """Does this (replay, alpha) pair need the sum-tree?  ``alpha == 0``
    makes every priority 1, exact uniform sampling, so it takes the
    uniform path wholesale, as in the reference: that is what makes the
    ``alpha == 0`` contract bitwise (the two samplers draw differently)."""
    validate_replay(replay)
    if replay != "prioritized":
        return False
    if priority_exponent < 0.0:
        raise ValueError(f"priority_exponent must be >= 0, "
                         f"got {priority_exponent}")
    return priority_exponent != 0.0


class Transition(NamedTuple):
    """A batch of transitions (or the whole buffer: leading dim =
    capacity, after the shard axis if there is one)."""

    obs: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    next_obs: torch.Tensor


class ReplayState(NamedTuple):
    """The buffer, the next write slot and the count of valid entries
    (int32; 0-d, or ``(n_shards,)`` when sharded)."""

    data: Transition
    index: torch.Tensor
    size: torch.Tensor


def replay_init(capacity: int, obs_shape, action_shape=(),
                action_dtype=torch.int32, device=None) -> ReplayState:
    """An empty buffer of ``capacity`` transitions on ``device`` (``None``
    is ``cuda``)."""
    device = resolve_device(device)
    obs = (capacity,) + tuple(obs_shape)
    data = Transition(
        obs=torch.zeros(obs, device=device),
        action=torch.zeros((capacity,) + tuple(action_shape),
                           dtype=action_dtype, device=device),
        reward=torch.zeros(capacity, device=device),
        done=torch.zeros(capacity, device=device),
        next_obs=torch.zeros(obs, device=device))
    zero = torch.zeros((), dtype=torch.int32, device=device)
    return ReplayState(data, zero, zero.clone())


def _slots(index: torch.Tensor, n: int, capacity: int) -> torch.Tensor:
    """The ``n`` slots after each cursor, ``(..., n)`` int64."""
    return ((index[..., None] + torch.arange(n, device=index.device))
            % capacity).to(torch.int64)


def _shard_rows(idx: torch.Tensor):
    """Index tuple that pairs each row of ``idx`` with its shard."""
    if idx.dim() == 1:
        return (idx,)
    return (torch.arange(idx.shape[0], device=idx.device)[:, None], idx)


def replay_add_batch(state: ReplayState, batch: Transition) -> ReplayState:
    """Write a batch at the circular cursor: ``(N, ...)`` leaves into one
    buffer, or ``(n_shards, N, ...)`` into each shard at its own cursor."""
    lead = state.index.dim()
    capacity = state.data.reward.shape[lead]
    n = batch.reward.shape[lead]
    key = _shard_rows(_slots(state.index, n, capacity))
    data = Transition(*(buf.index_put(key, x.to(buf.dtype))
                        for buf, x in zip(state.data, batch)))
    return ReplayState(data, (state.index + n) % capacity,
                       torch.clamp(state.size + n, max=capacity))


def sample_indices(size: torch.Tensor, generator: torch.Generator,
                   shape) -> torch.Tensor:
    """Uniform int64 indices of ``shape`` in ``[0, max(size, 1))``: a
    float64 draw in [0, 1) scaled by the bound and floored, on
    ``generator``'s device (``size`` broadcasts against ``shape``)."""
    bound = torch.clamp(size, min=1).to(device=generator.device,
                                        dtype=torch.float64)
    u = torch.rand(shape, generator=generator, dtype=torch.float64,
                   device=generator.device)
    return torch.minimum((u * bound).to(torch.int64),
                         bound.to(torch.int64) - 1)


def replay_sample(state: ReplayState, generator: torch.Generator,
                  batch_size: int) -> Transition:
    """``batch_size`` transitions drawn uniformly, with replacement, from
    the written prefix ``[0, max(size, 1))``: an empty buffer yields slot
    0, which the learner's warmup discards.  The draws come from
    ``generator`` on its device."""
    idx = sample_indices(state.size, generator, batch_size)
    return Transition(*(buf[idx.to(buf.device)] for buf in state.data))


# ---------------------------------------------------------------------------
# Sharded layout (one shard per actor)
# ---------------------------------------------------------------------------

def _stack_copies(tree: Any, n: int) -> Any:
    return tree_map(lambda x: x.expand((n,) + tuple(x.shape)).clone(), tree)


def replay_init_sharded(n_shards: int, capacity: int, obs_shape,
                        action_shape=(), action_dtype=torch.int32,
                        device=None) -> ReplayState:
    """``n_shards`` independent empty buffers stacked on a leading axis."""
    return _stack_copies(replay_init(capacity, obs_shape, action_shape,
                                     action_dtype, device), n_shards)


# every shard writes at its own cursor: the same op as the single add
replay_add_sharded = replay_add_batch


def replay_sample_sharded(state: ReplayState, generator: torch.Generator,
                          per_shard: int) -> Transition:
    """``per_shard`` transitions from every shard's own written prefix,
    leaves ``(n_shards, per_shard, ...)``.  One draw of that shape serves
    all shards; with one shard it is ``replay_sample``'s draw."""
    n = state.size.shape[0]
    idx = sample_indices(state.size[:, None], generator, (n, per_shard))
    key = _shard_rows(idx.to(state.size.device))
    return Transition(*(buf[key] for buf in state.data))


def replay_total_size(state) -> torch.Tensor:
    """Valid entries over all shards (0-d, on the device) of a
    ``ReplayState`` or a ``PrioritizedReplayState``."""
    if isinstance(state, PrioritizedReplayState):
        state = state.replay
    return torch.sum(state.size)


def replay_stack(states: List[Any]) -> Any:
    """Stack independent buffers (uniform or prioritized) into the
    sharded layout."""
    return tree_map(lambda *xs: torch.stack(xs), *states)


def replay_unstack(state: Any) -> List[Any]:
    """Inverse of ``replay_stack``: split the shard axis back out."""
    size = state.replay.size if isinstance(
        state, PrioritizedReplayState) else state.size
    return [tree_map(lambda x, i=i: x[i], state)
            for i in range(size.shape[0])]


# ---------------------------------------------------------------------------
# Double buffer (async actor-learner: write slot / read slot)
# ---------------------------------------------------------------------------

class DoubleBuffer(NamedTuple):
    """Two independent buffers: the actors fill ``write``, the learner
    drains ``read``.

    The slots never share a tensor (two separate ``*_init`` calls), each
    holds half the total capacity, and ``double_buffer_swap`` exchanges
    them by reference: transitions written in one sync period become
    sampleable in the next.
    """

    read: Any
    write: Any


def double_buffer_init(init_fn, n_shards: int, capacity: int, *args,
                       **kwargs) -> DoubleBuffer:
    """Two independent slots of ``capacity`` a shard, each from
    ``init_fn`` (``replay_init_sharded`` / ``per_init_sharded``)."""
    return DoubleBuffer(read=init_fn(n_shards, capacity, *args, **kwargs),
                        write=init_fn(n_shards, capacity, *args, **kwargs))


def double_buffer_swap(db: DoubleBuffer) -> DoubleBuffer:
    """Exchange the slots' references: no device work, no copy."""
    return DoubleBuffer(read=db.write, write=db.read)


def double_buffer_total_size(db: DoubleBuffer) -> torch.Tensor:
    """Valid entries across both slots and all shards."""
    return replay_total_size(db.read) + replay_total_size(db.write)


# ---------------------------------------------------------------------------
# Prioritized replay (PER): sum-tree + importance-sampling weights
# ---------------------------------------------------------------------------

_PRIORITY_EPS = 1e-6       # |td| -> priority floor (no zero-mass slots)
_MASS_EPS = 1e-12          # guards 0/0 before the first write


class PrioritizedReplayState(NamedTuple):
    """A circular buffer and a sum-tree over its slots' priorities.

    ``tree`` is a binary heap of ``2 * tree_size`` floats (``tree_size``
    the next power of two at or above the capacity; after the shard axis
    when sharded): leaf ``i`` at ``tree_size + i``, node ``k`` holding
    ``tree[2k] + tree[2k + 1]``, the total mass at ``tree[1]``.  Leaves
    hold ``(|td| + eps) ** alpha``, unwritten slots 0.  New writes enter
    at ``max_priority``, the largest priority pushed so far (1 at first).
    """

    replay: ReplayState
    tree: torch.Tensor
    max_priority: torch.Tensor


def _tree_size(capacity: int) -> int:
    n = 1
    while n < capacity:
        n *= 2
    return n


def sum_tree_set(tree: torch.Tensor, leaf_idx: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """Set a batch of leaves and repair their ancestors, level by level:
    each touched parent becomes the sum of its two children, as in the
    reference.  Duplicate indices must carry equal values (PER's do: one
    transition, one TD error)."""
    size = tree.shape[-1] // 2
    node = leaf_idx.to(torch.int64) + size
    tree = tree.scatter(-1, node, values.to(tree.dtype))
    for _ in range(size.bit_length() - 1):
        node = node // 2
        sums = tree.gather(-1, 2 * node) + tree.gather(-1, 2 * node + 1)
        tree = tree.scatter(-1, node, sums)
    return tree


def sum_tree_total(tree: torch.Tensor) -> torch.Tensor:
    """Total priority mass (the root; one a shard)."""
    return tree[..., 1]


def sum_tree_leaves(tree: torch.Tensor) -> torch.Tensor:
    """The per-slot priority leaves (``tree_size >= capacity`` of them)."""
    return tree[..., tree.shape[-1] // 2:]


def sum_tree_find(tree: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Leaf whose cumulative span holds each mass of ``u`` (in ``[0,
    root)``), by descent from the root: go left where ``u`` is below the
    left child's mass, else subtract it and go right.  int64 indices."""
    size = tree.shape[-1] // 2
    node = torch.ones(u.shape, dtype=torch.int64, device=tree.device)
    for _ in range(size.bit_length() - 1):
        left = tree.gather(-1, 2 * node)
        go_left = u < left
        node = torch.where(go_left, 2 * node, 2 * node + 1)
        u = torch.where(go_left, u, u - left)
    return node - size


def per_init(capacity: int, obs_shape, action_shape=(),
             action_dtype=torch.int32, device=None) -> PrioritizedReplayState:
    """An empty prioritized buffer: all-zero tree, ``max_priority = 1``."""
    replay = replay_init(capacity, obs_shape, action_shape, action_dtype,
                         device)
    dev = replay.size.device
    return PrioritizedReplayState(
        replay, torch.zeros(2 * _tree_size(capacity), device=dev),
        torch.ones((), device=dev))


def per_init_sharded(n_shards: int, capacity: int, obs_shape,
                     action_shape=(), action_dtype=torch.int32,
                     device=None) -> PrioritizedReplayState:
    """``n_shards`` independent prioritized buffers, trees stacked too."""
    return _stack_copies(per_init(capacity, obs_shape, action_shape,
                                  action_dtype, device), n_shards)


def per_add(state: PrioritizedReplayState, batch: Transition
            ) -> PrioritizedReplayState:
    """Write a batch at the cursor (of each shard); new slots enter at
    ``max_priority``."""
    lead = state.replay.index.dim()
    capacity = state.replay.data.reward.shape[lead]
    idx = _slots(state.replay.index, batch.reward.shape[lead], capacity)
    tree = sum_tree_set(state.tree, idx,
                        state.max_priority[..., None].expand(idx.shape))
    return PrioritizedReplayState(replay_add_batch(state.replay, batch),
                                  tree, state.max_priority)


def is_weights(state: PrioritizedReplayState, idx: torch.Tensor, beta
               ) -> torch.Tensor:
    """Importance-sampling weights of the sampled slots ``idx``:
    ``(N * P(i)) ** -beta`` over the written count ``N``, normalised by
    the batch's (each shard's) largest, the Schaul et al. correction."""
    root = torch.clamp(sum_tree_total(state.tree), min=_MASS_EPS)
    prob = torch.clamp(sum_tree_leaves(state.tree).gather(-1, idx)
                       / root[..., None], min=_MASS_EPS)
    n_valid = torch.clamp(state.replay.size, min=1).to(torch.float32)
    weights = _powf(n_valid[..., None] * prob, -beta)
    return weights / torch.clamp(weights.amax(-1, keepdim=True),
                                 min=_MASS_EPS)


# The reference's ``x ** y`` on float32 is the C library's ``powf`` (XLA:CPU
# calls it): log2 from a 16-entry table and a degree-5 polynomial, exp2
# from a 32-entry table and a cubic, in float64, rounded once to float32
# (the algorithm of ARM's optimized-routines, which glibc ships).  It is
# not always the correctly rounded power, so ``_powf`` repeats it step by
# step, which keeps priorities and IS weights bitwise the reference's.
_LOG2_TAB = tuple((float.fromhex(a), float.fromhex(b)) for a, b in (
    ("0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2"),
    ("0x1.571ed4aaf883dp+0", "-0x1.b0b6832d4fca4p-2"),
    ("0x1.49539f0f010bp+0", "-0x1.7418b0a1fb77bp-2"),
    ("0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2"),
    ("0x1.30d190c8864a5p+0", "-0x1.01d9bf3f2b631p-2"),
    ("0x1.25e227b0b8eap+0", "-0x1.97c1d1b3b7afp-3"),
    ("0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3"),
    ("0x1.12358f08ae5bap+0", "-0x1.960cbbf788d5cp-4"),
    ("0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5"),
    ("0x1p+0", "0x0p+0"),
    ("0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4"),
    ("0x1.ca4b31f026aap-1", "0x1.476a9543891bap-3"),
    ("0x1.b2036576afce6p-1", "0x1.e840b4ac4e4d2p-3"),
    ("0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2"),
    ("0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2"),
    ("0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2")))
_LOG2_POLY = tuple(float.fromhex(a) for a in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp0"))
_EXP2_POLY = tuple(float.fromhex(a) for a in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1"))
_EXP2_SHIFT = float.fromhex("0x1.8p+52") / 32


def _exp2_tab() -> tuple:
    """``bits(2 ** (i / 32)) - (i << 52) / 32``, the doubles correctly
    rounded (exp in 40 digits, then Python's correctly rounded float)."""
    import struct
    from decimal import Decimal, localcontext
    out = []
    with localcontext() as ctx:
        ctx.prec = 40
        for i in range(32):
            v = float((Decimal(i) / 32 * Decimal(2).ln()).exp())
            out.append(struct.unpack("<q", struct.pack("<d", v))[0]
                       - (i << 52) // 32)
    return tuple(out)


_EXP2_TAB = _exp2_tab()


def _powf(x: torch.Tensor, y) -> torch.Tensor:
    """float32 ``x ** y`` as the reference computes it, for positive
    normal ``x`` and ``|y * log2(x)| < 126`` (priorities and IS weights
    stay far inside); ``y`` a float or a 0-d tensor, taken as float32."""
    dev = x.device
    y = (y.to(dev, torch.float32) if isinstance(y, torch.Tensor)
         else torch.full((), y, dtype=torch.float32, device=dev)
         ).to(torch.float64)
    ix = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    # x = 2^k z with z in [0x3f330000 as float, twice that)
    tmp = (ix - 0x3F330000) & 0xFFFFFFFF
    top = tmp & 0xFF800000
    k = torch.where(top >= 1 << 31, top - (1 << 32), top) >> 23
    z = ((ix - top) & 0xFFFFFFFF).to(torch.int32).view(torch.float32)
    # the tables go to the card without a host sync
    tab = torch.tensor(_LOG2_TAB, dtype=torch.float64).to(dev,
                                                         non_blocking=True)
    c = tab[(tmp >> 19) % 16]
    a = _LOG2_POLY
    r = z.to(torch.float64) * c[..., 0] - 1
    r2 = r * r
    q = a[4] * r + (c[..., 1] + k.to(torch.float64))
    q = (a[2] * r + a[3]) * r2 + q
    logx = (a[0] * r + a[1]) * (r2 * r2) + q
    # 2^(y log2 x) = 2^(j/32) 2^r, r in [-1/64, 1/64]
    ylogx = y * logx
    kd = ylogx + _EXP2_SHIFT
    ki = kd.view(torch.int64)
    r = ylogx - (kd - _EXP2_SHIFT)
    t = torch.tensor(_EXP2_TAB).to(dev, non_blocking=True)[ki % 32]
    s = (t + (ki << 47)).view(torch.float64)
    e = _EXP2_POLY
    out = ((e[0] * r + e[1]) * (r * r) + (e[2] * r + 1)) * s
    return torch.where(y == 0, 1.0, out).to(torch.float32)


def per_sample_at(state: PrioritizedReplayState, u: torch.Tensor, beta):
    """``(batch, idx, weights)`` for the masses ``u`` (``(..., B)`` in
    ``[0, root)``): the slots ``sum_tree_find`` picks, clipped to the
    written prefix (unwritten leaves carry no mass; the clip absorbs
    float edge cases), their transitions and their IS weights."""
    size = state.replay.size
    idx = torch.minimum(
        torch.clamp(sum_tree_find(state.tree, u), min=0),
        torch.clamp(size, min=1).to(torch.int64)[..., None] - 1)
    key = _shard_rows(idx)
    batch = Transition(*(buf[key] for buf in state.replay.data))
    return batch, idx, is_weights(state, idx, beta)


def per_sample(state: PrioritizedReplayState, generator: torch.Generator,
               batch_size: int, beta):
    """Priority-proportional sample with replacement, ``batch_size`` a
    shard: float32 uniforms from ``generator`` scaled by each root, then
    ``per_sample_at``.  ``beta`` may be a 0-d tensor (annealed by the
    caller)."""
    tree = state.tree
    root = torch.clamp(sum_tree_total(tree), min=_MASS_EPS)
    u = torch.rand(tuple(root.shape) + (batch_size,), generator=generator,
                   device=generator.device).to(tree.device)
    return per_sample_at(state, u * root[..., None], beta)


def per_update_priorities(state: PrioritizedReplayState, idx: torch.Tensor,
                          td_abs: torch.Tensor, priority_exponent: float
                          ) -> PrioritizedReplayState:
    """Push the learner's TD errors back as priorities ``(|td| + eps) **
    alpha`` (of each shard's own slots when sharded)."""
    p = _powf(torch.abs(td_abs) + _PRIORITY_EPS, priority_exponent)
    tree = sum_tree_set(state.tree, idx, p)
    max_p = torch.maximum(state.max_priority, p.amax(-1))
    return PrioritizedReplayState(state.replay, tree, max_p)


# every PER op takes the shard axis as it comes (the reference vmaps)
per_add_sharded = per_add
per_sample_sharded = per_sample
per_update_priorities_sharded = per_update_priorities
per_stack = replay_stack
per_unstack = replay_unstack


# ---------------------------------------------------------------------------
# Snapshots (checkpointing a replay on its own)
# ---------------------------------------------------------------------------

def export_state(state: Any) -> Any:
    """A host snapshot of any replay tree -- ``ReplayState``,
    ``PrioritizedReplayState``, their sharded layouts, ``DoubleBuffer``:
    the same tree of forced CPU copies, safe to hand to a background
    writer while the live buffers go on changing.  ``import_state``
    inverts it."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True), state)


def import_state(template: Any, exported: Any) -> Any:
    """An ``export_state`` snapshot back in ``template``'s layout, on its
    device.

    The structure and every leaf's shape and dtype are held against
    ``template`` first (``ValueError`` with each differing leaf's path: a
    snapshot of another capacity or shard count, say)."""
    t_paths, _ = tree_flatten(template)
    e_paths, leaves = tree_flatten(exported)
    if t_paths != e_paths or type(template) is not type(exported):
        raise ValueError(
            f"replay snapshot structure ({type(exported).__name__}, "
            f"{len(e_paths)} leaves) does not match the template's "
            f"({type(template).__name__}, {len(t_paths)} leaves)")
    ckpt_lib.validate_leaves([ckpt_lib.leaf_spec(x) for x in leaves],
                             template, source="replay snapshot")
    return ckpt_lib.restore_leaves(leaves, template)
