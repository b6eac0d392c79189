"""Uniform replay: a fixed-size circular buffer of transitions on the
device.

Counterpart of ``repro/rl/buffer.py:50-131``.  ``replay_add_batch`` writes
a batch at the cursor (out of place: the old state stays as it was, as
in the reference); ``replay_sample`` draws with replacement from the
written prefix ``[0, max(size, 1))``, the reference's contract, with the
bound read on the device, so sampling never waits on the host.  The
prioritized sum-tree, the sharded layout and the double buffer come with
the actor-learner topologies (ROADMAP queue A, item 7):
``replay="prioritized"`` raises until then.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

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
    is exactly uniform, so it takes the uniform path, as in the
    reference; the sum-tree itself is not ported yet and raises."""
    validate_replay(replay)
    if replay != "prioritized":
        return False
    if priority_exponent < 0.0:
        raise ValueError(f"priority_exponent must be >= 0, "
                         f"got {priority_exponent}")
    if priority_exponent != 0.0:
        raise NotImplementedError(
            "prioritized replay is not ported yet (ROADMAP queue A, "
            "item 7)")
    return False


class Transition(NamedTuple):
    """A batch of transitions (or the whole buffer: leading dim =
    capacity)."""

    obs: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    next_obs: torch.Tensor


class ReplayState(NamedTuple):
    """The buffer, the next write slot and the count of valid entries
    (0-d int32 tensors)."""

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


def replay_add_batch(state: ReplayState, batch: Transition) -> ReplayState:
    """Write a batch ``(N, ...)`` at the circular cursor."""
    capacity = state.data.reward.shape[0]
    n = batch.reward.shape[0]
    idx = ((state.index + torch.arange(n, device=state.index.device))
           % capacity).to(torch.int64)
    data = Transition(*(buf.index_put((idx,), x.to(buf.dtype))
                        for buf, x in zip(state.data, batch)))
    return ReplayState(data, (state.index + n) % capacity,
                       torch.clamp(state.size + n, max=capacity))


def replay_sample(state: ReplayState, generator: torch.Generator,
                  batch_size: int) -> Transition:
    """``batch_size`` transitions drawn uniformly, with replacement, from
    the written prefix ``[0, max(size, 1))``: an empty buffer yields slot
    0, which the learner's warmup discards.  The draws come from
    ``generator`` on its device."""
    idx = sample_indices(state.size, generator, batch_size)
    return Transition(*(buf[idx.to(buf.device)] for buf in state.data))


def sample_indices(size: torch.Tensor, generator: torch.Generator,
                   batch_size: int) -> torch.Tensor:
    """Uniform int64 indices in ``[0, max(size, 1))``: a float64 draw in
    [0, 1) scaled by the bound and floored, on ``generator``'s device."""
    bound = torch.clamp(size, min=1).to(device=generator.device,
                                        dtype=torch.float64)
    u = torch.rand(batch_size, generator=generator, dtype=torch.float64,
                   device=generator.device)
    return torch.minimum((u * bound).to(torch.int64),
                         bound.to(torch.int64) - 1)
