"""Attention layers of the LM: GQA with RoPE, sliding windows, logit
soft-capping, cross-attention, and decode KV caches (fp or
int8-quantized).

Counterpart of ``repro/models/attention.py``.

* Prefill and forward (no cache): self-attention at every sequence
  length goes through ``ops.FlashAttentionDenseGrad``: forward kernel B4
  on the card (q, k and v in float32, the output back in the compute
  dtype), backward the gradient of ``dense_attention`` in torch ops, as
  the reference's training path differentiates it.  That covers both
  branches the reference splits between ``dense_attention`` (S <= 2048)
  and ``chunked_attention``; the latter's mesh constraints and remat have
  no counterpart.  GQA is an index in the kernel's grid: K and V are
  never repeated.  The encoder's self-attention is the same call,
  non-causal.
* Cross-attention (``kv_source``: whisper's encoder output,
  llama-vision's patch embeddings): K and V projected from the source
  at every call, decode steps included, no RoPE, non-causal, through the
  same B4 call at S != T, where the reference calls ``dense_attention``
  (the same function).  It keeps no cache.
* Decode (one token, a cache): an int8 cache without soft-cap decodes
  straight off the codes through ``ops.int8_cache_attention`` (kernel B3
  on the card); an fp cache, or a soft-capped config, runs
  ``dense_attention`` in plain torch, as the reference computes it
  outside any Pallas kernel.

Decode caches for sliding-window layers are rings of ``window`` slots.
Where the reference's arrays are immutable, ``cache_update`` writes the
new token into the cache's tensors in place (a decode step then moves
one token, not the whole cache) and returns the same tensors.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import affine
from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.models.common import P, dense_spec

NEG_INF = -1e30


def attention_spec(d_model: int, n_heads: int, n_kv: int,
                   head_dim: int) -> Dict[str, Dict[str, P]]:
    """Spec of one GQA attention layer's q/k/v/o projections."""
    return {"q": dense_spec(d_model, n_heads * head_dim, "embed", "heads"),
            "k": dense_spec(d_model, n_kv * head_dim, "embed", "kv"),
            "v": dense_spec(d_model, n_kv * head_dim, "embed", "kv"),
            "o": dense_spec(n_heads * head_dim, d_model, "heads", "embed")}


# ---------------------------------------------------------------------------
# dense softmax attention over grouped heads (decode)
# ---------------------------------------------------------------------------

def _logits(q: torch.Tensor, k: torch.Tensor, scale: float,
            softcap: Optional[float]) -> torch.Tensor:
    # q: (B, Sq, KV, G, Dh)  k: (B, Skv, KV, Dh) -> (B, KV, G, Sq, Skv)
    s = torch.einsum("bqkgd,bskd->bkgqs", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    return s


def _mask(sq: int, q_offset, kv_positions: torch.Tensor,
          window: Optional[int]) -> torch.Tensor:
    """(sq, skv) causal boolean mask over the slots' absolute positions;
    query i sits at ``q_offset + i``."""
    q_pos = q_offset + torch.arange(sq, device=kv_positions.device)[:, None]
    k_pos = kv_positions[None, :]
    mask = (k_pos <= q_pos) & (k_pos >= 0)      # slots not yet written: -1
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    return mask


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: Optional[int], softcap: Optional[float],
                    q_offset: torch.Tensor,
                    kv_positions: torch.Tensor) -> torch.Tensor:
    """Materialized-scores causal attention over a cache (decode):
    ``q (B, Sq, KV, G, Dh)``, ``k/v (B, Skv, KV, Dh)`` -> ``(B, Sq, KV, G,
    Dh)``, slot t at absolute position ``kv_positions[t]``.  Masked logits
    are ``-1e30``, as in the reference."""
    # on DTensors the query's KV heads are gathered (one token: a few
    # bytes), so the score einsums fold batch and heads with only the
    # batch split, which DTensor's views take in every version; the
    # cache keeps its context split and the scores follow it
    q = common.unsplit(q, 2)
    s = _logits(q, k, q.shape[-1] ** -0.5, softcap)
    mask = _mask(q.shape[1], q_offset, kv_positions, window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(torch.float32))
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# KV cache (fp / int8 ring)
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    """Decode cache of one attention layer (a ring of ``size`` slots).

    Slot i holds the most recent position p with ``p % size == i``;
    ``positions`` holds each slot's absolute position (-1: never written)
    and doubles as the validity mask.  A stacked cache carries a leading
    ``layers`` axis on every tensor.
    """

    k: torch.Tensor                    # (B, T, KV, Dh) fp, or int8 codes
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]    # (B, T, KV, 1) per-token scales
    v_scale: Optional[torch.Tensor]
    positions: torch.Tensor            # (T,) int32

    @property
    def size(self) -> int:
        """Number of slots (the ring length T)."""
        return self.k.shape[-3]


def init_cache(batch: int, size: int, n_kv: int, head_dim: int, *,
               int8: bool, device=None,
               dtype: torch.dtype = torch.float32) -> KVCache:
    """An all-zero cache of ``size`` slots (int8 codes + scales, or
    ``dtype``: float32 by default, as the reference's serve launcher asks
    and the port's LM path runs; the dry-run's shapes take the
    reference's default bfloat16)."""
    shape = (batch, size, n_kv, head_dim)
    if int8:
        k = torch.zeros(shape, dtype=torch.int8, device=device)
        v = torch.zeros(shape, dtype=torch.int8, device=device)
        ks = torch.zeros(shape[:-1] + (1,), device=device)
        vs = torch.zeros(shape[:-1] + (1,), device=device)
    else:
        k = torch.zeros(shape, dtype=dtype, device=device)
        v = torch.zeros(shape, dtype=dtype, device=device)
        ks = vs = None
    return KVCache(k, v, ks, vs, torch.full((size,), -1, dtype=torch.int32,
                                            device=device))


def cache_update(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                 pos) -> KVCache:
    """Write one token ``(B, 1, KV, Dh)`` at absolute position ``pos``, in
    place; returns ``cache``.

    int8 caches quantize the token with the shared symmetric per-token
    quantizer ``core.affine.quantize_symmetric``.
    """
    pos = torch.as_tensor(pos, dtype=torch.int64,
                          device=cache.k.device).reshape(1)
    slot = pos % cache.size
    if cache.k_scale is not None:
        k_codes, k_scale = affine.quantize_symmetric(k_new)
        v_codes, v_scale = affine.quantize_symmetric(v_new)
        _write_slot(cache.k, 1, slot, k_codes)
        _write_slot(cache.v, 1, slot, v_codes)
        _write_slot(cache.k_scale, 1, slot, k_scale)
        _write_slot(cache.v_scale, 1, slot, v_scale)
    else:
        _write_slot(cache.k, 1, slot, k_new)
        _write_slot(cache.v, 1, slot, v_new)
    _write_slot(cache.positions, 0, slot, pos.to(torch.int32))
    return cache


def _write_slot(t: torch.Tensor, dim: int, slot: torch.Tensor,
                new: torch.Tensor) -> None:
    """``t.index_copy_(dim, slot, new)``.  On a DTensor (whose slots may
    be split) each rank writes into its own shard, where the slot lies in
    it (no host sync: a rank it misses rewrites a slot of its own with
    what it holds), ``new`` first taken to ``t``'s layout with its one
    slot whole."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(t, DTensor):
        t.index_copy_(dim, slot, new)
        return
    mesh = t.device_mesh
    rep = [Replicate()] * mesh.ndim
    if not isinstance(new, DTensor):
        new = DTensor.from_local(new, mesh, rep, run_check=False)
    pl = [Replicate() if p == Shard(dim) else p for p in t.placements]
    new = new.redistribute(mesh, pl).to_local().to(t.dtype)
    local = t.to_local()
    if isinstance(slot, DTensor):
        slot = slot.to_local()
    start, size = 0, t.shape[dim]
    for i, p in enumerate(t.placements):       # mesh dims in order
        if p == Shard(dim):
            size = -(-size // mesh.size(i))
            start += mesh.get_local_rank(i) * size
    at = slot - start
    mine = (at >= 0) & (at < local.shape[dim])
    at = at.clamp(0, local.shape[dim] - 1)
    local.index_copy_(dim, at, torch.where(mine, new,
                                           local.index_select(dim, at)))


def cache_kv(cache: KVCache) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cache's K and V in float32 (int8 codes dequantized)."""
    if cache.k_scale is not None:
        return (cache.k.to(torch.float32) * cache.k_scale,
                cache.v.to(torch.float32) * cache.v_scale)
    return cache.k, cache.v


# ---------------------------------------------------------------------------
# the full layer: projections, rope, attention (and the cache)
# ---------------------------------------------------------------------------

def attention_layer(ctx, params, x: torch.Tensor, *, n_heads: int,
                    n_kv: int, head_dim: int, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    rope_theta: Optional[float] = 10000.0,
                    cache: Optional[KVCache] = None, pos=None,
                    kv_source: Optional[torch.Tensor] = None,
                    name: str = "attn"
                    ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """GQA attention over ``x (B, S, D)``, in the reference's branches.

    Prefill / forward: ``cache`` is None, every S through
    ``ops.FlashAttentionDenseGrad`` (B4, differentiable), causal or not.
    Decode: S == 1, ``cache`` given, ``pos`` the absolute position (an
    int or a 0-d tensor).  Cross-attention: ``kv_source (B, T, D)``
    gives K and V, non-causal, no RoPE.  RoPE (``rope_theta`` not None)
    rotates self-attention's q and k.
    """
    b, s, _ = x.shape
    g = n_heads // n_kv
    kv_in = x if kv_source is None else kv_source
    t = kv_in.shape[1]
    q = common.dense(ctx, f"{name}/q", params["q"], x, quant_act=False)
    k = common.dense(ctx, f"{name}/k", params["k"], kv_in, quant_act=False)
    v = common.dense(ctx, f"{name}/v", params["v"], kv_in, quant_act=False)
    q = ctx.activation(f"{name}/q_out", q)
    k = ctx.activation(f"{name}/k_out", k)
    v = ctx.activation(f"{name}/v_out", v)

    q = common.reshape(q, b, s, n_heads, head_dim)
    k = common.reshape(k, b, t, n_kv, head_dim)
    v = common.reshape(v, b, t, n_kv, head_dim)
    if rope_theta is not None and kv_source is None:
        if pos is None:
            positions = torch.arange(s, device=x.device)[None, :]
        else:
            pos = torch.as_tensor(pos, device=x.device)
            positions = pos + torch.zeros((b, s), dtype=torch.int32,
                                          device=x.device)
        q = common.apply_rope(q, positions, rope_theta)
        k = common.apply_rope(k, positions, rope_theta)

    new_cache = None
    if cache is not None:
        if s != 1:
            raise ValueError(f"a decode step takes one token, got {s}")
        new_cache = cache_update(cache, k, v, pos)
        if new_cache.k_scale is not None and softcap is None:
            # decode off the codes; a ring (size == window) holds only
            # in-window tokens, so the op's slot masking needs no window
            # term, while a plain cache (slot i == position i) passes it
            win = None if (window is not None and cache.size == window) \
                else window
            qh = common.reshape(q, b, n_kv, g, head_dim)
            out = ops.int8_cache_attention(
                qh, new_cache.k.transpose(1, 2),
                new_cache.k_scale.transpose(1, 2),
                new_cache.v.transpose(1, 2),
                new_cache.v_scale.transpose(1, 2), pos, window=win)
        else:
            k_all, v_all = cache_kv(new_cache)
            out = dense_attention(
                common.reshape(q, b, 1, n_kv, g, head_dim), k_all, v_all,
                window=window, softcap=softcap, q_offset=pos,
                kv_positions=new_cache.positions)
    elif kv_source is not None:
        out = ops.FlashAttentionDenseGrad.apply(q, k, v, False, None,
                                                softcap, head_dim ** -0.5)
    else:
        out = ops.FlashAttentionDenseGrad.apply(q, k, v, causal, window,
                                                softcap, head_dim ** -0.5)
    out = common.reshape(out, b, s, n_heads * head_dim)
    out = common.dense(ctx, f"{name}/o", params["o"], out)
    return out, new_cache
