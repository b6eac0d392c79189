"""Decoder blocks: one spec/apply pair per block kind of the layer pattern.

Counterpart of ``repro/models/blocks.py`` for the attention kinds
(``attn`` and ``attn_local``).  Every block is pre-norm residual;
``apply_block`` returns ``(x, new_cache)`` where ``new_cache`` is the
block's decode state (``{"kv": KVCache}``, None when not decoding); the
reference's third output, the MoE load-balance loss, comes with MoE.  The
MoE, cross-attention, RG-LRU and xLSTM kinds raise
``NotImplementedError`` until they are ported (ROADMAP queue A, item 13).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs import base as cfgs
from repro_torch.models import attention, common
from repro_torch.models.common import dense_spec

_PORTED = (cfgs.ATTN, cfgs.ATTN_LOCAL)


def _not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"block kind {kind!r} is not ported yet: the port runs "
        f"{list(_PORTED)} (ROADMAP queue A, item 13)")


def mlp_spec(d_model: int, d_ff: int) -> Dict[str, Any]:
    """SwiGLU / GeGLU weights: ``wi``, ``wg`` and ``wo``."""
    return {"wi": dense_spec(d_model, d_ff), "wg": dense_spec(d_model, d_ff),
            "wo": dense_spec(d_ff, d_model)}


def mlp(ctx, params, x: torch.Tensor, activation: str = "silu",
        name: str = "mlp") -> torch.Tensor:
    """``wo(wi(x) * act(wg(x)))``; ``gelu`` is the tanh approximation, as
    ``jax.nn.gelu``'s default."""
    h = common.dense(ctx, f"{name}/wi", params["wi"], x, quant_act=False)
    g = common.dense(ctx, f"{name}/wg", params["wg"], x, quant_act=False)
    act = F.silu(g) if activation == "silu" else F.gelu(g, approximate="tanh")
    h = ctx.activation(f"{name}/h", h * act)
    return common.dense(ctx, f"{name}/wo", params["wo"], h)


def _norm_spec(cfg: cfgs.ArchConfig):
    return (common.rms_norm_spec(cfg.d_model) if cfg.norm == "rms"
            else common.layer_norm_spec(cfg.d_model))


def _norm(cfg: cfgs.ArchConfig, params, x: torch.Tensor) -> torch.Tensor:
    return (common.rms_norm(params, x) if cfg.norm == "rms"
            else common.layer_norm(params, x))


def block_spec(kind: str, cfg: cfgs.ArchConfig) -> Dict[str, Any]:
    """Parameter spec of one block of ``kind``."""
    if kind not in _PORTED:
        raise _not_ported(kind)
    return {"norm1": _norm_spec(cfg),
            "attn": attention.attention_spec(cfg.d_model, cfg.n_heads,
                                             cfg.n_kv_heads, cfg.hd),
            "norm2": _norm_spec(cfg),
            "mlp": mlp_spec(cfg.d_model, cfg.d_ff)}


def init_block_cache(kind: str, cfg: cfgs.ArchConfig, batch: int,
                     seq_len: int, *, int8: bool,
                     device=None) -> Dict[str, attention.KVCache]:
    """Decode state of one block: a KV cache of ``seq_len`` slots (global
    layers; ``long_context_window`` caps them) or ``min(seq_len,
    window)`` slots (local layers, a ring)."""
    if kind == cfgs.ATTN:
        w = cfg.long_context_window
        size = min(seq_len, w) if w else seq_len
    elif kind == cfgs.ATTN_LOCAL:
        window = cfg.long_context_window or cfg.window
        size = min(seq_len, window or seq_len)
    else:
        raise _not_ported(kind)
    return {"kv": attention.init_cache(batch, size, cfg.n_kv_heads, cfg.hd,
                                       int8=int8, device=device)}


def apply_block(kind: str, cfg: cfgs.ArchConfig, ctx, params,
                x: torch.Tensor, *, cache: Optional[Dict] = None, pos=None,
                name: str = "blk") -> Tuple[torch.Tensor, Any]:
    """One pre-norm residual block: attention, then the MLP."""
    if kind not in _PORTED:
        raise _not_ported(kind)
    window = cfg.window if kind == cfgs.ATTN_LOCAL \
        else cfg.long_context_window
    h = _norm(cfg, params["norm1"], x)
    h, kv_cache = attention.attention_layer(
        ctx, params["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.hd, window=window, softcap=cfg.softcap,
        rope_theta=cfg.rope_theta,
        cache=None if cache is None else cache["kv"], pos=pos,
        name=f"{name}/attn")
    x = x + h
    h = _norm(cfg, params["norm2"], x)
    x = x + mlp(ctx, params["mlp"], h, cfg.activation, name=f"{name}/mlp")
    return x, (None if cache is None else {"kv": kv_cache})
