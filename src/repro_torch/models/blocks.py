"""Decoder blocks: one spec/apply pair per block kind of the layer pattern.

Counterpart of ``repro/models/blocks.py``: ``attn``, ``attn_local``,
``moe``, ``moe_local``, ``cross`` (causal self-attention, then
cross-attention to the encoder output, then the MLP), ``rglru``,
``mlstm`` and ``slstm``.  Every block is pre-norm residual;
``apply_block`` returns ``(x, new_cache, aux)`` where ``new_cache`` is
the block's decode state (``{"kv": KVCache}`` for the attention kinds,
the recurrent state dict for the recurrent ones, None when not
decoding) and ``aux`` the MoE load-balance loss (a float32 scalar
tensor; the float 0.0 for the other kinds).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs import base as cfgs
from repro_torch.models import attention, common, recurrent
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import dense_spec

_ATTENTION = (cfgs.ATTN, cfgs.ATTN_LOCAL, cfgs.MOE, cfgs.MOE_LOCAL,
              cfgs.CROSS)


def mlp_spec(d_model: int, d_ff: int) -> Dict[str, Any]:
    """SwiGLU / GeGLU weights: ``wi``, ``wg`` and ``wo``."""
    return {"wi": dense_spec(d_model, d_ff, "embed", "mlp"),
            "wg": dense_spec(d_model, d_ff, "embed", "mlp"),
            "wo": dense_spec(d_ff, d_model, "mlp", "embed")}


def mlp(ctx, params, x: torch.Tensor, activation: str = "silu",
        name: str = "mlp") -> torch.Tensor:
    """``wo(wi(x) * act(wg(x)))``; ``gelu`` is the tanh approximation, as
    ``jax.nn.gelu``'s default."""
    h = common.dense(ctx, f"{name}/wi", params["wi"], x, quant_act=False)
    g = common.dense(ctx, f"{name}/wg", params["wg"], x, quant_act=False)
    act = F.silu(g) if activation == "silu" else F.gelu(g, approximate="tanh")
    h = ctx.activation(f"{name}/h", h * act)
    return common.dense(ctx, f"{name}/wo", params["wo"], h)


def norm_spec(cfg: cfgs.ArchConfig):
    """The spec of the config's norm (RMSNorm or LayerNorm)."""
    return (common.rms_norm_spec(cfg.d_model) if cfg.norm == "rms"
            else common.layer_norm_spec(cfg.d_model))


def norm(cfg: cfgs.ArchConfig, params, x: torch.Tensor) -> torch.Tensor:
    """The config's norm (RMSNorm or LayerNorm) of ``x``."""
    return (common.rms_norm(params, x) if cfg.norm == "rms"
            else common.layer_norm(params, x))


def block_spec(kind: str, cfg: cfgs.ArchConfig) -> Dict[str, Any]:
    """Parameter spec of one block of ``kind``."""
    d = cfg.d_model
    spec: Dict[str, Any] = {"norm1": norm_spec(cfg)}
    if kind in _ATTENTION:
        spec["attn"] = attention.attention_spec(d, cfg.n_heads,
                                                cfg.n_kv_heads, cfg.hd)
        spec["norm2"] = norm_spec(cfg)
        if kind == cfgs.CROSS:
            spec["cross"] = attention.attention_spec(d, cfg.n_heads,
                                                     cfg.n_kv_heads, cfg.hd)
            spec["norm_cross"] = norm_spec(cfg)
        if kind in (cfgs.MOE, cfgs.MOE_LOCAL):
            spec["moe"] = moe_lib.moe_spec(d, cfg.d_ff, cfg.n_experts)
        else:
            spec["mlp"] = mlp_spec(d, cfg.d_ff)
    elif kind == cfgs.RGLRU:
        spec["rglru"] = recurrent.rglru_spec(d)
        spec["norm2"] = norm_spec(cfg)
        spec["mlp"] = mlp_spec(d, cfg.d_ff)
    elif kind == cfgs.MLSTM:
        spec["mlstm"] = recurrent.mlstm_spec(d, cfg.n_heads, cfg.hd)
    elif kind == cfgs.SLSTM:
        spec["slstm"] = recurrent.slstm_spec(d, cfg.n_heads, cfg.hd)
    else:
        raise ValueError(kind)
    return spec


def init_block_cache(kind: str, cfg: cfgs.ArchConfig, batch: int,
                     seq_len: int, *, int8: bool, device=None,
                     dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Decode state of one block, zeros.

    Attention kinds: ``{"kv": KVCache}`` of ``seq_len`` slots (global
    layers; ``long_context_window`` caps them) or ``min(seq_len,
    window)`` slots (local layers, a ring); int8 or ``dtype``.  Recurrent
    kinds: their float32 state, the RG-LRU's conv window in ``dtype`` as
    the reference's (``int8`` does not apply to them).
    """
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.hd

    def zeros(*shape):
        return torch.zeros(shape, device=device)
    if kind in (cfgs.ATTN, cfgs.MOE, cfgs.CROSS):
        w = cfg.long_context_window
        size = min(seq_len, w) if w else seq_len
    elif kind in (cfgs.ATTN_LOCAL, cfgs.MOE_LOCAL):
        window = cfg.long_context_window or cfg.window
        size = min(seq_len, window or seq_len)
    elif kind == cfgs.RGLRU:
        return {"h": zeros(batch, d),
                "conv": torch.zeros((batch, recurrent.CONV_WIDTH - 1, d),
                                    dtype=dtype, device=device)}
    elif kind == cfgs.MLSTM:
        return {"c": zeros(batch, h, hd, hd), "n": zeros(batch, h, hd),
                "m": zeros(batch, h)}
    elif kind == cfgs.SLSTM:
        return {"c": zeros(batch, h, hd), "n": zeros(batch, h),
                "m": zeros(batch, h)}
    else:
        raise ValueError(kind)
    return {"kv": attention.init_cache(batch, size, cfg.n_kv_heads, cfg.hd,
                                       int8=int8, device=device,
                                       dtype=dtype)}


def apply_block(kind: str, cfg: cfgs.ArchConfig, ctx, params,
                x: torch.Tensor, *, cache: Optional[Dict] = None, pos=None,
                encoder_out: Optional[torch.Tensor] = None,
                name: str = "blk") -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """One pre-norm residual block: attention (a ``cross`` block's then
    cross-attends to ``encoder_out``) then the MLP or the MoE (attention
    kinds), the RG-LRU then the MLP, or an xLSTM cell.  Returns ``(x,
    new_cache, aux)``."""
    aux = 0.0
    if kind in _ATTENTION:
        local = kind in (cfgs.ATTN_LOCAL, cfgs.MOE_LOCAL)
        window = cfg.window if local else cfg.long_context_window
        h = norm(cfg, params["norm1"], x)
        h, kv_cache = attention.attention_layer(
            ctx, params["attn"], h, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, head_dim=cfg.hd, window=window,
            softcap=cfg.softcap, rope_theta=cfg.rope_theta,
            cache=None if cache is None else cache["kv"], pos=pos,
            name=f"{name}/attn")
        x = x + h
        if kind == cfgs.CROSS:
            h = norm(cfg, params["norm_cross"], x)
            h, _ = attention.attention_layer(
                ctx, params["cross"], h, n_heads=cfg.n_heads,
                n_kv=cfg.n_kv_heads, head_dim=cfg.hd, causal=False,
                rope_theta=None, kv_source=encoder_out,
                name=f"{name}/cross")
            x = x + h
        h = norm(cfg, params["norm2"], x)
        if kind in (cfgs.MOE, cfgs.MOE_LOCAL):
            h, aux = moe_lib.moe_ffn(
                ctx, params["moe"], h, n_experts=cfg.n_experts,
                top_k=cfg.moe_top_k, capacity_factor=cfg.capacity_factor,
                activation=cfg.activation,
                quantize_router=cfg.quant.quantize_router,
                name=f"{name}/moe")
        else:
            h = mlp(ctx, params["mlp"], h, cfg.activation,
                    name=f"{name}/mlp")
        return x + h, (None if cache is None else {"kv": kv_cache}), aux
    if kind == cfgs.RGLRU:
        h = norm(cfg, params["norm1"], x)
        h, state = recurrent.rglru_block(ctx, params["rglru"], h,
                                         state=cache, name=f"{name}/rglru")
        x = x + h
        h = norm(cfg, params["norm2"], x)
        x = x + mlp(ctx, params["mlp"], h, cfg.activation,
                    name=f"{name}/mlp")
        return x, state, aux
    if kind in (cfgs.MLSTM, cfgs.SLSTM):
        block = recurrent.mlstm_block if kind == cfgs.MLSTM \
            else recurrent.slstm_block
        h = norm(cfg, params["norm1"], x)
        h, state = block(ctx, params[kind], h, n_heads=cfg.n_heads,
                         head_dim=cfg.hd, state=cache, name=f"{name}/{kind}")
        return x + h, state, aux
    raise ValueError(kind)
