"""Analytic FLOP and HBM-traffic model of one step, per (arch x input
shape).

Counterpart of ``repro/launch/analytic.py``, the same arithmetic over
``repro_torch.configs.base``: the reference's roofline terms for its pod
dry-run (the port's is ``launch/dryrun.py``, which counts a traced
step's work instead).

Conventions:
* FLOPs are global (whole step, all devices).
* Training matmul FLOPs = 3x forward (fwd + 2x bwd) + 1x forward for the
  per-unit rematerialization => 4x forward on in-scan compute, 3x on the
  embedding/head (not rematerialized).
* HBM bytes are per-device per-step, the sum of parameter traffic
  (stream weights once per pass: fwd, bwd, remat), gradient/optimizer
  traffic, activation traffic, and (decode) KV-cache reads.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import base as cfgs


def _unit_counts(cfg: cfgs.ArchConfig) -> Dict[str, float]:
    kinds = list(cfg.pattern) * cfg.pattern_repeats \
        + list(cfg.pattern_remainder)
    out: Dict[str, float] = {}
    for k in kinds:
        out[k] = out.get(k, 0) + 1
    return out


def forward_flops(cfg: cfgs.ArchConfig, shape: cfgs.InputShape,
                  decode: bool = False) -> float:
    """Forward-pass FLOPs for one step (global)."""
    b = shape.global_batch
    s = 1 if decode else shape.seq_len
    ctx = shape.seq_len if decode else shape.seq_len
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    hd, nh, nkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    tokens = b * s

    def matmul(m, k, n):
        return 2.0 * m * k * n

    total = matmul(tokens, d, v)  # lm head
    counts = _unit_counts(cfg)
    for kind, n_blocks in counts.items():
        # attention projections
        attn_proj = (matmul(tokens, d, nh * hd)
                     + 2 * matmul(tokens, d, nkv * hd)
                     + matmul(tokens, nh * hd, d))
        local = kind in (cfgs.ATTN_LOCAL, cfgs.MOE_LOCAL)
        window = (cfg.window if local else cfg.long_context_window) or ctx
        if decode:
            ctx_eff = min(ctx, window)
            attn_core = 2 * matmul(b * nh, hd, ctx_eff)
        else:
            ctx_eff = min(ctx, window)
            # causal: each query sees ~min(pos, window) keys; average ~W/2
            # for S >> W, S/2 otherwise.
            avg_keys = ctx_eff / 2 if window >= s else \
                (window if window < s else s / 2)
            attn_core = 2 * 2.0 * tokens * nh * hd * avg_keys

        ffn = 0.0
        moe_overhead = 0.0
        if kind in (cfgs.ATTN, cfgs.ATTN_LOCAL):
            ffn = 3 * matmul(tokens, d, f)
            blk = attn_proj + attn_core + ffn
        elif kind in (cfgs.MOE, cfgs.MOE_LOCAL):
            ffn = cfg.moe_top_k * 3 * matmul(tokens, d, f) \
                * cfg.capacity_factor
            # dispatch/combine einsums: tokens x (E*C) x d, twice
            group = min(512, tokens)
            cap = max(int(cfg.capacity_factor * cfg.moe_top_k * group
                          / cfg.n_experts), cfg.moe_top_k)
            moe_overhead = 2 * 2.0 * tokens * cfg.n_experts * cap * d
            blk = attn_proj + attn_core + ffn + moe_overhead
        elif kind == cfgs.CROSS:
            enc = cfg.encoder_seq
            cross_core = 2 * matmul(tokens * nh, hd, enc)
            cross_proj = (matmul(tokens, d, nh * hd)
                          + 2 * matmul(b * enc, d, nkv * hd)
                          + matmul(tokens, nh * hd, d))
            ffn = 3 * matmul(tokens, d, f)
            blk = attn_proj + attn_core + cross_proj + cross_core + ffn
        elif kind == cfgs.RGLRU:
            # wx, wg, gates, wo ~ 5 d^2 matmuls + elementwise scan
            blk = 5 * matmul(tokens, d, d) + 10.0 * tokens * d \
                + 3 * matmul(tokens, d, f)
        elif kind in (cfgs.MLSTM, cfgs.SLSTM):
            di = nh * hd
            proj = 5 * matmul(tokens, d, di)
            core = (2.0 * tokens * nh * hd * hd * 3 if kind == cfgs.MLSTM
                    else 8.0 * tokens * di)
            blk = proj + core
        else:
            blk = 0.0
        total += n_blocks * blk

    if cfg.encoder_layers:
        enc_tokens = b * cfg.encoder_seq
        total += cfg.encoder_layers * (
            4 * matmul(enc_tokens, d, nh * hd) + 3 * matmul(enc_tokens, d, f)
            + 2 * 2.0 * enc_tokens * nh * hd * cfg.encoder_seq / 2)
    return total


def step_flops(cfg: cfgs.ArchConfig, shape: cfgs.InputShape) -> float:
    """Total FLOPs for the lowered step (train: fwd+bwd+remat)."""
    if shape.kind == "train":
        return 4.0 * forward_flops(cfg, shape)  # 1 fwd + 2 bwd + 1 remat
    if shape.kind == "prefill":
        return forward_flops(cfg, shape)
    return forward_flops(cfg, shape, decode=True)


def model_flops(cfg: cfgs.ArchConfig, shape: cfgs.InputShape) -> float:
    """The 6·N·D (train) / 2·N·D (inference) convention (active params)."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch


def hbm_bytes_per_device(cfg: cfgs.ArchConfig, shape: cfgs.InputShape,
                         devices: int = 256, *,
                         eightbit_opt: bool = False) -> float:
    """Approximate per-device HBM traffic for one step."""
    n = cfg.n_params()
    n_active = cfg.n_active_params()
    d = cfg.d_model
    depth = cfg.n_layers
    if shape.kind == "train":
        # weights bf16 streamed fwd + bwd + remat; grads f32 written+read;
        # master f32 read+write; opt moments read+write.
        w = n / devices
        opt_bytes = (2 * 2 * w) if eightbit_opt else (2 * 8 * w)
        param_traffic = 3 * 2 * w + 2 * 4 * w + 2 * 4 * w + opt_bytes
        tokens_dev = shape.tokens / min(devices, 256)
        act_traffic = tokens_dev * d * 2 * depth * 8  # ~8 tensors/block rw
        return param_traffic + act_traffic
    if shape.kind == "prefill":
        w = 2 * n_active / devices
        tokens_dev = shape.tokens / devices
        return w + tokens_dev * d * 2 * depth * 4
    # decode: weights once per step + cache read
    w = 2 * n_active / devices
    cache_bytes = 1 if cfg.quant.int8_kv_cache else 2
    window = cfg.long_context_window or cfg.window
    kinds = _unit_counts(cfg)
    cache = 0.0
    for kind, cnt in kinds.items():
        if kind in (cfgs.ATTN, cfgs.MOE, cfgs.CROSS):
            ctx = min(shape.seq_len, cfg.long_context_window or
                      shape.seq_len)
        elif kind in (cfgs.ATTN_LOCAL, cfgs.MOE_LOCAL):
            ctx = min(shape.seq_len, window or shape.seq_len)
        else:
            ctx = 0
        cache += cnt * shape.global_batch * ctx * cfg.n_kv_heads \
            * cfg.hd * 2 * cache_bytes
    return w + cache / devices
