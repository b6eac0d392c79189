"""The language model: embed -> stacked block pattern -> norm -> head.

Counterpart of ``repro/models/transformer.py``: ``param_specs``,
``init_params``, ``qat_site_names``, ``init_qat_collection``,
``forward``, ``loss_fn``, ``prefill``, ``init_caches`` and
``decode_step``, plus ``params_from_jax``.

``cfg.pattern`` is the repeating unit of block kinds; the parameters of
all repeats are stacked on a leading ``layers`` axis, as in the
reference, and the remainder (``n_layers % len(pattern)``) is kept apart.
Where the reference scans over the stacked axis, the port loops over it
and takes each layer's slice as a view.  The QAT observers of the blocks
(``unit/b{i}/...``) are one slot a site name shared by every repeat, and
are carried through the layers in order as the scan carries them, then
through the remainder.  With ``cfg.remat`` each repeat runs under
``torch.utils.checkpoint`` (activation checkpointing, the reference's
``jax.checkpoint``): the observer state is functional, passed in and
returned, so the backward's recompute discards what it computes and the
observers move once a step.  The recompute runs the whole unit (early
stop off), so every site and attention layer of it launches its kernel
a second time in a step.

Decode state is stacked the same way: an attention block's KV cache is
updated in place (``attention.cache_update``), and a recurrent block's
new state is copied back into its slice of the stacked tensors.

Attention goes through kernel B4 on the card, one launch per attention
layer (and one more per layer in a remat backward); decode through an
int8 cache through kernel B3.  The MoE blocks' load-balance loss is
summed over the layers.

The encoder (whisper) and vision (llama-3.2-vision) frontends are stubs,
as in the reference: ``encoder_out`` arrives as precomputed frame or
patch embeddings ``(B, T, d_model)``.  Whisper runs its transformer
encoder over them (``_run_encoder``: ``encoder_layers`` non-causal
blocks with RoPE, B4 once a layer, outside remat), and every ``cross``
block attends to the result; ``decode_step`` re-runs the encoder at
every step, as the reference does.  QAT of a config with an encoder
raises ``NotImplementedError`` (ROADMAP queue C): the reference's
encoder observers escape its ``lax.scan``, so the JAX package cannot
run it, and the port does not invent what it would compute.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Set, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch.configs import base as cfgs
from repro_torch.core import fake_quant
from repro_torch.device import resolve_device
from repro_torch.models import attention, blocks, common
from repro_torch.models.common import P

Params = Dict[str, Any]


def _unit_spec(cfg: cfgs.ArchConfig) -> Dict[str, Any]:
    return {f"b{i}_{kind}": blocks.block_spec(kind, cfg)
            for i, kind in enumerate(cfg.pattern)}


def param_specs(cfg: cfgs.ArchConfig) -> Dict[str, Any]:
    """The model's parameter spec tree (the reference's key layout)."""
    spec: Dict[str, Any] = {
        "embed": {"w": P((cfg.vocab, cfg.d_model), init="embed",
                         axes=("vocab", "embed"))},
        "final_norm": blocks.norm_spec(cfg),
        "layers": common.stack_specs(_unit_spec(cfg), cfg.pattern_repeats),
    }
    if cfg.pattern_remainder:
        spec["remainder"] = {
            f"r{i}_{kind}": blocks.block_spec(kind, cfg)
            for i, kind in enumerate(cfg.pattern_remainder)}
    if not cfg.tie_embeddings:
        spec["lm_head"] = {"w": P((cfg.d_model, cfg.vocab),
                                  axes=("embed", "vocab"))}
    if cfg.encoder_layers:
        spec["encoder"] = common.stack_specs(
            {"b0_attn": blocks.block_spec(cfgs.ATTN, cfg)},
            cfg.encoder_layers)
        spec["encoder_norm"] = blocks.norm_spec(cfg)
    return spec


def partition_specs(cfg: cfgs.ArchConfig, *, multi_pod: bool = False
                    ) -> Dict[str, Any]:
    """The param tree's per-dim mesh-dim entries under the config's
    policy, the reference's rules: an axis is sharded only where it
    divides its mesh dim (``model`` 16; the data dims 16, or 32 with
    ``multi_pod``, for fsdp's ``embed``)."""
    mesh_div = 32 if multi_pod else 16

    def divisible(axis: str) -> bool:
        model = 16
        if axis == "vocab":
            return cfg.vocab % model == 0
        if axis == "heads":
            return (cfg.n_heads * cfg.hd) % model == 0
        if axis == "kv":
            return (cfg.n_kv_heads * cfg.hd) % model == 0
        if axis in ("mlp", "moe_mlp"):
            return cfg.d_ff % model == 0 if cfg.d_ff else False
        if axis == "embed":
            return cfg.d_model % mesh_div == 0
        return True

    rules = common.sharding_rules(cfg.sharding, multi_pod=multi_pod,
                                  divisible=divisible)
    return common.partition_specs(param_specs(cfg), rules)


def init_params(cfg: cfgs.ArchConfig, generator: torch.Generator,
                device=None, dtype: torch.dtype = torch.float32) -> Params:
    """Seeded params (``common.init_params``: drawn in float32 in
    sorted-key order on the generator's device, cast to ``dtype``, then
    moved to ``device``, ``None`` being ``cuda``)."""
    return common.init_params(param_specs(cfg), generator, device, dtype)


def params_from_jax(tree: Any, device=None) -> Params:
    """The port's params from a JAX param tree.

    ``tree`` is the reference's nested dicts of arrays (numpy, or anything
    ``np.asarray`` takes), with the stacked leading ``layers`` axis; the
    result keeps the keys and shapes on ``device`` (``None`` is
    ``cuda``): a bfloat16 leaf bit for bit in bfloat16 (numpy holds it as
    ``ml_dtypes.bfloat16``, which torch does not take, so it crosses as
    its ``uint16`` bits), every other leaf in float32.
    """
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a).view(np.uint16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def _layer(tree: Any, li: int) -> Any:
    """Layer ``li``'s slice of a stacked tree (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, li) for k, v in tree.items()}
    if isinstance(tree, attention.KVCache):
        return attention.KVCache(*(None if t is None else t[li]
                                   for t in tree))
    return tree[li]


def _stack(trees: list) -> Any:
    """The per-layer trees stacked on a leading ``layers`` axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, attention.KVCache):
        return attention.KVCache(*(None if ts[0] is None else torch.stack(ts)
                                   for ts in zip(*trees)))
    return torch.stack(trees)


def _write_state(cache: Dict[str, Any], new: Dict[str, Any]) -> None:
    """Copy a block's new decode state into ``cache`` (views of the stacked
    tensors, or a remainder block's own).  A KV cache was written in place
    already; a recurrent state is new tensors (its ``conv`` None only
    after a prefill, never in decode)."""
    for k, v in new.items():
        if isinstance(v, torch.Tensor) and v is not cache[k]:
            cache[k].copy_(v)


def _batch_constraint(x: torch.Tensor, multi_pod: bool) -> torch.Tensor:
    """The reference's activation layout between blocks: batch over the
    data dims and, sequence parallelism, the sequence over ``model`` where
    it is a multiple of 16 (a no-op on a plain tensor)."""
    axes = ("pod", "data") if multi_pod else "data"
    seq = "model" if (x.dim() == 3 and x.shape[1] % 16 == 0
                      and x.shape[1] > 1) else None
    return common.with_constraint(
        x, (axes, seq) + (None,) * (x.dim() - 2))


def _embed(cfg: cfgs.ArchConfig, ctx, params: Params,
           tokens: torch.Tensor) -> torch.Tensor:
    # F.embedding: one lookup op whose backward DTensor splits by vocab
    w = params["embed"]["w"]
    x = F.embedding(tokens, common.grad_in_layout(w)
                    if cfg.tie_embeddings else w)
    if cfg.tie_embeddings:
        # sqrt(d) rounded to float32, then to the compute dtype
        x = x * torch.tensor(math.sqrt(cfg.d_model)).to(x.dtype)
    return ctx.activation("embed/out", x)


def _head(cfg: cfgs.ArchConfig, ctx, params: Params,
          x: torch.Tensor) -> torch.Tensor:
    x = common.unsplit(x, -2)            # the sequence, on DTensors
    return common.whole_seq_grad(_logits(cfg, ctx, params, x))


def _logits(cfg: cfgs.ArchConfig, ctx, params: Params,
            x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        w = ctx.weight("lm_head/w",
                       common.grad_in_layout(params["embed"]["w"]))
        logits = torch.matmul(x, w.to(x.dtype).t())
    else:
        w = ctx.weight("lm_head/w", params["lm_head"]["w"])
        logits = torch.matmul(x, w.to(x.dtype))
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(
            logits.to(torch.float32) / cfg.final_softcap)
    return logits


def _run_encoder(cfg: cfgs.ArchConfig, params: Params, ctx,
                 encoder_out: torch.Tensor) -> torch.Tensor:
    """Whisper: the transformer encoder over the stub frame embeddings
    (``encoder_layers`` pre-norm blocks of non-causal self-attention with
    RoPE, B4 once a layer, and the MLP; then ``encoder_norm``).  A config
    without an encoder returns ``encoder_out`` as it is.

    Raises ``NotImplementedError`` under a QAT context: the reference
    calls these sites inside its ``lax.scan`` with the outer context, so
    their observers escape the scan as leaked tracers
    (``repro/models/transformer.py:203-220``) and its QAT forward cannot
    run (ROADMAP queue C)."""
    if not cfg.encoder_layers:
        return encoder_out
    if isinstance(ctx, fake_quant.QATContext):
        raise NotImplementedError(
            f"QAT of {cfg.name}, a config with a transformer encoder, is "
            f"not run: the reference's encoder observers escape its "
            f"lax.scan as leaked tracers (repro/models/transformer.py:"
            f"203-220), so the JAX package cannot run it (ROADMAP queue C)")
    x = encoder_out
    for li in range(cfg.encoder_layers):
        p = _layer(params["encoder"], li)["b0_attn"]
        h, _ = attention.attention_layer(
            ctx, p["attn"], blocks.norm(cfg, p["norm1"], x),
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
            causal=False, rope_theta=cfg.rope_theta, name="enc/attn")
        x = x + h
        x = x + blocks.mlp(ctx, p["mlp"], blocks.norm(cfg, p["norm2"], x),
                           cfg.activation, name="enc/mlp")
    return blocks.norm(cfg, params["encoder_norm"], x)


def _make_ctx(cfg: cfgs.ArchConfig, collection, step):
    return fake_quant.make_context(cfg.quant, collection, step)


def _checkpointed(fn, *args):
    """``fn(*args)`` under activation checkpointing, recomputed whole in
    the backward (early stop off), with no RNG state kept."""
    with ckpt.set_checkpoint_early_stop(False):
        return ckpt.checkpoint(fn, *args, use_reentrant=False,
                               preserve_rng_state=False)


# ---------------------------------------------------------------------------
# QAT observer collection discovery
# ---------------------------------------------------------------------------

def _zeros(spec: Any) -> Any:
    if isinstance(spec, dict):
        return {k: _zeros(v) for k, v in spec.items()}
    return torch.zeros(spec.shape)


def qat_site_names(cfg: cfgs.ArchConfig) -> Tuple[Set[str], Set[str]]:
    """The activation-observer site names inside the stacked layers
    (``unit/...``) and outside them, found by one forward of zeros
    through two ``NameRecorder``s under a ``FakeTensorMode``: shapes
    only, as the reference's ``eval_shape``, so a full-size config
    allocates nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    rec_in = fake_quant.NameRecorder(cfg.quant)
    rec_out = fake_quant.NameRecorder(cfg.quant)
    with FakeTensorMode(), torch.no_grad():
        tokens = torch.zeros((1, max(len(cfg.pattern), 2)),
                             dtype=torch.long)
        enc = torch.zeros((1, 4, cfg.d_model)) \
            if cfg.cross_attn or cfg.encoder_layers else None
        forward(cfg, _zeros(param_specs(cfg)), tokens, ctx_in=rec_in,
                ctx_out=rec_out, encoder_out=enc)
    return rec_in.names, rec_out.names


def init_qat_collection(cfg: cfgs.ArchConfig, device=None
                        ) -> Dict[str, fake_quant.ObserverState]:
    """A fresh observer slot for every activation site, in sorted order,
    on ``device`` (``None`` is ``cuda``)."""
    device = resolve_device(device)
    inside, outside = qat_site_names(cfg)
    return {name: fake_quant.ObserverState.init(device)
            for name in sorted(inside | outside)}


# ---------------------------------------------------------------------------
# forward, loss
# ---------------------------------------------------------------------------

def forward(cfg: cfgs.ArchConfig, params: Params, tokens: torch.Tensor, *,
            qat_collection: Optional[Dict] = None, step=0,
            encoder_out: Optional[torch.Tensor] = None,
            multi_pod: bool = False, return_hidden: bool = False,
            ctx_in=None, ctx_out=None
            ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Full-sequence forward, as the reference's: ``(out, aux,
    new_collection)``.  ``out`` is the logits ``(B, S, vocab)``, or with
    ``return_hidden`` the final normed hidden states; ``aux`` the MoE
    load-balance loss summed over the layers (a float32 scalar, 0 without
    MoE layers).

    ``tokens (B, S)`` int.  Under a QAT config, ``qat_collection`` holds
    the observers (``init_qat_collection``) and ``step`` is the training
    step (an int or a 0-d tensor; the quantization delay reads it on the
    device); the new collection comes back with this forward's updates.
    ``ctx_in`` / ``ctx_out`` replace the QAT contexts inside and outside
    the stacked layers (site discovery).  ``encoder_out (B, T,
    d_model)``: the frontend's embeddings, run through the encoder
    (whisper) and cross-attended by the ``cross`` blocks.  Every attention
    layer is one ``ops.FlashAttentionDenseGrad`` call (kernel B4 on the
    card).  On DTensor params and tokens the reference's constraints
    apply between blocks (``_batch_constraint``, ``multi_pod`` choosing
    the data dims).
    """
    collection = qat_collection or {}
    inside = {k: v for k, v in collection.items() if k.startswith("unit/")}
    outside = {k: v for k, v in collection.items()
               if not k.startswith("unit/")}
    step = torch.as_tensor(step, device=tokens.device)
    ctx_out = ctx_out or _make_ctx(cfg, outside, step)
    x = _batch_constraint(_embed(cfg, ctx_out, params, tokens), multi_pod)
    if encoder_out is not None:
        encoder_out = _run_encoder(cfg, params, ctx_out, encoder_out)

    def unit_fn(x, obs, aux, enc, unit):
        ctx = ctx_in or _make_ctx(cfg, obs, step)
        for i, kind in enumerate(cfg.pattern):
            x, _, a = blocks.apply_block(kind, cfg, ctx,
                                         unit[f"b{i}_{kind}"], x,
                                         encoder_out=enc, name=f"unit/b{i}")
            aux = aux + a
        x = _batch_constraint(x, multi_pod)
        return x, (obs if ctx_in is not None else ctx.merged_collection()), \
            aux

    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), device=tokens.device)
    for li in range(cfg.pattern_repeats):
        args = (x, inside, aux, encoder_out, _layer(params["layers"], li))
        x, inside, aux = _checkpointed(unit_fn, *args) if remat \
            else unit_fn(*args)
    for i, kind in enumerate(cfg.pattern_remainder):
        ctx_r = ctx_in or _make_ctx(cfg, inside, step)
        x, _, a = blocks.apply_block(kind, cfg, ctx_r,
                                     params["remainder"][f"r{i}_{kind}"], x,
                                     encoder_out=encoder_out,
                                     name=f"unit/b{i}")
        if ctx_in is None:
            inside = ctx_r.merged_collection()
        aux = aux + a
    x = blocks.norm(cfg, params["final_norm"], x)
    out = x if return_hidden else _head(cfg, ctx_out, params, x)
    return out, aux, {**ctx_out.merged_collection(), **inside}


def loss_fn(cfg: cfgs.ArchConfig, params: Params,
            batch: Dict[str, torch.Tensor], *, qat_collection=None, step=0,
            multi_pod: bool = False, ce_chunk: int = 256,
            aux_weight: float = 0.01
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Causal-LM loss ``ce + aux_weight * aux`` and its metrics
    (``ce_loss``, ``aux_loss``, ``qat_collection``: the forward's new
    observers).  ``batch``: ``tokens`` and ``labels``, ``(B, S)`` int,
    and for the encoder and cross-attention configs ``encoder_out``.

    The head and the log-softmax run in ``ce_chunk`` sequence chunks
    (one chunk when S is not a multiple), each under activation
    checkpointing so the backward recomputes its logits: the ``(B, S,
    vocab)`` logits never exist at once.
    """
    tokens, labels = batch["tokens"], batch["labels"]
    hidden, aux, new_coll = forward(
        cfg, params, tokens, qat_collection=qat_collection, step=step,
        encoder_out=batch.get("encoder_out"), multi_pod=multi_pod,
        return_hidden=True)
    ctx = _make_ctx(cfg, {k: v for k, v in (qat_collection or {}).items()
                          if not k.startswith("unit/")},
                    torch.as_tensor(step, device=tokens.device))
    hidden = common.unsplit(hidden, 1)       # chunked below, on DTensors
    b, s, _ = hidden.shape
    ce_chunk = min(ce_chunk, s)
    if s % ce_chunk:
        ce_chunk = s

    def chunk_loss(h, y):
        logits = _head(cfg, ctx, params, h).to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        # the gold logit from a vocab gathered whole: DTensor's masked
        # partial gather over a split vocab cannot be reduced here
        gold = torch.gather(common.unsplit(logits, -1), -1,
                            y[..., None].long())[..., 0]
        return torch.sum(logz - gold)

    totals = []
    for c0 in range(0, s, ce_chunk):
        args = (hidden[:, c0:c0 + ce_chunk], labels[:, c0:c0 + ce_chunk])
        totals.append(_checkpointed(chunk_loss, *args)
                      if torch.is_grad_enabled() else chunk_loss(*args))
    loss = torch.sum(torch.stack(totals)) / (b * s)
    metrics = {"ce_loss": loss, "aux_loss": aux, "qat_collection": new_coll}
    return loss + aux_weight * aux, metrics


def prefill(cfg: cfgs.ArchConfig, params: Params, tokens: torch.Tensor, *,
            encoder_out: Optional[torch.Tensor] = None,
            multi_pod: bool = False) -> torch.Tensor:
    """Prompt pass returning the last token's logits ``(B, 1, vocab)``."""
    hidden, _, _ = forward(cfg, params, tokens, encoder_out=encoder_out,
                           multi_pod=multi_pod, return_hidden=True)
    ctx = _make_ctx(cfg, {}, torch.zeros((), dtype=torch.long,
                                         device=tokens.device))
    return _head(cfg, ctx, params, hidden[:, -1:])


def init_caches(cfg: cfgs.ArchConfig, batch: int, seq_len: int, *,
                int8: Optional[bool] = None, device=None,
                dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Decode state: ``{"stacked": {block: state}, "remainder": [state,
    ...]}``, each block's state (``{"kv": KVCache}``, or a recurrent
    state dict) stacked over the pattern's repeats on a leading
    ``layers`` axis.

    ``int8`` (the attention caches only) defaults to
    ``cfg.quant.int8_kv_cache``; ``device`` (``None`` is ``cuda``);
    ``dtype`` is a float KV cache's (recurrent state stays float32).
    """
    int8 = cfg.quant.int8_kv_cache if int8 is None else int8
    device = resolve_device(device)

    def block_cache(kind):
        return blocks.init_block_cache(kind, cfg, batch, seq_len, int8=int8,
                                       device=device, dtype=dtype)

    stacked = {f"b{i}_{kind}": _stack([block_cache(kind) for _ in
                                       range(cfg.pattern_repeats)])
               for i, kind in enumerate(cfg.pattern)}
    return {"stacked": stacked,
            "remainder": [block_cache(kind)
                          for kind in cfg.pattern_remainder]}


def decode_step(cfg: cfgs.ArchConfig, params: Params, tokens: torch.Tensor,
                caches: Dict[str, Any], pos, *,
                encoder_out: Optional[torch.Tensor] = None,
                multi_pod: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode token: ``tokens (B, 1)`` at absolute position ``pos``
    (an int or a 0-d tensor) -> ``(logits (B, 1, vocab), caches)``.
    ``encoder_out`` goes through the encoder at every step, and the
    ``cross`` blocks project their K and V from it at every step, as in
    the reference: nothing of it is cached.

    The caches are updated in place and returned: KV caches by
    ``attention.cache_update``, recurrent states by a copy of each
    block's new state into its slice.  ``pos`` goes to the device once
    here: every layer reads it there, so a step copies nothing from the
    host when it is a device tensor already.
    """
    ctx = _make_ctx(cfg, {}, torch.zeros((), dtype=torch.long,
                                         device=tokens.device))
    x = _batch_constraint(_embed(cfg, ctx, params, tokens), multi_pod)
    pos = torch.as_tensor(pos, device=tokens.device)
    if encoder_out is not None:
        encoder_out = _run_encoder(cfg, params, ctx, encoder_out)
    for li in range(cfg.pattern_repeats):
        unit = _layer(params["layers"], li)
        unit_cache = _layer(caches["stacked"], li)
        for i, kind in enumerate(cfg.pattern):
            key = f"b{i}_{kind}"
            x, new, _ = blocks.apply_block(kind, cfg, ctx, unit[key], x,
                                           cache=unit_cache[key], pos=pos,
                                           encoder_out=encoder_out,
                                           name=f"unit/b{i}")
            _write_state(unit_cache[key], new)
    for i, kind in enumerate(cfg.pattern_remainder):
        cache = caches["remainder"][i]
        x, new, _ = blocks.apply_block(
            kind, cfg, ctx, params["remainder"][f"r{i}_{kind}"], x,
            cache=cache, pos=pos, encoder_out=encoder_out,
            name=f"unit/b{i}")
        _write_state(cache, new)
    x = blocks.norm(cfg, params["final_norm"], x)
    return _head(cfg, ctx, params, x), caches
