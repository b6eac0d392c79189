"""The language model: embed -> stacked block pattern -> norm -> head.

Counterpart of ``repro/models/transformer.py`` for inference:
``param_specs``, ``init_params``, ``forward``, ``prefill``,
``init_caches`` and ``decode_step``, plus ``params_from_jax``.

``cfg.pattern`` is the repeating unit of block kinds; the parameters of
all repeats are stacked on a leading ``layers`` axis, as in the
reference, and the remainder (``n_layers % len(pattern)``) is kept apart.
Where the reference scans over the stacked axis, the port loops over it
and takes each layer's slice as a view.  Decode state is stacked the
same way: an attention block's KV cache is updated in place
(``attention.cache_update``), and a recurrent block's new state is
copied back into its slice of the stacked tensors.

Prefill's attention goes through kernel B4 on the card, one launch per
attention layer; decode through an int8 cache through kernel B3.  The
MoE blocks' load-balance loss is summed over the layers, as the
reference's ``forward`` returns it.  ``forward`` under a QAT config is LM
training, and the encoder (whisper) and cross-attention frontends come
with other configs (``param_specs`` refuses them): both raise
``NotImplementedError`` naming ROADMAP queue A, item 13.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import base as cfgs
from repro_torch.core.fake_quant import NullQATContext
from repro_torch.device import resolve_device
from repro_torch.models import attention, blocks, common
from repro_torch.models.common import P

Params = Dict[str, Any]


def _unit_spec(cfg: cfgs.ArchConfig) -> Dict[str, Any]:
    return {f"b{i}_{kind}": blocks.block_spec(kind, cfg)
            for i, kind in enumerate(cfg.pattern)}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue "
                               f"A, item 13)")


def param_specs(cfg: cfgs.ArchConfig) -> Dict[str, Any]:
    """The model's parameter spec tree (the reference's key layout)."""
    if cfg.encoder_layers or cfg.cross_attn:
        raise _not_ported("the encoder / cross-attention frontend")
    spec: Dict[str, Any] = {
        "embed": {"w": P((cfg.vocab, cfg.d_model), init="embed")},
        "final_norm": (common.rms_norm_spec(cfg.d_model) if cfg.norm == "rms"
                       else common.layer_norm_spec(cfg.d_model)),
        "layers": common.stack_specs(_unit_spec(cfg), cfg.pattern_repeats),
    }
    if cfg.pattern_remainder:
        spec["remainder"] = {
            f"r{i}_{kind}": blocks.block_spec(kind, cfg)
            for i, kind in enumerate(cfg.pattern_remainder)}
    if not cfg.tie_embeddings:
        spec["lm_head"] = {"w": P((cfg.d_model, cfg.vocab))}
    return spec


def init_params(cfg: cfgs.ArchConfig, generator: torch.Generator,
                device=None) -> Params:
    """Seeded float32 params (``common.init_params``: drawn on the CPU in
    sorted-key order, then moved to ``device``, ``None`` being ``cuda``)."""
    return common.init_params(param_specs(cfg), generator, device)


def params_from_jax(tree: Any, device=None) -> Params:
    """The port's params from a JAX param tree.

    ``tree`` is the reference's nested dicts of arrays (numpy, or anything
    ``np.asarray`` takes), with the stacked leading ``layers`` axis; the
    result keeps the keys and shapes, in float32 on ``device`` (``None``
    is ``cuda``).
    """
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)


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


def _embed(cfg: cfgs.ArchConfig, ctx, params: Params,
           tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"]["w"][tokens]
    if cfg.tie_embeddings:
        x = x * math.sqrt(cfg.d_model)
    return ctx.activation("embed/out", x)


def _head(cfg: cfgs.ArchConfig, ctx, params: Params,
          x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        w = ctx.weight("lm_head/w", params["embed"]["w"])
        logits = torch.matmul(x, w.to(x.dtype).t())
    else:
        w = ctx.weight("lm_head/w", params["lm_head"]["w"])
        logits = torch.matmul(x, w.to(x.dtype))
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(
            logits.to(torch.float32) / cfg.final_softcap)
    return logits


def _final_norm(cfg: cfgs.ArchConfig, params: Params,
                x: torch.Tensor) -> torch.Tensor:
    norm = common.rms_norm if cfg.norm == "rms" else common.layer_norm
    return norm(params["final_norm"], x)


def _check_inference(cfg: cfgs.ArchConfig) -> None:
    if cfg.quant.is_qat:
        raise _not_ported("LM training (forward under a QAT config)")


def forward(cfg: cfgs.ArchConfig, params: Params, tokens: torch.Tensor, *,
            return_hidden: bool = False, return_aux: bool = False) -> Any:
    """Full-sequence forward: logits ``(B, S, vocab)``, or the final
    normed hidden states; with ``return_aux`` the pair ``(out, aux)``,
    ``aux`` the MoE load-balance loss summed over the layers (a float32
    scalar, 0 without MoE layers).

    ``tokens (B, S)`` int.  Every attention layer is one
    ``ops.flash_attention`` call (kernel B4 on the card).  The
    reference's third output, the QAT observers, comes with LM training.
    """
    _check_inference(cfg)
    ctx = NullQATContext()
    x = _embed(cfg, ctx, params, tokens)
    aux = torch.zeros((), device=x.device)
    for li in range(cfg.pattern_repeats):
        unit = _layer(params["layers"], li)
        for i, kind in enumerate(cfg.pattern):
            x, _, a = blocks.apply_block(kind, cfg, ctx,
                                         unit[f"b{i}_{kind}"], x,
                                         name=f"unit/b{i}")
            aux = aux + a
    for i, kind in enumerate(cfg.pattern_remainder):
        x, _, a = blocks.apply_block(kind, cfg, ctx,
                                     params["remainder"][f"r{i}_{kind}"], x,
                                     name=f"unit/b{i}")
        aux = aux + a
    x = _final_norm(cfg, params, x)
    out = x if return_hidden else _head(cfg, ctx, params, x)
    return (out, aux) if return_aux else out


def prefill(cfg: cfgs.ArchConfig, params: Params,
            tokens: torch.Tensor) -> torch.Tensor:
    """Prompt pass returning the last token's logits ``(B, 1, vocab)``."""
    hidden = forward(cfg, params, tokens, return_hidden=True)
    return _head(cfg, NullQATContext(), params, hidden[:, -1:])


def init_caches(cfg: cfgs.ArchConfig, batch: int, seq_len: int, *,
                int8: Optional[bool] = None, device=None) -> Dict[str, Any]:
    """Decode state: ``{"stacked": {block: state}, "remainder": [state,
    ...]}``, each block's state (``{"kv": KVCache}``, or a recurrent
    state dict) stacked over the pattern's repeats on a leading
    ``layers`` axis.

    ``int8`` (the attention caches only) defaults to
    ``cfg.quant.int8_kv_cache``; ``device`` (``None`` is ``cuda``).
    """
    int8 = cfg.quant.int8_kv_cache if int8 is None else int8
    device = resolve_device(device)

    def block_cache(kind):
        return blocks.init_block_cache(kind, cfg, batch, seq_len, int8=int8,
                                       device=device)

    stacked = {f"b{i}_{kind}": _stack([block_cache(kind) for _ in
                                       range(cfg.pattern_repeats)])
               for i, kind in enumerate(cfg.pattern)}
    return {"stacked": stacked,
            "remainder": [block_cache(kind)
                          for kind in cfg.pattern_remainder]}


def decode_step(cfg: cfgs.ArchConfig, params: Params, tokens: torch.Tensor,
                caches: Dict[str, Any], pos
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode token: ``tokens (B, 1)`` at absolute position ``pos``
    (an int or a 0-d tensor) -> ``(logits (B, 1, vocab), caches)``.

    The caches are updated in place and returned: KV caches by
    ``attention.cache_update``, recurrent states by a copy of each
    block's new state into its slice.  ``pos`` goes to the device once
    here: every layer reads it there, so a step copies nothing from the
    host when it is a device tensor already.
    """
    _check_inference(cfg)
    ctx = NullQATContext()
    x = _embed(cfg, ctx, params, tokens)
    pos = torch.as_tensor(pos, device=x.device)
    for li in range(cfg.pattern_repeats):
        unit = _layer(params["layers"], li)
        unit_cache = _layer(caches["stacked"], li)
        for i, kind in enumerate(cfg.pattern):
            key = f"b{i}_{kind}"
            x, new, _ = blocks.apply_block(kind, cfg, ctx, unit[key], x,
                                           cache=unit_cache[key], pos=pos,
                                           name=f"unit/b{i}")
            _write_state(unit_cache[key], new)
    for i, kind in enumerate(cfg.pattern_remainder):
        cache = caches["remainder"][i]
        x, new, _ = blocks.apply_block(
            kind, cfg, ctx, params["remainder"][f"r{i}_{kind}"], x,
            cache=cache, pos=pos, name=f"unit/b{i}")
        _write_state(cache, new)
    x = _final_norm(cfg, params, x)
    return _head(cfg, ctx, params, x), caches
