"""The LM's steps, their input shapes and shardings, and the pod dry-run's
trace of them.

Counterpart of ``repro/launch/steps.py``.

* ``make_train_step`` casts the master params (float32, or the config's
  ``param_dtype``: grok-1's bfloat16) to the config's compute dtype
  (``core.mixed_precision.to_compute``), takes the value and gradient of
  ``transformer.loss_fn`` (the gradient flows back through the cast to
  the masters, in their dtype), accumulates ``cfg.grad_accum``
  micro-batches as the reference does (every batch entry, ``encoder_out``
  too, split on its leading axis; each micro-batch from the step's
  incoming QAT collection; the collection and metrics of the last one
  are kept, the loss and gradients are averaged, the sum in float32 as
  the reference's ``zero_g``), pins the gradients to the params' layout
  (``with_constraint``, on DTensors), then applies
  ``optim.adam.adam_update_`` in place: the step returns the params and
  optimizer state it was given, updated, as the reference's jit donates
  them (``donate_argnums=(0, 1, 3)``).
* ``make_prefill_step`` (last-token logits) and ``make_serve_step`` (one
  decode token through the caches, written in place; returns the argmax
  token).
* ``input_specs``, ``param_sds``, ``opt_sds``, ``cache_sds``: the
  reference's shape trees as ``meta`` tensors (nothing is allocated, a
  full grok-1 included).
* ``batch_shardings``, ``param_shardings``, ``opt_shardings``,
  ``cache_shardings``: per leaf, the reference's ``PartitionSpec`` as a
  tuple of mesh-dim entries (``common.placements`` makes DTensor
  placements of one on a mesh).
* ``resolve_arch_for_shape``: the reference's shape policy (the SWA
  variant at ``long_500k``, TP params for decode where they fit).
* ``lower_step``: the right step for an input shape traced under a
  ``FakeTensorMode`` on DTensor inputs on a mesh, counted by
  ``launch.trace_analysis.TraceCounter``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import base as cfgs
from repro_torch.core import mixed_precision as mp_lib
from repro_torch.core.ptq import tree_map, tree_tensors
from repro_torch.models import attention, common, transformer
from repro_torch.optim import adam as adam_lib

Tree = Any


def _unflatten(params: Tree, leaves: list) -> Tree:
    """``leaves`` (in ``tree_tensors`` order) in ``params``' dict
    structure."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return next(it)
    return walk(params)


def value_and_grad(cfg: cfgs.ArchConfig, params: Tree,
                   batch: Dict[str, torch.Tensor], qat_collection,
                   step: torch.Tensor, multi_pod: bool = False):
    """``(loss, metrics, grads)`` of ``loss_fn`` at the compute dtype,
    the gradients in ``params``' structure and dtypes; ``loss`` and the
    metrics detached."""
    leaves = [t.detach().requires_grad_(True)
              for _, t in tree_tensors(params)]
    with torch.enable_grad():
        p_c = mp_lib.to_compute(_unflatten(params, leaves), cfg.mp)
        loss, metrics = transformer.loss_fn(
            cfg, p_c, batch, qat_collection=qat_collection, step=step,
            multi_pod=multi_pod)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: (v.detach() if isinstance(v, torch.Tensor) else v)
               for k, v in metrics.items()}
    return loss.detach(), metrics, _unflatten(params, grads)


def make_train_step(cfg: cfgs.ArchConfig,
                    adam_cfg: Optional[adam_lib.AdamConfig] = None,
                    multi_pod: bool = False):
    """``(train_step, adam_cfg)``; ``train_step(params, opt_state, batch,
    qat_collection) -> (params, opt_state, qat_collection, metrics)``,
    the same ``params`` and ``opt_state`` updated in place,
    ``metrics`` holding ``loss``, ``ce_loss``, ``aux_loss`` and the
    pre-clip ``grad_norm`` (device scalars: no host sync).  ``batch``
    holds ``tokens`` and ``labels`` ``(B, S)`` on the params' device (and
    ``encoder_out`` for the encoder and cross-attention configs); the
    step is ``opt_state.step`` (the QAT delay reads it)."""
    adam_cfg = adam_cfg or adam_lib.AdamConfig(eightbit=cfg.optimizer_8bit)
    grad_specs = transformer.partition_specs(cfg, multi_pod=multi_pod)

    def train_step(params, opt_state, batch, qat_collection):
        step = opt_state.step
        a = cfg.grad_accum
        if a > 1:
            loss = torch.zeros((), device=step.device)
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            for i in range(a):
                micro = {k: _micro(v, a, i) for k, v in batch.items()}
                loss_i, metrics, grads_i = value_and_grad(
                    cfg, params, micro, qat_collection, step, multi_pod)
                loss = loss + loss_i
                grads = tree_map(torch.add, grads, grads_i)
            loss = loss / a
            grads = tree_map(lambda g: g / a, grads)
        else:
            loss, metrics, grads = value_and_grad(cfg, params, batch,
                                                  qat_collection, step,
                                                  multi_pod)
        grads = tree_map(common.with_constraint, grads, grad_specs)
        with torch.no_grad():
            params, opt_state, stats = adam_lib.adam_update_(
                grads, opt_state, params, adam_cfg)
        out = {"loss": loss, "ce_loss": metrics["ce_loss"],
               "aux_loss": metrics["aux_loss"], **stats}
        return params, opt_state, metrics["qat_collection"], out

    return train_step, adam_cfg


def _micro(v: torch.Tensor, a: int, i: int) -> torch.Tensor:
    """Micro-batch ``i`` of ``a``: rows ``[i * B / a, (i + 1) * B / a)``.
    A DTensor split over its batch takes that share of each rank's rows
    instead (the same rows in all, in other micro-batches), so no row
    moves: the averaged loss and gradients are the same sums."""
    from torch.distributed.tensor import DTensor, Shard
    if isinstance(v, DTensor) and Shard(0) in v.placements:
        local = v.to_local()
        part = local.reshape((a, local.shape[0] // a) + local.shape[1:])[i]
        return DTensor.from_local(part, v.device_mesh, v.placements,
                                  run_check=False,
                                  shape=(v.shape[0] // a,) + v.shape[1:],
                                  stride=part.stride())
    return v.reshape((a, v.shape[0] // a) + v.shape[1:])[i]


def make_prefill_step(cfg: cfgs.ArchConfig, multi_pod: bool = False):
    """``prefill_step(params, batch) -> (B, 1, vocab)`` last-token logits,
    the params cast to the compute dtype."""
    def prefill_step(params, batch):
        p_c = mp_lib.to_compute(params, cfg.mp)
        return transformer.prefill(cfg, p_c, batch["tokens"],
                                   encoder_out=batch.get("encoder_out"),
                                   multi_pod=multi_pod)
    return prefill_step


def make_serve_step(cfg: cfgs.ArchConfig, multi_pod: bool = False):
    """``serve_step(params, caches, batch, pos) -> (next_token (B,) int32,
    caches)``: one decode token, the caches written in place."""
    def serve_step(params, caches, batch, pos):
        p_c = mp_lib.to_compute(params, cfg.mp)
        logits, caches = transformer.decode_step(
            cfg, p_c, batch["tokens"], caches, pos,
            encoder_out=batch.get("encoder_out"), multi_pod=multi_pod)
        last = common.unsplit(logits[:, -1], -1)    # argmax over the vocab
        return torch.argmax(last, dim=-1).to(torch.int32), caches
    return serve_step


# ---------------------------------------------------------------------------
# shape trees (meta tensors: nothing is allocated)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: cfgs.ArchConfig, shape: cfgs.InputShape
                ) -> Dict[str, torch.Tensor]:
    """The step's batch at ``shape``: int32 ``tokens`` (and ``labels``
    to train; one token a row to decode), and the compute-dtype
    ``encoder_out`` of the encoder and cross-attention configs."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        specs = {"tokens": _meta((b, s), torch.int32),
                 "labels": _meta((b, s), torch.int32)}
    elif shape.kind == "prefill":
        specs = {"tokens": _meta((b, s), torch.int32)}
    else:
        specs = {"tokens": _meta((b, 1), torch.int32)}
    if cfg.cross_attn or cfg.encoder_layers:
        specs["encoder_out"] = _meta(
            (b, cfg.encoder_seq, cfg.d_model),
            getattr(torch, cfg.mp.compute_dtype))
    return specs


def param_sds(cfg: cfgs.ArchConfig, dtype: Optional[torch.dtype] = None
              ) -> Tree:
    """The param tree in ``dtype`` (the config's ``param_dtype`` by
    default: training's masters; inference passes the compute dtype)."""
    dtype = dtype or getattr(torch, cfg.mp.param_dtype)

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        return _meta(spec.shape, dtype)
    return make(transformer.param_specs(cfg))


def opt_sds(cfg: cfgs.ArchConfig, adam_cfg: adam_lib.AdamConfig
            ) -> adam_lib.AdamState:
    """``adam_init`` of the master params' shapes."""
    return adam_lib.adam_init(param_sds(cfg), adam_cfg)


def cache_sds(cfg: cfgs.ArchConfig, batch: int, seq_len: int) -> Tree:
    """The decode state, with the reference's default bfloat16 KV caches
    (int8 codes where the config quantizes them)."""
    return transformer.init_caches(cfg, batch, seq_len, device="meta",
                                   dtype=torch.bfloat16)


# ---------------------------------------------------------------------------
# shardings: per-leaf tuples of mesh-dim entries (the reference's specs)
# ---------------------------------------------------------------------------

def _data(multi_pod: bool):
    return (("pod", "data") if multi_pod else ("data",)), \
        (32 if multi_pod else 16)


def batch_shardings(cfg: cfgs.ArchConfig, shape: cfgs.InputShape,
                    multi_pod: bool) -> Dict[str, tuple]:
    """The batch dim over the data dims (one entry naming both with
    ``multi_pod``) where they divide it, else replicated."""
    data, dp = _data(multi_pod)
    bspec = data if shape.global_batch % dp == 0 else None
    specs = {"tokens": (bspec, None)}
    if shape.kind == "train":
        specs["labels"] = (bspec, None)
    if cfg.cross_attn or cfg.encoder_layers:
        specs["encoder_out"] = (bspec, None, None)
    return specs


def param_shardings(cfg: cfgs.ArchConfig, multi_pod: bool) -> Tree:
    """``transformer.partition_specs``."""
    return transformer.partition_specs(cfg, multi_pod=multi_pod)


def opt_shardings(cfg: cfgs.ArchConfig, adam_cfg: adam_lib.AdamConfig,
                  multi_pod: bool) -> adam_lib.AdamState:
    """float32 moments as their params; 8-bit codes as their params and
    scales as their params less the last dim (replicated there); the
    step replicated."""
    pspecs = param_shardings(cfg, multi_pod)
    if not adam_cfg.eightbit:
        return adam_lib.AdamState(step=(), m=pspecs, v=pspecs)
    params = param_sds(cfg)

    def one(p, spec):
        if isinstance(p, dict):
            return {k: one(p[k], spec[k]) for k in p}
        sspec = tuple(spec[:-1]) + (None,) if len(spec) else spec
        return adam_lib.BlockQuantized(codes=spec, scales=sspec,
                                       shape=tuple(p.shape))
    moments = one(params, pspecs)
    return adam_lib.AdamState(step=(), m=moments, v=moments)


def cache_shardings(cfg: cfgs.ArchConfig, shape: cfgs.InputShape,
                    multi_pod: bool) -> Tree:
    """The reference's cache layout: a 5-D leaf ``(L, B, T, KV, Dh)`` has
    its batch over the data dims (or T where the batch does not divide
    and T does), T over ``model`` where it is a multiple of 16 and not
    split yet, else Dh over ``model`` where it is; another leaf has its
    dim 1 over the data dims where that is the batch and it divides,
    else is replicated."""
    data, dp = _data(multi_pod)
    b = shape.global_batch
    batch_ok = b % dp == 0

    def one(leaf):
        if leaf.dim() == 5:
            _, _, t, _, dh = leaf.shape
            spec = [None] * 5
            if batch_ok:
                spec[1] = data
            elif t % dp == 0:
                spec[2] = data
            if t % 16 == 0 and spec[2] is None:
                spec[2] = "model"
            elif dh % 16 == 0 and dh > 1:
                spec[4] = "model"
            return tuple(spec)
        if leaf.dim() >= 2 and batch_ok and leaf.shape[1] == b:
            return (None, data) + (None,) * (leaf.dim() - 2)
        return (None,) * leaf.dim()
    return map_tree(one, cache_sds(cfg, b, shape.seq_len))


def map_tree(fn, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the tensors of dicts, lists, ``KVCache``s (a None field
    stays None), ``AdamState``s and ``BlockQuantized`` (its ``shape``
    kept); ``rest`` trees of the same structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, *xs) for xs in zip(tree, *rest)]
    if isinstance(tree, adam_lib.BlockQuantized):
        return adam_lib.BlockQuantized(
            map_tree(fn, tree.codes, *(r.codes for r in rest)),
            map_tree(fn, tree.scales, *(r.scales for r in rest)),
            tree.shape)
    if isinstance(tree, (attention.KVCache, adam_lib.AdamState)):
        return type(tree)(*(None if x is None else map_tree(fn, x, *xs)
                            for x, *xs in zip(tree, *rest)))
    return fn(tree, *rest)


def leaves(tree: Tree) -> list:
    """The tensors of a ``map_tree`` tree, dict keys sorted (the
    reference's flatten order; None fields dropped)."""
    out = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, adam_lib.BlockQuantized):
            walk(node.codes)
            walk(node.scales)
        elif isinstance(node, (list, attention.KVCache,
                               adam_lib.AdamState)):
            for x in node:
                if x is not None:
                    walk(x)
        else:
            out.append(node)
    walk(tree)
    return out


def resolve_arch_for_shape(cfg: cfgs.ArchConfig, shape: cfgs.InputShape
                           ) -> Tuple[cfgs.ArchConfig, str]:
    """The reference's shape policy: ``long_500k`` on a config without
    native long context runs its sliding-window variant (window 4,096);
    decode switches an fsdp config to TP params where its bfloat16
    weights over the model dim stay under 12 GB (grok-1 and
    llama-vision-90b keep fsdp)."""
    variant = "native"
    if shape.name == "long_500k" and not cfg.supports_long_500k:
        cfg = dataclasses.replace(cfg, long_context_window=4096)
        variant = "swa-variant"
    if shape.kind == "decode" and cfg.sharding == "fsdp" \
            and cfg.n_params() * 2 / 16 < 12e9:
        cfg = dataclasses.replace(cfg, sharding="tp")
    return cfg, variant


# ---------------------------------------------------------------------------
# the dry-run's trace
# ---------------------------------------------------------------------------

def local_shape(shape, spec: tuple, mesh) -> Tuple[int, ...]:
    """Rank 0's shard of ``shape`` under ``spec``: each sharded dim
    divided, rounding up, by every mesh dim it is split over (DTensor's
    chunks)."""
    out = list(shape)
    names = mesh.mesh_dim_names
    for d, entry in enumerate(spec):
        for name in common.entry_dims(entry, names):
            out[d] = -(-out[d] // mesh.size(names.index(name)))
    return tuple(out)


def _distribute(tree: Tree, specs: Tree, mesh, dev: torch.device,
                fake) -> Tree:
    """Fake DTensors of ``tree``'s shapes and dtypes on ``mesh``, each
    rank's local shard made empty under the fake mode ``fake`` (rank 0's
    shape: ceil division per sharded dim)."""
    from torch.distributed.tensor import DTensor

    def one(meta, spec):
        pl = common.placements(spec, mesh)
        with fake:
            local = torch.empty(local_shape(meta.shape, spec, mesh),
                                dtype=meta.dtype, device=dev)
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=meta.shape,
                                  stride=torch.empty(
                                      meta.shape, device="meta").stride())
    return map_tree(one, tree, specs)


def lower_step(cfg: cfgs.ArchConfig, shape: cfgs.InputShape, mesh, *,
               multi_pod: bool = False,
               adam_cfg: Optional[adam_lib.AdamConfig] = None,
               device=None, depths: Optional[Tuple[int, ...]] = None
               ) -> Tuple[Dict[str, Any], str]:
    """Trace the step for ``shape`` on ``mesh``: ``trace_step`` at the
    config's depth, or, with ``depths`` (say ``(1, 2, 3)``), at those
    repeats of its layer pattern (the remainder kept), every count then
    carried to the config's repeats along the polynomial through them.
    Each repeat runs the same local ops on the same shapes, so operations,
    collectives and the argument, output and alias bytes grow linearly
    with the repeats, and bytes accessed also in their square (each
    layer's slice of a stacked gradient is written into a zero tensor of
    the whole stack): three depths carry them exactly (the tests hold
    them to a whole trace).  The peak (``temp``) is no polynomial in the
    depth (where it falls moves as layers are added), so it is carried
    along the line through the two deepest traces, an estimate
    (``temp_carried`` in the record).  The record's ``depths`` says
    which (None: traced whole); ``trace_s`` is all the traces'."""
    if depths is None or cfg.pattern_repeats <= max(depths):
        rec, kind = trace_step(cfg, shape, mesh, multi_pod=multi_pod,
                               adam_cfg=adam_cfg, device=device)
        rec["depths"] = None
        return rec, kind
    from fractions import Fraction
    unit, rem = len(cfg.pattern), len(cfg.pattern_remainder)
    recs = [trace_step(dataclasses.replace(cfg, n_layers=n * unit + rem),
                       shape, mesh, multi_pod=multi_pod, adam_cfg=adam_cfg,
                       device=device)[0] for n in depths]
    kind = shape.kind
    n = cfg.pattern_repeats
    weights = []
    for i, a in enumerate(depths):
        w = Fraction(1)
        for j, b in enumerate(depths):
            if j != i:
                w *= Fraction(n - b, a - b)
        weights.append(w)

    def carry(*xs):
        if isinstance(xs[0], dict):
            return {k: carry(*(x.get(k, 0) for x in xs)) for k in xs[0]}
        v = sum(w * Fraction(x) for w, x in zip(weights, xs))
        return int(v) if isinstance(xs[0], int) else float(v)
    rec = carry(*({k: v for k, v in r.items()
                   if k not in ("trace_s", "memory")} for r in recs))
    mems = [r["memory"] for r in recs]
    mem = carry(*({k: m[k] for k in m if k not in (
        "temp_size_in_bytes", "total_nonalias_bytes")} for m in mems))
    (a, ta_), (b, tb) = [(d, m["temp_size_in_bytes"])
                         for d, m in zip(depths, mems)][-2:]
    mem["temp_size_in_bytes"] = tb + (tb - ta_) * (n - b) / (b - a)
    from repro_torch.launch import trace_analysis as tan
    rec["memory"] = tan.summarize_memory(mem)
    rec["temp_carried"] = f"linear from depths {a} and {b}"
    rec["trace_s"] = sum(r["trace_s"] for r in recs)
    rec["depths"] = list(depths)
    return rec, kind


def trace_step(cfg: cfgs.ArchConfig, shape: cfgs.InputShape, mesh, *,
               multi_pod: bool = False,
               adam_cfg: Optional[adam_lib.AdamConfig] = None,
               device=None) -> Tuple[Dict[str, Any], str]:
    """Trace the step for ``shape`` once on ``mesh`` (the default group
    may be a fake one): DTensor inputs with the reference's shardings,
    their local shards ``FakeTensor``s on ``device`` (``None`` is
    ``cuda``), so every op on them is shapes only, nothing of their size
    is allocated and no kernel launches (each kernel takes its
    shape-only branch).  The fake mode is not entered for the step
    itself: DTensor's own bookkeeping (a few index tensors) and the
    model's small constants (positions, masks) stay real, and plain
    tensors meet DTensors as replicated ones
    (``implicit_replication``).  Returns ``(record, kind)``:
    the record holds ``flops``, ``kernel_flops``, ``kernels`` (shape-only
    calls by kernel), ``bytes_accessed``, ``collective_breakdown``
    (``trace_analysis.collective_stats``), ``memory`` (the reference's
    ``memory_analysis`` fields; ``alias`` the params and moments the
    train step updates in place, or the caches of decode) and
    ``trace_s``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.device import resolve_device
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import trace_analysis as ta
    dev = resolve_device(device)
    mesh = mesh_lib.folded(mesh)
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    counter = ta.TraceCounter(fake)
    t0 = time.time()
    with implicit_replication():
        batch = _distribute(input_specs(cfg, shape),
                            batch_shardings(cfg, shape, multi_pod), mesh,
                            dev, fake)
        infer = getattr(torch, cfg.mp.compute_dtype) \
            if shape.kind != "train" else None
        params = _distribute(param_sds(cfg, infer),
                             param_shardings(cfg, multi_pod), mesh, dev,
                             fake)
        if shape.kind == "train":
            step, adam_cfg = make_train_step(cfg, adam_cfg,
                                             multi_pod=multi_pod)
            opt = _distribute(opt_sds(cfg, adam_cfg),
                              opt_shardings(cfg, adam_cfg, multi_pod),
                              mesh, dev, fake)
            qat = {}
            if cfg.quant.is_qat:
                raise NotImplementedError("the dry-run traces no QAT "
                                          "config")
            args = (params, opt, batch, qat)
            kind = "train"
        elif shape.kind == "prefill":
            step = make_prefill_step(cfg, multi_pod=multi_pod)
            args = (params, batch)
            kind = "prefill"
        else:
            step = make_serve_step(cfg, multi_pod=multi_pod)
            caches = _distribute(
                cache_sds(cfg, shape.global_batch, shape.seq_len),
                cache_shardings(cfg, shape, multi_pod), mesh, dev, fake)
            pos = torch.full((), shape.seq_len - 1, dtype=torch.int32,
                             device=dev)
            args = (params, caches, batch, pos)
            kind = "decode"
        counter.arguments(args)
        with counter.counting():
            out = step(*args)
        memory = ta.memory_record(counter, out)
        del out, args
    record = {
        "flops": counter.flops, "kernel_flops": counter.kernel_flops,
        "kernels": dict(counter.kernels),
        "bytes_accessed": counter.bytes,
        "collective_breakdown": ta.collective_stats(counter),
        "collective_calls": counter.collective_calls,
        "memory": ta.summarize_memory(memory),
        "trace_s": time.time() - t0,
    }
    return record, kind
