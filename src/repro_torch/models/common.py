"""Parameter specs and the primitive layers of the port's models.

Counterpart of ``repro/models/common.py``.  A model describes its
parameters as a nested dict of ``P`` leaves (shape, initializer, scale);
``init_params`` makes the tensors.  Layers are plain functions of
``(params, x)``, and ``dense`` threads the QAT context's weight and
activation hooks as the reference does.

Each ``P`` also carries the reference's logical axes (one name a dim:
``vocab``, ``embed``, ``heads``, ``kv``, ``head_dim``, ``mlp``,
``moe_mlp``, ``expert``, ``layers``, or None).  ``sharding_rules`` maps
them to mesh dims under a policy (``tp`` / ``fsdp``) with the
reference's table, ``partition_specs`` turns a spec tree into a tree of
per-dim mesh-dim entries (a name, a tuple of names such as ``("pod",
"data")``, or None: the reference's ``PartitionSpec``), from which
``launch.steps`` builds DTensor placements, and ``with_constraint``
redistributes a ``DTensor`` to such a spec (a no-op on a plain tensor,
as the reference's is outside a mesh).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.device import resolve_device


class P(NamedTuple):
    """Spec of one parameter tensor; ``axes`` names each dim's logical
    axis (empty: none named, every dim replicated)."""

    shape: Tuple[int, ...]
    init: str = "normal"           # normal | zeros | ones | embed
    scale: Optional[float] = None  # None = fan-in 1 / sqrt(shape[-2])
    axes: Tuple[Optional[str], ...] = ()


def init_params(specs: Any, generator: torch.Generator,
                device=None, dtype: torch.dtype = torch.float32) -> Any:
    """Tensors from a spec tree.

    ``normal``: normal draws times the leaf's scale (the reference's
    fan-in default ``1 / sqrt(shape[-2])``); ``embed``: normal draws times
    0.02; ``zeros`` and ``ones`` draw nothing.  Leaves are drawn in
    sorted-key order from ``generator``, on its device (a CPU generator
    gives the same params on every device; a CUDA one draws a large tree
    on the card), in float32, then cast to ``dtype`` (round to nearest
    even, as the reference's ``astype``) and moved to ``device``
    (``None`` is ``cuda``).
    """
    device = resolve_device(device)

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(spec[k]) for k in sorted(spec)}
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        if spec.init == "embed":
            scale = 0.02
        elif spec.init == "normal":
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 \
                else spec.shape[-1]
            scale = spec.scale if spec.scale is not None \
                else 1.0 / math.sqrt(fan_in)
        else:
            raise ValueError(f"unknown init {spec.init!r}")
        return torch.randn(spec.shape, generator=generator,
                           device=generator.device).mul_(scale).to(
                               device=device, dtype=dtype)

    return make(specs)


def stack_specs(specs: Any, n: int) -> Any:
    """Prepend a stacked ``layers`` axis of size ``n`` to every leaf."""
    if isinstance(specs, dict):
        return {k: stack_specs(v, n) for k, v in specs.items()}
    axes = tuple(specs.axes) or (None,) * len(specs.shape)
    return P((n,) + tuple(specs.shape), specs.init, specs.scale,
             ("layers",) + axes)


# ---------------------------------------------------------------------------
# sharding: logical axis -> mesh dims
# ---------------------------------------------------------------------------

def sharding_rules(policy: str, *, multi_pod: bool = False,
                   divisible: Callable[[str], bool] = lambda a: True
                   ) -> Dict[Optional[str], Any]:
    """The reference's rule table for ``policy``.

    ``tp``: the model-dim axes over ``model``.  ``fsdp``: also ``embed``
    over the data dims (``("pod", "data")`` with ``multi_pod``), so the
    optimizer state scales with ``1 / (data * model)``.
    ``divisible(axis)`` vetoes an axis whose size does not divide its
    mesh dim (whisper's 6 heads, a vocab of 51,865).
    """
    data = ("pod", "data") if multi_pod else "data"
    rules = {
        "vocab": "model",
        "heads": "model",
        "kv": "model",
        "mlp": "model",
        "moe_mlp": "model",
        "expert": None,
        "embed": data if policy == "fsdp" else None,
        "head_dim": None,
        "layers": None,
        None: None,
    }
    return {k: (v if (k is None or divisible(k)) else None)
            for k, v in rules.items()}


def partition_specs(specs: Any, rules: Dict[Optional[str], Any]) -> Any:
    """A spec tree -> the tree of its leaves' per-dim mesh-dim entries
    (tuples, one entry a dim)."""
    if isinstance(specs, dict):
        return {k: partition_specs(v, rules) for k, v in specs.items()}
    axes = tuple(specs.axes) or (None,) * len(specs.shape)
    return tuple(rules.get(a, None) for a in axes)


def entry_dims(entry, names) -> Tuple[str, ...]:
    """The mesh dims among ``names`` a spec entry splits over.  A tuple
    entry drops the names the mesh lacks while one of them is left (a
    mesh whose ``data`` dim holds the pods too takes ``("pod", "data")``
    on it); a name alone the mesh lacks raises ``KeyError``."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        if entry not in names:
            raise KeyError(entry)
        return (entry,)
    kept = tuple(n for n in entry if n in names)
    if entry and not kept:
        raise KeyError(entry)
    return kept


def placements(spec: Tuple[Any, ...], mesh) -> list:
    """DTensor placements on ``mesh`` for a per-dim spec: mesh dim ``n``
    shards tensor dim ``d`` where ``spec[d]`` names ``n`` (alone or in a
    tuple, the tuple's order being the mesh's; ``entry_dims``), else
    replicates."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * mesh.ndim
    names = mesh.mesh_dim_names
    for d, entry in enumerate(spec):
        for name in entry_dims(entry, names):
            out[names.index(name)] = Shard(d)
    return out


def with_constraint(x, spec: Tuple[Any, ...]):
    """The reference's sharding constraint.  A ``DTensor`` is
    redistributed to the placements ``spec`` names on its mesh (nothing
    moves when it has them already); a plain tensor, or a spec naming a
    dim the mesh lacks, comes back as it is, as the reference's
    constraint outside a mesh (or on a mesh without that axis) does.  A
    split that does not divide its dim is left out (that dim stays
    whole): where XLA pads, DTensor's ops take few uneven splits."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    names = mesh.mesh_dim_names

    def even(d, entry):
        ways = 1
        try:
            for name in entry_dims(entry, names):
                ways *= mesh.size(names.index(name))
        except KeyError:
            return True
        return x.shape[d] % ways == 0
    spec = tuple(e if even(d, e) else None for d, e in enumerate(spec))
    try:
        target = placements(spec, mesh)
    except KeyError:
        return x
    if list(x.placements) == target:
        return x
    return x.redistribute(x.device_mesh, target)


def unsplit(x, dim: int):
    """A DTensor with its split of ``dim`` gathered (a plain tensor as it
    is): for ops DTensor has no strategy for along a split dim."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    dim = dim % x.dim()
    pl = [Replicate() if p == Shard(dim) else p for p in x.placements]
    return x if pl == list(x.placements) else \
        x.redistribute(x.device_mesh, pl)


def even_only(x, whole: Optional[int] = None):
    """A DTensor with every split its dim does not divide gathered, and
    with ``whole`` (a dim) everything gathered where some mesh dim does
    not divide that dim (a plain tensor as it is): DTensor's views take
    no uneven split, and its strategies may pick one."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    if whole is not None and any(x.shape[whole] % mesh.size(i)
                                 for i in range(mesh.ndim)):
        pl = [Replicate()] * mesh.ndim
    else:
        pl = [Replicate() if isinstance(p, Shard)
              and x.shape[p.dim] % mesh.size(i) else p
              for i, p in enumerate(x.placements)]
    return x if pl == list(x.placements) else x.redistribute(mesh, pl)


def whole_seq_grad(y):
    """``y``, whose gradient comes back with its sequence split gathered
    (a DTensor of rank 3 or more; a plain tensor as it is): a matmul's
    backward then folds batch and sequence, which some of DTensor's
    versions refuse over a split sequence (a residual stream split over
    ``model`` hands such a gradient back)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(y, DTensor) or y.dim() < 3:
        return y
    return _GradMap.apply(y, lambda g, _: unsplit(g, -2))


def grad_in_layout(w):
    """``w``, whose gradient comes back in ``w``'s own placements (a
    DTensor; a plain tensor as it is).  Where one param feeds two ops
    (tied embeddings), autograd then adds two gradients of one layout:
    the card's DTensor (2.11) cannot turn a split gradient into the
    other's partial sum."""
    from torch.distributed.tensor import DTensor
    if not isinstance(w, DTensor):
        return w
    return _GradMap.apply(w, lambda g, pl: g if tuple(g.placements) == pl
                          else g.redistribute(g.device_mesh, pl))


class _GradMap(torch.autograd.Function):
    """The identity, its gradient mapped by ``fn(g, placements)``
    (``placements``: the input's)."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn, ctx.placements = fn, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g, ctx.placements), None


def batch_local(fn: Callable, n_out: int, *args):
    """``fn(*args)``.  On DTensors, ``fn`` runs on each rank's shard of
    the leading (batch) dim, split over the mesh's data dims where they
    divide it (else whole), every other dim gathered; its ``n_out``
    outputs, each batch-leading, come back in that split.  For a loop
    over time steps: its ops then run on local tensors, without
    DTensor's dispatch per op (a ``None`` argument passes through)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    first = next((a for a in args if isinstance(a, DTensor)), None)
    if first is None:
        return fn(*args)
    mesh = first.device_mesh
    data = [i for i, n in enumerate(mesh.mesh_dim_names)
            if n in ("pod", "data")]
    even = first.shape[0] % math.prod(mesh.size(i) for i in data) == 0
    pl = tuple(Shard(0) if even and i in data else Replicate()
               for i in range(mesh.ndim))
    return local_map(fn, out_placements=(pl,) * n_out,
                     in_placements=tuple(None if a is None else pl
                                         for a in args),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def reshape(x, *shape):
    """``x.reshape(*shape)``.  A DTensor whose split the reshape cannot
    carry (DTensor has no strategy for an uneven one: 8 KV heads out of a
    dim split 16 ways) is first gathered but for a split of its leading
    dim, then, if that is not enough either, gathered whole; its
    gradient's reshape back falls back the same way."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    return _DReshape.apply(x, tuple(shape))


def _dreshape(x, shape):
    from torch.distributed.tensor import Replicate, Shard
    try:
        return x.reshape(shape)
    except RuntimeError:
        pass
    mesh = x.device_mesh
    keep = [p if p == Shard(0) else Replicate() for p in x.placements]
    try:
        return x.redistribute(mesh, keep).reshape(shape)
    except RuntimeError:
        return x.redistribute(mesh, [Replicate()] * mesh.ndim).reshape(
            shape)


class _DReshape(torch.autograd.Function):
    """A DTensor reshape whose forward and backward each fall back."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.in_shape = tuple(x.shape)
        return _dreshape(x, shape)

    @staticmethod
    def backward(ctx, g):
        return _dreshape(g, ctx.in_shape), None


# ---------------------------------------------------------------------------
# primitive layers
# ---------------------------------------------------------------------------

def dense(ctx, name: str, params: Dict[str, torch.Tensor], x: torch.Tensor,
          *, quant_act: bool = True) -> torch.Tensor:
    """``x @ W (+ b)`` with the QAT context's weight / activation hooks
    (the attention and MLP projections have no bias; the xLSTM gates
    do), the weight and bias cast to ``x``'s dtype as the reference's."""
    x = unsplit(x, -2) if x.dim() > 2 else x   # the sequence, on DTensors
    y = whole_seq_grad(torch.matmul(
        x, ctx.weight(f"{name}/w", params["w"]).to(x.dtype)))
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    if quant_act:
        y = ctx.activation(f"{name}/out", y)
    return y


def dense_spec(d_in: int, d_out: int, in_axis: Optional[str] = None,
               out_axis: Optional[str] = None, *, bias: bool = False
               ) -> Dict[str, P]:
    """A ``(d_in, d_out)`` weight on logical axes ``(in_axis,
    out_axis)``, fan-in scaled, and with ``bias`` a zero ``(d_out,)``
    bias ``b`` on ``(out_axis,)``."""
    spec = {"w": P((d_in, d_out), axes=(in_axis, out_axis))}
    if bias:
        spec["b"] = P((d_out,), init="zeros", axes=(out_axis,))
    return spec


def rms_norm(params: Dict[str, torch.Tensor], x: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x**2) + eps) * (1 + scale)`` over the last dim.

    Not bitwise across packages or devices: the mean's reduction order
    and ``rsqrt`` differ, by an ulp or so.
    """
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].to(torch.float32))).to(x.dtype)


def rms_norm_spec(d: int) -> Dict[str, P]:
    """The norm's gain, stored as ``scale`` and applied as ``1 + scale``
    (zero-initialized)."""
    return {"scale": P((d,), init="zeros", axes=("embed",))}


def layer_norm(params: Dict[str, torch.Tensor], x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """``(x - mean) * rsqrt(var + eps) * scale + bias`` over the last dim
    (the biased variance, as ``jnp.var``)."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(x.dtype)


def layer_norm_spec(d: int) -> Dict[str, P]:
    """Gain (ones) and bias (zeros)."""
    return {"scale": P((d,), init="ones", axes=("embed",)),
            "bias": P((d,), init="zeros", axes=("embed",))}


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    """``1 / theta ** (2i / head_dim)`` for ``i < head_dim / 2``, f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate halves of ``x (..., S, H, Dh)`` by ``positions`` (broadcast
    to ``(..., S)``), as the reference does (split halves, not
    interleaved pairs)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions.to(torch.float32)[..., None] * freqs   # (..., S, Dh/2)
    angles = angles[..., None, :]                              # head axis
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
