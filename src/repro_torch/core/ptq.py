"""Post-training quantization of parameter trees (QuaRL Algorithm 1).

Counterpart of ``repro/core/ptq.py``: ``ptq_simulate`` quantize-dequantizes
every weight in place of the float one (what the paper evaluates), and
``ptq_pack`` / ``ptq_unpack`` are the deployment form.  A param
tree is nested dicts (and tuples) of tensors; ``ptq_pack`` turns every
float weight of two dimensions or more into a ``PackedTensor`` -- int8
codes (or int4 codes two per byte) with affine params, per tensor for a
dense ``(K, N)`` weight and per output channel for an HWIO conv kernel --
and passes biases (one dimension) through unchanged, as the paper's
per-layer weight quantization does.  Weights keep the reference's
layouts (``y = x @ w``; conv kernels HWIO), so codes and column scales
compare one for one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Optional, Tuple

import torch

from repro_torch.core import affine
from repro_torch.core.qconfig import QuantConfig, QuantMode

Tree = Any


@dataclasses.dataclass(frozen=True, eq=False)
class PackedTensor:
    """An int-packed weight: codes + affine params (deployment format).

    ``col_scale`` / ``col_zero`` are the ``(N,)`` f32 per-column arrays the
    GEMM epilogue reads, built once at pack time (a per-tensor scale
    broadcast, a conv kernel's per-channel one flattened).  With ``bits
    <= 4`` the codes are packed two per byte along K (``affine.pack_int4``)
    in the GEMM's ``(K, N)`` layout -- a conv kernel's first transposed to
    the im2col ``(C_in * kh * kw, C_out)`` order -- and ``orig_shape``
    holds the weight's unpacked shape; ``None`` means the codes are stored
    one per byte in the weight's own layout (HWIO for a conv kernel).
    """

    codes: torch.Tensor
    delta: torch.Tensor
    zero_point: torch.Tensor
    bits: int
    col_scale: torch.Tensor
    col_zero: torch.Tensor
    orig_shape: Optional[Tuple[int, ...]] = None

    TENSOR_FIELDS = ("codes", "delta", "zero_point", "col_scale", "col_zero")

    def unpacked_codes(self) -> torch.Tensor:
        """Codes widened to one per int8, in the stored ``(K, N)`` layout."""
        if self.orig_shape is None:
            return self.codes
        k = 1
        for d in self.orig_shape[:-1]:
            k *= d
        return affine.unpack_int4(self.codes, k)

    def dequantize(self) -> torch.Tensor:
        """The float32 weight ``delta * (q - z)``, in the weight's shape."""
        p = affine.AffineParams(self.delta, self.zero_point, self.bits)
        codes = self.unpacked_codes()
        if self.orig_shape is not None and len(self.orig_shape) == 4:
            # packed conv codes lie in the im2col (C_in*kh*kw, C_out)
            # order: back to HWIO, where the per-channel params broadcast
            kh, kw, ci, co = self.orig_shape
            codes = codes.reshape(ci, kh, kw, co).permute(1, 2, 0, 3)
        elif self.orig_shape is not None:
            codes = codes.reshape(self.orig_shape)
        return affine.dequantize_from_int(codes, p)

    @property
    def nbytes(self) -> int:
        """Codes + canonical affine params (the derived columns are not
        counted, as in the reference)."""
        return (self.codes.numel() * self.codes.element_size()
                + self.delta.numel() * 4 + self.zero_point.numel() * 4)


# ---------------------------------------------------------------------------
# tree helpers (nested dicts / tuples / lists; PackedTensor is one node)
# ---------------------------------------------------------------------------

def tree_map(fn: Callable[..., Any], tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` to every leaf of ``tree`` (and the matching leaves of
    the ``rest`` trees, of the same structure); dicts, ``NamedTuple``s,
    tuples and lists are nodes, a ``PackedTensor`` is one leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_tensors(tree: Tree) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(path, tensor)`` of every tensor, dict keys in sorted order and a
    ``PackedTensor``'s tensors in field order (the reference's flatten
    order)."""
    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                yield from walk(node[k], f"{path}/{k}")
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                yield from walk(v, f"{path}/{i}")
        elif isinstance(node, PackedTensor):
            for f in PackedTensor.TENSOR_FIELDS:
                yield from walk(getattr(node, f), f"{path}.{f}")
        elif isinstance(node, torch.Tensor):
            yield path or "<root>", node
    yield from walk(tree, "")


def tree_flatten(tree: Tree) -> Tuple[list, list]:
    """``(paths, leaves)`` of every leaf, in ``tree_tensors``' order: dict
    keys sorted, ``NamedTuple`` fields, sequence items, a
    ``PackedTensor``'s tensors by field; ``None`` holds no leaf.  A leaf
    is anything else (a tensor, a Python number).  Paths read like
    ``.extras.replay['obs'][0]``."""
    paths, leaves = [], []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}[{k!r}]")
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for f, v in zip(node._fields, node):
                walk(v, f"{path}.{f}")
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")
        elif isinstance(node, PackedTensor):
            for f in PackedTensor.TENSOR_FIELDS:
                walk(getattr(node, f), f"{path}.{f}")
        else:
            paths.append(path or "<root>")
            leaves.append(node)
    walk(tree, "")
    return paths, leaves


def tree_unflatten(template: Tree, leaves: list) -> Tree:
    """``template`` with its leaves replaced, in ``tree_flatten``'s order,
    by ``leaves``; a ``PackedTensor`` keeps the template's ``bits`` and
    ``orig_shape``.  Raises ``ValueError`` unless the counts agree."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (tuple, list)):
            return type(node)(build(v) for v in node)
        if isinstance(node, PackedTensor):
            return dataclasses.replace(node, **{
                f: build(getattr(node, f))
                for f in PackedTensor.TENSOR_FIELDS})
        return next(it)
    try:
        out = build(template)
    except StopIteration:
        raise ValueError(f"{len(leaves)} leaves for a template of more")
    if next(it, None) is not None:
        raise ValueError(f"{len(leaves)} leaves for a template of fewer")
    return out


def tree_to(tree: Tree, device) -> Tree:
    """Copy every tensor of the tree (packed ones included) to ``device``."""
    def one(leaf):
        if isinstance(leaf, PackedTensor):
            return dataclasses.replace(leaf, **{
                f: getattr(leaf, f).to(device)
                for f in PackedTensor.TENSOR_FIELDS})
        if isinstance(leaf, torch.Tensor):
            return leaf.to(device)
        return leaf
    return tree_map(one, tree)


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def _is_weight(leaf: Any) -> bool:
    return (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
            and leaf.dim() >= 2)


def _axis_for(leaf: torch.Tensor, config: QuantConfig) -> Optional[int]:
    """The quantization axis: a conv kernel's output channels (HWIO, the
    last axis) under ``per_axis_conv``, else ``None`` (per tensor)."""
    if config.per_axis_conv and leaf.dim() == 4:
        return leaf.dim() - 1
    return None


def _pack_leaf(leaf: torch.Tensor, bits: int,
               axis: Optional[int] = None) -> PackedTensor:
    """Quantize one weight (per tensor, or per ``axis``) into the kernel
    layout."""
    codes, p = affine.quantize_to_int(leaf, bits, axis)
    n = leaf.shape[-1]
    col_scale = p.delta.reshape(-1).expand(n).clone()
    col_zero = p.zero_point.reshape(-1).expand(n).clone()
    if bits > 4:
        return PackedTensor(codes, p.delta, p.zero_point, bits,
                            col_scale, col_zero)
    # sub-8-bit: the GEMM's (K, N) layout, a conv kernel in the im2col
    # (C_in, kh, kw) feature order, then two codes a byte along K
    if leaf.dim() == 4:
        kh, kw, ci, co = codes.shape
        codes = codes.permute(2, 0, 1, 3).reshape(ci * kh * kw, co)
    else:
        codes = codes.reshape(-1, n)
    return PackedTensor(affine.pack_int4(codes), p.delta, p.zero_point,
                        bits, col_scale, col_zero,
                        orig_shape=tuple(leaf.shape))


def ptq_simulate(params: Tree, config: QuantConfig) -> Tree:
    """Quantize-dequantize every weight (Algorithm 1's Q applied to M).

    Dense weights are quantized per tensor over their own range
    (``affine.ptq_tensor``, kernel B5 on the card), conv kernels per
    output channel (plain torch), or either is round-tripped through
    fp16; biases pass through.  A config that is not PTQ returns
    ``params`` as they are.
    """
    if not config.is_ptq:
        return params

    def one(leaf):
        if not _is_weight(leaf):
            return leaf
        if config.mode == QuantMode.PTQ_FP16:
            return affine.fp16_quantize(leaf)
        return affine.ptq_tensor(leaf, config.bits, _axis_for(leaf, config))
    return tree_map(one, params)


def ptq_pack(params: Tree, config: QuantConfig) -> Tree:
    """Pack weights into int storage; non-weights pass through unchanged."""
    if config.mode != QuantMode.PTQ_INT:
        raise ValueError(f"packing is for int PTQ, got {config.mode}")
    return tree_map(lambda leaf: _pack_leaf(
        leaf, config.bits, _axis_for(leaf, config))
        if _is_weight(leaf) else leaf, params)


def ptq_unpack(packed: Tree) -> Tree:
    """Dequantize every ``PackedTensor`` back to a float32 weight."""
    return tree_map(lambda leaf: leaf.dequantize()
                    if isinstance(leaf, PackedTensor) else leaf, packed)


def tree_nbytes(params: Tree) -> int:
    """Parameter-memory footprint (the paper's 4x memory claim)."""
    total = 0
    for leaf in _leaves(params):
        if isinstance(leaf, PackedTensor):
            total += leaf.nbytes
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total


def _leaves(tree: Tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out
