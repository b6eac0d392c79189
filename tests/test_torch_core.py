"""Port parity: the quantization core (``repro_torch.core``) vs the JAX one.

Same numpy inputs through ``repro.core`` (CPU) and ``repro_torch.core``;
codes and affine params must agree bitwise, including round-half ties,
all-zero tensors and odd K under int4 packing.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import affine as jaffine
from repro.core import ptq as jptq
from repro.core.qconfig import QuantConfig as JQuantConfig
from repro_torch.core import affine, ptq
from repro_torch.core.qconfig import QuantConfig, QuantMode


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    return {
        "normal": (rng.normal(size=shape) * 2.5).astype(np.float32),
        "positive": np.abs(rng.normal(size=shape)).astype(np.float32),
        "zeros": np.zeros(shape, np.float32),
        # values on exact x.5 multiples of delta = 8/256: round-half ties
        "ties": ((rng.integers(-128, 128, size=shape) + 0.5)
                 * (8.0 / 256)).astype(np.float32),
    }


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("kind", ["normal", "positive", "zeros", "ties"])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_to_int_bitwise(kind, bits):
    x = _inputs(bits, (13, 7))[kind]
    jq, jp = jaffine.quantize_to_int(jnp.asarray(x), bits)
    tq, tp = affine.quantize_to_int(torch.from_numpy(x), bits)
    assert tq.dtype == torch.int8
    _eq(jq, tq.numpy())
    _eq(jp.delta, tp.delta.numpy())
    _eq(jp.zero_point, tp.zero_point.numpy())


@pytest.mark.parametrize("kind", ["normal", "positive", "zeros", "ties"])
def test_calibration_and_static_requant_bitwise(kind):
    x = _inputs(7, (21, 9))[kind]
    jp = jaffine.calibration_params(jnp.asarray(x), 8)
    tp = affine.calibration_params(torch.from_numpy(x), 8)
    _eq(jp.delta, tp.delta.numpy())
    _eq(jp.zero_point, tp.zero_point.numpy())
    # static requant of another batch with those params
    y = _inputs(8, (21, 9))["normal"] * 3
    _eq(jaffine.quantize_with_params(jnp.asarray(y), jp),
        affine.quantize_with_params(torch.from_numpy(y), tp).numpy())
    # with params from the same tensor it is the dynamic quantizer
    _eq(affine.quantize_to_int(torch.from_numpy(x), 8)[0],
        affine.quantize_with_params(torch.from_numpy(x), tp))


@pytest.mark.parametrize("k", [1, 2, 7, 16, 33])
def test_pack_unpack_int4_bitwise(k):
    codes = np.random.default_rng(k).integers(-8, 8, size=(k, 6)
                                              ).astype(np.int8)
    jpk = jaffine.pack_int4(jnp.asarray(codes))
    tpk = affine.pack_int4(torch.from_numpy(codes))
    assert tuple(tpk.shape) == ((k + 1) // 2, 6) and tpk.dtype == torch.int8
    _eq(jpk, tpk.numpy())
    _eq(affine.unpack_int4(tpk, k), codes)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("shape", [(9, 16), (33, 5), (1, 3)])
def test_ptq_pack_bitwise(bits, shape):
    x = _inputs(shape[0], shape)["normal"]
    b = np.arange(shape[1], dtype=np.float32)
    jtree = jptq.ptq_pack({"fc0": {"w": jnp.asarray(x),
                                   "b": jnp.asarray(b)}},
                          JQuantConfig.ptq_int(bits))
    ttree = ptq.ptq_pack({"fc0": {"w": torch.from_numpy(x),
                                  "b": torch.from_numpy(b)}},
                         QuantConfig.ptq_int(bits))
    jw, tw = jtree["fc0"]["w"], ttree["fc0"]["w"]
    assert isinstance(tw, ptq.PackedTensor) and tw.bits == bits
    for field in ("codes", "delta", "zero_point", "col_scale", "col_zero"):
        _eq(getattr(jw, field), getattr(tw, field).numpy())
    assert tw.orig_shape == jw.orig_shape
    _eq(jtree["fc0"]["b"], ttree["fc0"]["b"].numpy())
    assert ptq.tree_nbytes(ttree) == jptq.tree_nbytes(jtree)
    _eq(jptq.ptq_unpack(jtree)["fc0"]["w"],
        ptq.ptq_unpack(ttree)["fc0"]["w"].numpy())


def test_ptq_pack_rejects_other_modes_and_conv():
    w = {"w": torch.ones(3, 3, 2, 4)}
    with pytest.raises(ValueError):
        ptq.ptq_pack(w, QuantConfig(mode=QuantMode.NONE))
    # a conv kernel packs per output channel (bitwise against JAX in
    # tests/test_torch_conv.py), or per tensor without per_axis_conv
    packed = ptq.ptq_pack(w, QuantConfig.ptq_int(8))["w"]
    assert tuple(packed.delta.shape) == (1, 1, 1, 4)
    per_tensor = ptq.ptq_pack(w, dataclasses.replace(
        QuantConfig.ptq_int(8), per_axis_conv=False))["w"]
    assert per_tensor.delta.dim() == 0
    assert torch.equal(packed.dequantize(),
                       affine.ptq_tensor(w["w"], 8, axis=3))


def test_tree_to_and_tensors_cover_packed_fields():
    tree = ptq.ptq_pack({"out": {"w": torch.randn(5, 3),
                                 "b": torch.zeros(3)}},
                        QuantConfig.ptq_int(4))
    moved = ptq.tree_to(tree, "cpu")
    paths = [p for p, _ in ptq.tree_tensors(moved)]
    assert paths == ["/out/b", "/out/w.codes", "/out/w.delta",
                     "/out/w.zero_point", "/out/w.col_scale",
                     "/out/w.col_zero"]
    assert moved["out"]["w"].orig_shape == (5, 3)
