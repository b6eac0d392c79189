"""The port's pod layout against the reference's, exactly: for every config
x input shape x mesh (one pod, two),

* ``transformer.partition_specs`` leaf for leaf;
* ``launch.steps``' batch, optimizer (float32 and 8-bit) and cache
  shardings, as mesh-dim names, against the reference's
  ``PartitionSpec``s (its ``NamedSharding`` swapped for the bare spec in
  the test, so no 256-device JAX mesh is needed);
* the shape trees ``input_specs``, ``param_sds``, ``opt_sds`` and
  ``cache_sds`` (meta tensors) against the reference's
  ``ShapeDtypeStruct``s (``jax.eval_shape``: neither side allocates);
* ``resolve_arch_for_shape``'s config and variant.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfgs
from repro.launch import steps as jsteps
from repro.models import transformer as jtr
from repro.optim import adam as jadam
from repro_torch.configs import base as cfgs
from repro_torch.launch import steps
from repro_torch.models import attention, common
from repro_torch.optim import adam

NAMES = cfgs.names()
SHAPES = list(cfgs.INPUT_SHAPES)


def _entry(e):
    """A spec entry as one form: None, a name, or a tuple of names."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return e[0] if len(e) == 1 else e
    return e


def _jspec(spec):
    return tuple(_entry(e) for e in spec)


def _jleaves(tree):
    from jax.sharding import PartitionSpec
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))


def _tspec_leaves(tree):
    """Spec tuples of a port tree in the reference's flatten order."""
    out = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, adam.BlockQuantized):
            walk(node.codes)
            walk(node.scales)
        elif isinstance(node, (adam.AdamState, attention.KVCache)):
            for x in node:
                if x is not None:
                    walk(x)
        elif isinstance(node, list):
            for x in node:
                walk(x)
        else:
            out.append(tuple(_entry(e) for e in node))
    walk(tree)
    return out


@pytest.fixture
def bare_specs(monkeypatch):
    """The reference's shardings as bare ``PartitionSpec``s."""
    monkeypatch.setattr(jsteps, "NamedSharding", lambda mesh, spec: spec)


_J_PARAM_SDS = jsteps.param_sds


@functools.lru_cache(maxsize=None)
def _j_param_sds(name, dtype=None):
    return _J_PARAM_SDS(jcfgs.get(name), dtype=dtype)


def _same_shapes(jtree, ttree):
    want = [(tuple(x.shape), np.dtype(x.dtype).name)
            for x in jax.tree_util.tree_leaves(jtree)]
    got = [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for x in steps.leaves(ttree)]
    assert got == want
    assert all(x.device.type == "meta" for x in steps.leaves(ttree))


@pytest.mark.parametrize("multi_pod", [False, True], ids=["1pod", "2pod"])
@pytest.mark.parametrize("name", NAMES)
def test_partition_specs_match_reference(name, multi_pod):
    for shape_name in SHAPES:
        shape = cfgs.INPUT_SHAPES[shape_name]
        cfg, variant = steps.resolve_arch_for_shape(cfgs.get(name), shape)
        jcfg, jvariant = jsteps.resolve_arch_for_shape(
            jcfgs.get(name), jcfgs.INPUT_SHAPES[shape_name])
        assert variant == jvariant
        assert (cfg.sharding, cfg.long_context_window) == \
            (jcfg.sharding, jcfg.long_context_window)
        got = _tspec_leaves(transformer_specs(cfg, multi_pod))
        want = [_jspec(s) for s in _jleaves(
            jtr.partition_specs(jcfg, multi_pod=multi_pod))]
        assert got == want, (shape_name, multi_pod)


def transformer_specs(cfg, multi_pod):
    return steps.param_shardings(cfg, multi_pod)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["1pod", "2pod"])
@pytest.mark.parametrize("name", NAMES)
def test_batch_and_cache_shardings_match_reference(bare_specs, name,
                                                   multi_pod):
    for shape_name in SHAPES:
        shape = cfgs.INPUT_SHAPES[shape_name]
        jshape = jcfgs.INPUT_SHAPES[shape_name]
        cfg, _ = steps.resolve_arch_for_shape(cfgs.get(name), shape)
        jcfg, _ = jsteps.resolve_arch_for_shape(jcfgs.get(name), jshape)
        got = steps.batch_shardings(cfg, shape, multi_pod)
        want = jsteps.batch_shardings(jcfg, jshape, None, multi_pod)
        assert sorted(got) == sorted(want)
        for k in got:
            assert tuple(_entry(e) for e in got[k]) == _jspec(want[k]), k
        if shape.kind == "decode":
            got = _tspec_leaves(steps.cache_shardings(cfg, shape, multi_pod))
            want = [_jspec(s) for s in _jleaves(jsteps.cache_shardings(
                jcfg, jshape, None, multi_pod))]
            assert got == want, shape_name


@pytest.mark.parametrize("eightbit", [False, True], ids=["fp32", "8bit"])
@pytest.mark.parametrize("multi_pod", [False, True], ids=["1pod", "2pod"])
@pytest.mark.parametrize("name", NAMES)
def test_opt_shardings_match_reference(bare_specs, monkeypatch, name,
                                       multi_pod, eightbit):
    monkeypatch.setattr(jsteps, "param_sds",
                        lambda c, dtype=None: _j_param_sds(c.name, dtype))
    cfg, jcfg = cfgs.get(name), jcfgs.get(name)
    got = steps.opt_shardings(cfg, adam.AdamConfig(eightbit=eightbit),
                              multi_pod)
    want = jsteps.opt_shardings(jcfg, jadam.AdamConfig(eightbit=eightbit),
                                None, multi_pod)
    wl = [_jspec(s) for s in _jleaves(want)]
    assert _tspec_leaves(got) == wl
    if eightbit:
        q = got.m["embed"]["w"]
        assert q.shape == tuple(jcfg.vocab for _ in range(1)) + \
            (jcfg.d_model,)


@pytest.mark.parametrize("name", NAMES)
def test_shape_trees_match_reference(name):
    """``input_specs`` (every shape), ``param_sds`` (masters and compute
    dtype), ``opt_sds`` (float32 and 8-bit) and ``cache_sds`` (the
    decode shapes), shapes and dtypes leaf for leaf."""
    cfg, jcfg = cfgs.get(name), jcfgs.get(name)
    for shape_name in SHAPES:
        shape = cfgs.INPUT_SHAPES[shape_name]
        jshape = jcfgs.INPUT_SHAPES[shape_name]
        c, _ = steps.resolve_arch_for_shape(cfg, shape)
        jc, _ = jsteps.resolve_arch_for_shape(jcfg, jshape)
        _same_shapes(jsteps.input_specs(jc, jshape),
                     steps.input_specs(c, shape))
        if shape.kind == "decode":
            _same_shapes(jsteps.cache_sds(jc, jshape.global_batch,
                                          jshape.seq_len),
                         steps.cache_sds(c, shape.global_batch,
                                         shape.seq_len))
    _same_shapes(_j_param_sds(name), steps.param_sds(cfg))
    _same_shapes(_j_param_sds(name, jnp.bfloat16),
                 steps.param_sds(cfg, torch.bfloat16))
    for eightbit in (False, True):
        jo = jax.eval_shape(lambda p: jadam.adam_init(
            p, jadam.AdamConfig(eightbit=eightbit)), _j_param_sds(name))
        _same_shapes(jo, steps.opt_sds(cfg,
                                       adam.AdamConfig(eightbit=eightbit)))


def test_placements_and_constraint_without_a_mesh():
    """``placements`` names mesh dims in the mesh's order; a plain tensor
    passes ``with_constraint``, ``reshape`` and ``unsplit`` unchanged."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        ndim, mesh_dim_names = 3, ("pod", "data", "model")
    assert common.placements((("pod", "data"), None, "model"), Mesh()) == \
        [Shard(0), Shard(0), Shard(2)]
    assert common.placements((None, "data"), Mesh()) == \
        [Replicate(), Shard(1), Replicate()]
    with pytest.raises(KeyError):
        common.placements(("expert",), Mesh())
    x = torch.arange(12.0).reshape(3, 4)
    assert common.with_constraint(x, ("data", None)) is x
    assert common.unsplit(x, -1) is x
    assert torch.equal(common.reshape(x, 4, 3), x.reshape(4, 3))
