"""The pod dry-run in the port, on the CPU.

* The in-place Adam update (``adam_update_``, the LM step's donated
  params and moments) is bitwise the functional one and hands back its
  inputs' storages: float32, 8-bit, bfloat16 params, weight decay, and a
  ``grad_accum`` 4 train step against the same step composed from the
  functional update.
* ``trace_analysis``: collective bytes of a hand-built DTensor program on
  a fake group, exactly (the reference's ``test_hlo_collective_trip_
  weighting``), and ``summarize_memory``'s arithmetic
  (``test_hlo_memory_summary``).
* ``lower_step`` at 256 and 512 fake ranks on reduced configs: each
  rank's argument bytes are the local shards the reference's specs imply
  (ceil division per split dim); the counts carried from three depths
  equal a whole trace's (the peak, carried along a line, is an
  estimate); the xLSTM time loop traced for one step and counted as S
  equals the loop traced step by step.
* The fake trace against a real run: at world 1 a reduced config's trace
  counts the FLOPs that ``FlopCounterMode`` counts on the real CPU step
  (the kernels' plain versions hidden from it and counted by their
  formulas), for train, prefill and decode; B4's query rows split over
  ``model`` (each shard at its own offset) and B3 on a gathered cache,
  run shard by shard and reassembled, hold the unsharded output; a
  world-1 gloo mesh step is bitwise the no-mesh step.
* ``ShardedBatcher`` over ``("pod", "data")`` jointly.
* The dry-run CLI on ``xlstm-125m x decode_32k --device cpu``.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import base as jcfgs
from repro.models import transformer as jtr
from repro_torch.configs import base as cfgs
from repro_torch.core import ptq
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.launch import trace_analysis as ta
from repro_torch.optim import adam

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"train": cfgs.InputShape("t", 32, 64, "train"),
         "prefill": cfgs.InputShape("p", 32, 64, "prefill"),
         "decode": cfgs.InputShape("d", 32, 64, "decode")}


# ---------------------------------------------------------------------------
# the in-place Adam update
# ---------------------------------------------------------------------------

def _tree(gen, dtype=torch.float32):
    return {"a": {"w": torch.randn((4, 512), generator=gen).to(dtype)},
            "b": torch.randn((7,), generator=gen).to(dtype)}


@pytest.mark.parametrize("eightbit,dtype,wd", [
    (False, torch.float32, 0.0), (True, torch.float32, 0.0),
    (False, torch.bfloat16, 0.0), (True, torch.bfloat16, 0.1),
    (False, torch.float32, 0.01)])
def test_inplace_adam_is_the_functional_update(eightbit, dtype, wd):
    cfg = adam.AdamConfig(lr=1e-2, eightbit=eightbit, weight_decay=wd)
    gen = torch.Generator().manual_seed(3)
    p = _tree(gen, dtype)
    st = adam.adam_init(p, cfg)
    fp, fst = ptq.tree_map(torch.clone, p), adam.adam_init(p, cfg)
    for i in range(3):
        g = ptq.tree_map(lambda t: torch.randn(t.shape, generator=gen)
                         .to(t.dtype), p)
        ptrs = [t.data_ptr() for _, t in ptq.tree_tensors((p, st))]
        fp, fst, fstats = adam.adam_update(g, fst, fp, cfg)
        p2, st2, stats = adam.adam_update_(g, st, p, cfg)
        assert p2 is p and st2 is st
        assert [t.data_ptr() for _, t in ptq.tree_tensors((p, st))] == ptrs
        for (k, x), (_, y) in zip(ptq.tree_tensors((p, st)),
                                  ptq.tree_tensors((fp, fst))):
            assert x.dtype == y.dtype and torch.equal(x, y), (i, k)
        assert torch.equal(stats["grad_norm"], fstats["grad_norm"])


def test_train_step_updates_in_place_bitwise_at_grad_accum_four():
    """The LM step at ``grad_accum`` 4 with 8-bit moments returns the
    params and state it was given, bitwise what the functional update
    makes of the same gradients."""
    cfg = dataclasses.replace(cfgs.get_reduced("h2o-danube-1.8b"),
                              grad_accum=4, optimizer_8bit=True)
    from repro_torch.models import transformer
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (8, 16), generator=gen)
             for k in ("tokens", "labels")}
    step, acfg = steps.make_train_step(cfg)
    opt = adam.adam_init(params, acfg)
    want_p, want_o = ptq.tree_map(torch.clone, params), \
        adam.adam_init(params, acfg)
    grads = None
    for i in range(4):
        micro = {k: v.reshape((4, 2) + v.shape[1:])[i]
                 for k, v in batch.items()}
        _, _, g = steps.value_and_grad(cfg, want_p, micro, {},
                                       want_o.step)
        grads = g if grads is None else ptq.tree_map(torch.add, grads, g)
    grads = ptq.tree_map(lambda g: g / 4, grads)
    want_p, want_o, _ = adam.adam_update(grads, want_o, want_p, acfg)
    ptrs = [t.data_ptr() for _, t in ptq.tree_tensors((params, opt))]
    new_p, new_o, _, _ = step(params, opt, batch, {})
    assert new_p is params and new_o is opt
    assert [t.data_ptr() for _, t in ptq.tree_tensors((params, opt))] \
        == ptrs
    for (k, x), (_, y) in zip(ptq.tree_tensors((new_p, new_o)),
                              ptq.tree_tensors((want_p, want_o))):
        assert torch.equal(x, y), k


# ---------------------------------------------------------------------------
# trace analysis
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_group():
    def start(world):
        mesh_lib.init_fake_group(world)
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


def test_collective_stats_of_a_known_program(fake_group):
    """An all-gather of an (8, 4) float32 split four ways and an
    all-reduce of a partial (8, 4): 128 result bytes each."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    fake_group(4)
    mesh = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("data",))
    with FakeTensorMode():
        a, b = torch.empty(2, 4), torch.empty(8, 4)
    x = DTensor.from_local(a, mesh, [Shard(0)], run_check=False)
    y = DTensor.from_local(b, mesh, [Partial()], run_check=False)
    counter = ta.TraceCounter()
    with counter.counting():
        x.redistribute(mesh, [Replicate()])
        y.redistribute(mesh, [Replicate()])
    stats = ta.collective_stats(counter)
    assert stats == {"all-gather": 128.0, "all-reduce": 128.0,
                     "reduce-scatter": 0.0, "all-to-all": 0.0,
                     "collective-permute": 0.0, "total": 256.0}
    assert counter.collective_calls == 2


def test_memory_summary():
    out = ta.summarize_memory({
        "argument_size_in_bytes": 100.0, "output_size_in_bytes": 50.0,
        "temp_size_in_bytes": 200.0, "generated_code_size_in_bytes": 1.0,
        "alias_size_in_bytes": 50.0})
    assert out["total_nonalias_bytes"] == 300.0


def _ceil_bytes(shape, spec, sizes, itemsize):
    n = 1
    for d, e in zip(shape, spec):
        for name in ((e,) if isinstance(e, str) else e or ()):
            d = -(-d // sizes[name])
        n *= d
    return n * itemsize


@pytest.mark.parametrize("multi_pod", [False, True], ids=["256", "512"])
def test_argument_bytes_are_the_reference_specs_shards(fake_group,
                                                       multi_pod):
    """Train (float32 masters and moments, the batch) of the reduced
    danube: each rank's argument bytes are the shards of the reference's
    param specs, ceil-divided by the mesh dims each dim is split over;
    the in-place update aliases params and moments."""
    import jax
    from jax.sharding import PartitionSpec
    fake_group(mesh_lib.n_chips(multi_pod))
    mesh = mesh_lib.make_production_mesh(multi_pod, device="cpu")
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    cfg = cfgs.get_reduced("h2o-danube-1.8b")
    shape = SMALL["train"]
    rec, kind = steps.lower_step(cfg, shape, mesh, multi_pod=multi_pod,
                                 device="cpu")
    jcfg = jcfgs.get_reduced("h2o-danube-1.8b")
    jspecs = jax.tree_util.tree_leaves(
        jtr.partition_specs(jcfg, multi_pod=multi_pod),
        is_leaf=lambda x: isinstance(x, PartitionSpec))
    shapes = [t.shape for t in steps.leaves(steps.param_sds(cfg))]
    params = sum(_ceil_bytes(s, sp, sizes, 4)
                 for s, sp in zip(shapes, jspecs))
    data = ("pod", "data") if multi_pod else ("data",)
    batch = 2 * _ceil_bytes((shape.global_batch, shape.seq_len),
                            (data, None), sizes, 4)
    mem = rec["memory"]
    assert kind == "train"
    assert mem["argument_size_in_bytes"] == 3 * params + batch + 4
    assert mem["alias_size_in_bytes"] == 3 * params + 4
    assert rec["kernels"] == {"flash_attention": 2 * cfg.n_layers}


def test_counts_carried_from_three_depths_are_a_whole_traces(fake_group):
    """Operations, bytes, collectives, kernel calls and the argument,
    output and alias bytes carried from one, two and three layers to
    four equal a trace of all four; the peak is carried along a line."""
    fake_group(256)
    mesh = mesh_lib.make_production_mesh(False, device="cpu")
    cfg = dataclasses.replace(cfgs.get_reduced("h2o-danube-1.8b"),
                              n_layers=4)
    shape = SMALL["train"]
    carried, _ = steps.lower_step(cfg, shape, mesh, device="cpu",
                                  depths=(1, 2, 3))
    whole, _ = steps.lower_step(cfg, shape, mesh, device="cpu")
    assert carried["depths"] == [1, 2, 3] and whole["depths"] is None
    for key in ("flops", "bytes_accessed", "collective_breakdown",
                "kernels"):
        assert carried[key] == pytest.approx(whole[key], rel=1e-12), key
    for key in ("argument_size_in_bytes", "output_size_in_bytes",
                "alias_size_in_bytes"):
        assert carried["memory"][key] == whole["memory"][key], key
    assert carried["temp_carried"] == "linear from depths 2 and 3"


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_time_loop_traced_once_counts_every_step(fake_group, monkeypatch,
                                                 kind):
    """The xLSTM blocks' time loop traced for one step and counted as S
    counts the operations and collectives of the loop traced step by
    step exactly, and its peak within 0.1% (the one step's saved
    activations times S stand in for the loop's); bytes accessed differ
    by the per-step slicing and stacking alone."""
    from repro_torch.models import recurrent
    fake_group(256)
    mesh = mesh_lib.make_production_mesh(False, device="cpu")
    cfg = dataclasses.replace(cfgs.get("xlstm-125m"), n_layers=2)
    shape = dataclasses.replace(SMALL[kind], seq_len=8)
    once, _ = steps.lower_step(cfg, shape, mesh, device="cpu")
    monkeypatch.setattr(recurrent, "FakeTensor", type("Never", (), {}))
    every, _ = steps.lower_step(cfg, shape, mesh, device="cpu")
    assert once["flops"] == every["flops"] > 0
    assert once["collective_breakdown"] == every["collective_breakdown"]
    mo, me = once["memory"], every["memory"]
    for key in ("argument_size_in_bytes", "output_size_in_bytes",
                "alias_size_in_bytes"):
        assert mo[key] == me[key], key
    assert mo["temp_size_in_bytes"] == pytest.approx(
        me["temp_size_in_bytes"], rel=1e-3)
    assert once["bytes_accessed"] == pytest.approx(every["bytes_accessed"],
                                                   rel=2e-2)


@pytest.mark.parametrize("arch,kind", [
    ("mixtral-8x7b", "train"), ("mixtral-8x7b", "decode"),
    ("xlstm-125m", "decode"), ("recurrentgemma-2b", "prefill"),
    ("whisper-tiny", "decode")])
def test_every_family_traces_on_the_pod_mesh(fake_group, arch, kind):
    """The MoE, xLSTM, RG-LRU and encoder / cross-attention families
    trace on the 512-rank mesh at reduced widths: the layout's splits the
    reference's constraints ask for, and those DTensor cannot take
    gathered (an uneven capacity, a batch of one, a split sequence)."""
    fake_group(512)
    mesh = mesh_lib.make_production_mesh(True, device="cpu")
    cfg = cfgs.get_reduced(arch)
    shape = SMALL[kind] if kind != "decode" else \
        cfgs.InputShape("d1", 32, 1, "decode")
    rec, got = steps.lower_step(cfg, shape, mesh, multi_pod=True,
                                device="cpu")
    assert got == kind and rec["flops"] > 0
    assert rec["memory"]["argument_size_in_bytes"] > 0
    if kind == "train":
        assert rec["memory"]["alias_size_in_bytes"] > 0


# ---------------------------------------------------------------------------
# the fake trace against real runs
# ---------------------------------------------------------------------------

def _world_one_mesh():
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", torch.zeros((1, 1), dtype=torch.long),
                      mesh_dim_names=("data", "model"))


def _real_flops(monkeypatch, fn):
    """FLOPs of ``fn()`` on real CPU tensors: ``FlopCounterMode``'s, the
    kernels' plain versions hidden from it and counted by the kernels'
    formulas instead (as the trace counts them)."""
    from torch.utils._python_dispatch import _disable_current_modes
    from torch.utils.flop_counter import FlopCounterMode
    extra = []
    orig = ops._flash_local

    def hidden(q, k, v, causal, window, softcap, scale, q_offset):
        b, s, h, d = q.shape
        extra.append(4.0 * d * b * h * ops.flash_pairs(
            s, k.shape[1], causal, window, q_offset))
        with _disable_current_modes():
            return orig(q, k, v, causal, window, softcap, scale, q_offset)
    monkeypatch.setattr(ops, "_flash_local", hidden)
    with FlopCounterMode(display=False) as fc:
        fn()
    monkeypatch.undo()
    return fc.get_total_flops() + sum(extra)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_fake_trace_counts_the_real_runs_flops(fake_group, monkeypatch,
                                               kind):
    from repro_torch.models import transformer
    fake_group(1)
    cfg = dataclasses.replace(cfgs.get_reduced("h2o-danube-1.8b"),
                              n_layers=1)
    shape = SMALL[kind]
    rec, _ = steps.trace_step(cfg, shape, _world_one_mesh(), device="cpu")
    gen = torch.Generator().manual_seed(0)
    dtype = torch.float32 if kind == "train" else torch.bfloat16
    params = transformer.init_params(cfg, gen, "cpu", dtype=dtype)
    b, s = shape.global_batch, shape.seq_len
    tok = torch.randint(0, cfg.vocab, (b, s if kind != "decode" else 1),
                        generator=gen, dtype=torch.int32)
    if kind == "train":
        step, acfg = steps.make_train_step(cfg)
        opt = adam.adam_init(params, acfg)
        batch = {"tokens": tok, "labels": tok}

        def run():
            step(params, opt, batch, {})
    elif kind == "prefill":
        step = steps.make_prefill_step(cfg)

        def run():
            step(params, {"tokens": tok})
    else:
        step = steps.make_serve_step(cfg)
        caches = transformer.init_caches(cfg, b, s, device="cpu",
                                         dtype=torch.bfloat16)

        def run():
            step(params, caches, {"tokens": tok}, s - 1)
    assert rec["flops"] == _real_flops(monkeypatch, run)
    assert rec["flops"] > 0


def test_shape_only_branch_takes_fake_tensors_alone(monkeypatch):
    """A real tensor runs the plain version and reports nothing to the
    trace's sink; a fake one returns an empty output of the kernel's
    shape and reports the bound formulas' operations and bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    seen = []
    monkeypatch.setattr(ops, "trace_sink", lambda *a: seen.append(a))
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((1, 8, 4, 16), generator=gen)
    k = torch.randn((1, 8, 2, 16), generator=gen)
    x = torch.randn((3, 5), generator=gen)
    real = ops.flash_attention(q, k, k)
    ops.fake_quant(x)
    assert seen == [] and torch.isfinite(real).all()
    with FakeTensorMode() as mode:
        fq, fk, fx = (mode.from_tensor(t) for t in (q, k, x))
        out = ops.flash_attention(fq, fk, fk)
        ops.fake_quant(fx)
    assert out.shape == real.shape and out.dtype == torch.float32
    pairs = 8 * 9 // 2                       # causal, S = T = 8
    assert seen == [("flash_attention", 4.0 * 16 * pairs * 4,
                     4.0 * (2 * 8 * 4 * 16 + 2 * 8 * 2 * 16)),
                    ("fake_quant", 60.0, 120.0)]


@pytest.mark.parametrize("causal,window,softcap,s,t", [
    (True, None, None, 64, 64), (True, 24, None, 64, 96),
    (True, None, 30.0, 48, 48), (False, None, None, 32, 40)])
def test_split_query_rows_hold_the_whole_attention(causal, window, softcap,
                                                   s, t):
    """B4's body under a ``model`` split of the query rows: each shard at
    its own query offset, reassembled, holds the unsplit output."""
    gen = torch.Generator().manual_seed(s + t)
    q = torch.randn((2, s, 4, 16), generator=gen)
    k = torch.randn((2, t, 2, 16), generator=gen)
    v = torch.randn((2, t, 2, 16), generator=gen)
    whole = ops._flash_local(q, k, v, causal, window, softcap, None, None)
    m = 4
    rows = -(-s // m)
    parts = [ops._flash_local(q[:, r0:r0 + rows], k, v, causal, window,
                              softcap, None, r0 + t - s)
             for r0 in range(0, s, rows)]
    torch.testing.assert_close(torch.cat(parts, 1), whole, rtol=0,
                               atol=1e-6)


def test_gathered_cache_shards_hold_the_whole_decode():
    """B3 on a cache whose context is gathered, the batch split kept:
    each batch shard over the whole context, reassembled, holds the
    unsplit output."""
    from repro_torch.core import affine
    gen = torch.Generator().manual_seed(7)
    b, kv, g, t, dh = 4, 2, 3, 40, 16
    q = torch.randn((b, kv, g, dh), generator=gen)
    kc, ks = affine.quantize_symmetric(torch.randn((b, kv, t, dh),
                                                   generator=gen))
    vc, vs = affine.quantize_symmetric(torch.randn((b, kv, t, dh),
                                                   generator=gen))
    whole = ops.int8_cache_attention(q, kc, ks, vc, vs, 29, window=None)
    parts = [ops.int8_cache_attention(q[i:i + 2], kc[i:i + 2],
                                      ks[i:i + 2], vc[i:i + 2],
                                      vs[i:i + 2], 29)
             for i in (0, 2)]
    torch.testing.assert_close(torch.cat(parts), whole, rtol=0, atol=1e-6)


def test_world_one_gloo_mesh_step_is_the_plain_step(tmp_path):
    """A train step and a prefill on a world-1 gloo mesh (params and
    batch DTensors with the reference's placements) are bitwise the
    no-mesh ones; the group is destroyed after."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import common, transformer
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = DeviceMesh("cpu", torch.zeros((1, 1), dtype=torch.long),
                          mesh_dim_names=("data", "model"))
        cfg = dataclasses.replace(cfgs.get_reduced("h2o-danube-1.8b"),
                                  n_layers=1)
        specs = steps.param_shardings(cfg, False)
        tok = torch.randint(0, cfg.vocab, (4, 32),
                            generator=torch.Generator().manual_seed(0))
        batch = {"tokens": tok, "labels": tok}
        out = {}
        for sharded in (False, True):
            p = transformer.init_params(
                cfg, torch.Generator().manual_seed(1), "cpu")
            b = batch
            if sharded:
                p = ptq.tree_map(lambda t, s: DTensor.from_local(
                    t, mesh, common.placements(s, mesh), run_check=False),
                    p, specs)
                b = {k: DTensor.from_local(v, mesh, common.placements(
                    ("data", None), mesh), run_check=False)
                    for k, v in batch.items()}
            step, acfg = steps.make_train_step(cfg)
            with implicit_replication():
                p, _, _, m = step(p, adam.adam_init(p, acfg), b, {})
                logits = steps.make_prefill_step(cfg)(p, {"tokens": tok})

            def loc(t):
                return t.to_local() if isinstance(t, DTensor) else t
            out[sharded] = ([loc(t) for _, t in ptq.tree_tensors(p)],
                            loc(m["loss"]), loc(logits))
        (pa, la, ga), (pb, lb, gb) = out[False], out[True]
        assert all(torch.equal(x, y) for x, y in zip(pa, pb))
        assert torch.equal(la, lb) and torch.equal(ga, gb)
    finally:
        dist.destroy_process_group()


def test_sharded_batcher_splits_pod_and_data_jointly(fake_group):
    """``multi_pod``: the batch over ``("pod", "data")`` as one split, the
    pod major: rank 0 of the 512-rank mesh takes rows 0-1 of 64, and the
    rank at pod 1, data 3 rows 38-39."""
    from repro_torch.data.pipeline import ShardedBatcher
    fake_group(512)
    mesh = mesh_lib.make_production_mesh(True, device="cpu")
    batch = {"x": np.arange(64).reshape(64, 1)}
    got = ShardedBatcher(mesh, device="cpu", multi_pod=True).put(batch)
    assert got["x"][:, 0].tolist() == [0, 1]

    class At:
        mesh_dim_names = ("pod", "data", "model")

        def size(self, i):
            return (2, 16, 16)[i]

        def get_local_rank(self, name):
            return dict(pod=1, data=3, model=5)[name]
    got = ShardedBatcher(At(), device="cpu", multi_pod=True).put(batch)
    assert got["x"][:, 0].tolist() == [38, 39]
    got = ShardedBatcher(At(), device="cpu").put(batch)
    assert got["x"][:, 0].tolist() == [12, 13, 14, 15]


def test_dryrun_cli_writes_the_reference_record(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "xlstm-125m", "--shape", "decode_32k", "--device", "cpu",
         "--out", str(tmp_path)], capture_output=True, text=True, env=env,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "All dry-runs traced successfully" in out.stdout
    rec = json.loads((tmp_path / "xlstm-125m__decode_32k__1pod.json")
                     .read_text())
    reference = {"arch", "shape", "kind", "variant", "multi_pod", "devices",
                 "flops", "bytes_accessed", "collective_bytes",
                 "collective_breakdown", "memory", "n_params",
                 "n_active_params", "tokens"}
    assert reference <= set(rec) and "trace_s" in rec
    assert (rec["kind"], rec["devices"], rec["tokens"]) == \
        ("decode", 256, 128)
    assert rec["depths"] == [1, 2, 3]       # the default: carried counts
    assert set(rec["collective_breakdown"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute", "total"}
    assert rec["memory"]["alias_size_in_bytes"] > 0
    assert np.isfinite(rec["flops"]) and rec["flops"] > 0
