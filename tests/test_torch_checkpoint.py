"""The port's checkpoints (``repro_torch.checkpoint``), the cases of
``tests/test_checkpoint.py`` on the port's containers.

* The single-file layer: writable loaded leaves, ``ValueError`` with one
  line a differing leaf, tolerant ``latest_step``, the orphan sweep, and
  a torn file refused by its checksum.
* Round trips of what training saves: fp32 params, packed int8 / int4
  caches (about 4x smaller on disk than the fp32 params), the sum-tree
  replay, Adam's state, the KV-cache actor state, an actor-learner state
  with its host counter; replay snapshots of every layout.
* ``CheckpointManager``: the manifest, retention, validated restores,
  saving a step again, the torn-data refusal.
* ``AsyncCheckpointer``: commits in order, the host copy taken at the
  call, writer errors raised on the next call.
* A crash between staging and the rename leaves the previous step
  loadable, and the next save sweeps the debris.

No JAX here: the checkpoint format is the port's own.
"""
import json
import os

import pytest
import torch

from repro_torch import checkpoint as ck
from repro_torch.checkpoint import manager as mgr_lib
from repro_torch.core.ptq import tree_flatten
from repro_torch.rl import actor_learner, actorq, dqn
from repro_torch.rl import buffer as rb
from repro_torch.rl.envs import make as make_env
from repro_torch.rl.networks import make_network


def _assert_tree_equal(a, b):
    pa, la = tree_flatten(a)
    pb, lb = tree_flatten(b)
    assert pa == pb
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device
            assert torch.equal(x, y)
        else:
            assert type(x) is type(y) and x == y


# ---------------------------------------------------------------------------
# the single-file layer
# ---------------------------------------------------------------------------

def test_loaded_leaves_are_writeable(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    path = ck.save_checkpoint(str(tmp_path / "t.bin"), tree)
    loaded = ck.load_checkpoint(path, tree)
    loaded["w"][0, 0] = 42.0
    loaded["w"].add_(1.0)
    assert float(loaded["w"][0, 0]) == 43.0
    assert float(tree["w"][0, 0]) == 0.0


def test_load_rejects_wrong_shape_with_detail(tmp_path):
    tree = {"a": torch.zeros((2, 3)), "b": torch.zeros(4, dtype=torch.int32)}
    path = ck.save_checkpoint(str(tmp_path / "t.bin"), tree)
    bad = {"a": torch.zeros((3, 2)), "b": torch.zeros(4, dtype=torch.int32)}
    with pytest.raises(ValueError, match=r"\['a'\].*\(2, 3\).*\(3, 2\)"):
        ck.load_checkpoint(path, bad)


def test_load_rejects_wrong_dtype_and_count(tmp_path):
    tree = {"a": torch.zeros(2)}
    path = ck.save_checkpoint(str(tmp_path / "t.bin"), tree)
    with pytest.raises(ValueError, match="<i4"):
        ck.load_checkpoint(path, {"a": torch.zeros(2, dtype=torch.int32)})
    with pytest.raises(ValueError, match="leaf count"):
        ck.load_checkpoint(path, {"a": torch.zeros(2), "b": torch.zeros(2)})


def test_load_refuses_a_torn_file(tmp_path):
    tree = {"a": torch.arange(64, dtype=torch.float32)}
    path = ck.save_checkpoint(str(tmp_path / "t.bin"), tree)
    raw = bytearray(open(path, "rb").read())
    raw[-5] ^= 0xFF                                  # one flipped byte
    open(path, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="checksum"):
        ck.load_checkpoint(path, tree)
    open(path, "wb").write(bytes(raw[:40]))          # cut short
    with pytest.raises(ValueError):
        ck.load_checkpoint(path, tree)


def test_latest_step_tolerates_stray_files(tmp_path):
    ck.save_checkpoint(str(tmp_path), {"x": torch.zeros(2)}, step=3)
    (tmp_path / "ckpt_notastep.bin").write_bytes(b"junk")
    (tmp_path / "ckpt_README").write_text("hands off")
    (tmp_path / "other.txt").write_text("")
    os.makedirs(tmp_path / "ckpt_00000009")   # no manifest: not committed
    assert ck.latest_step(str(tmp_path)) == 3
    assert ck.latest_step(str(tmp_path / "missing")) is None


def test_sweep_orphans_removes_only_debris(tmp_path):
    ck.save_checkpoint(str(tmp_path), {"x": torch.zeros(2)}, step=1)
    (tmp_path / "ckpt-tmp-dead1").write_bytes(b"partial")
    os.makedirs(tmp_path / "ckpt_00000002.tmp-beef")
    (tmp_path / "ckpt_00000002.tmp-beef" / "leaves.bin").write_bytes(b"")
    (tmp_path / "keepme.txt").write_text("")
    removed = ck.sweep_orphans(str(tmp_path))
    assert sorted(removed) == ["ckpt-tmp-dead1", "ckpt_00000002.tmp-beef"]
    assert (tmp_path / "keepme.txt").exists()
    assert ck.latest_step(str(tmp_path)) == 1


def test_stepped_save_sweeps_previous_orphans(tmp_path):
    (tmp_path / "ckpt-tmp-leftover").write_bytes(b"x")
    ck.save_checkpoint(str(tmp_path), {"x": torch.zeros(2)}, step=2)
    names = os.listdir(tmp_path)
    assert "ckpt-tmp-leftover" not in names
    assert "ckpt_00000002.bin" in names


# ---------------------------------------------------------------------------
# round trips of the containers training saves
# ---------------------------------------------------------------------------

def _fp32_params():
    net = make_network((5,), 3, hidden=(64,), device="cpu")
    return net.init(torch.Generator().manual_seed(0))


def _per_state():
    state = rb.per_init(16, (4,), device="cpu")
    batch = rb.Transition(
        obs=torch.ones((4, 4)), action=torch.arange(4, dtype=torch.int32),
        reward=torch.arange(4.0), done=torch.zeros(4),
        next_obs=torch.full((4, 4), 2.0))
    state = rb.per_add(state, batch)
    return rb.per_update_priorities(state, torch.arange(4),
                                    torch.arange(4.0) + 0.5, 0.6)


def _dqn_cfg():
    return dqn.DQNConfig(n_envs=2, rollout_steps=2, buffer_size=32,
                         batch_size=4, warmup=4, actor_backend="int8")


def _opt_state():
    env = make_env("cartpole")
    net = make_network(env.spec.obs_shape, env.spec.n_actions, hidden=(8,),
                       device="cpu")
    return dqn.init(torch.Generator().manual_seed(1), env, net,
                    _dqn_cfg()).opt


def _kv_cache():
    env = make_env("catch_seq")
    net = make_network(env.spec.obs_shape, env.spec.n_actions,
                       transformer=dict(d_model=8, n_layers=1, d_ff=16),
                       device="cpu")
    ps = actorq.seq_cache_zeros(net.seq_cfg, 3, 8, device="cpu")
    ps["count"] += 2
    ps["layers"][0]["k_codes"][:, :2] = 7
    return ps


def _actor_learner_state():
    env = make_env("cartpole")
    net = make_network(env.spec.obs_shape, env.spec.n_actions, hidden=(8,),
                       device="cpu")
    st = actor_learner.init(torch.Generator().manual_seed(2), env, net,
                            "dqn", _dqn_cfg(),
                            actor_learner.ActorLearnerConfig(num_actors=2))
    return st._replace(t=5)


@pytest.mark.parametrize("build", [
    _fp32_params,
    lambda: actorq.make_actor_cache(_fp32_params(), "int8"),
    lambda: actorq.make_actor_cache(_fp32_params(), "int4"),
    _per_state,
    _opt_state,
    _kv_cache,
    _actor_learner_state,
], ids=["fp32_params", "int8_cache", "int4_cache", "per_sum_tree",
        "optimizer_state", "kv_cache", "actor_learner_state"])
def test_container_roundtrip(tmp_path, build):
    tree = build()
    path = ck.save_checkpoint(str(tmp_path / "c.bin"), tree)
    _assert_tree_equal(ck.load_checkpoint(path, tree), tree)

    mgr = mgr_lib.CheckpointManager(str(tmp_path / "mgr"))
    mgr.save(4, tree, extra={"note": "hi"})
    restored, extra = mgr.restore(4, tree)
    _assert_tree_equal(restored, tree)
    assert extra == {"note": "hi"}


def test_packed_cache_is_about_4x_smaller_on_disk(tmp_path):
    """At Policy II's widths the codes outweigh the per-column scales and
    the fp32 biases, which the pack keeps."""
    params = make_network((64,), 4, hidden=(256, 256, 256),
                          device="cpu").init(torch.Generator().manual_seed(0))
    sizes = {}
    for name, tree in (("fp32", params),
                       ("int8", actorq.make_actor_cache(params, "int8")),
                       ("int4", actorq.make_actor_cache(params, "int4"))):
        mgr = mgr_lib.CheckpointManager(str(tmp_path / name))
        path = mgr.save(1, tree)
        sizes[name] = os.path.getsize(os.path.join(path, "leaves.bin"))
    ratio8, ratio4 = sizes["fp32"] / sizes["int8"], sizes["fp32"] / sizes[
        "int4"]
    print(f"data bytes {sizes}: fp32 / int8 {ratio8:.2f}, fp32 / int4 "
          f"{ratio4:.2f}")
    assert 3.5 < ratio8 < 4.0 and ratio4 > 6.5


def _uniform():
    st = rb.replay_init(8, (3,), device="cpu")
    return rb.replay_add_batch(st, rb.Transition(
        torch.ones((3, 3)), torch.arange(3, dtype=torch.int32),
        torch.arange(3.0), torch.zeros(3), torch.ones((3, 3))))


@pytest.mark.parametrize("layout", ["uniform", "prioritized", "sharded",
                                    "double"])
def test_replay_export_import_roundtrip(layout):
    state = {"uniform": _uniform, "prioritized": _per_state,
             "sharded": lambda: rb.replay_stack([_uniform(), _uniform()]),
             "double": lambda: rb.double_buffer_init(
                 rb.per_init_sharded, 2, 16, (4,), device="cpu")}[layout]()
    snap = rb.export_state(state)
    assert all(x.device.type == "cpu" for x in tree_flatten(snap)[1])
    assert all(x.data_ptr() != y.data_ptr() for x, y in zip(
        tree_flatten(snap)[1], tree_flatten(state)[1]))
    _assert_tree_equal(rb.import_state(state, snap), state)
    if layout == "prioritized":
        # another capacity is loud, the differing leaves named
        with pytest.raises(ValueError, match=r"\.tree: checkpoint"):
            rb.import_state(rb.per_init(32, (4,), device="cpu"), snap)
        with pytest.raises(ValueError, match="structure"):
            rb.import_state(state.replay, snap)


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------

def test_manager_manifest_contents(tmp_path):
    mgr = mgr_lib.CheckpointManager(str(tmp_path))
    tree = {"w": torch.zeros((2, 3)), "n": torch.zeros((), dtype=torch.int32)}
    mgr.save(7, tree, extra={"iteration": 7})
    m = json.loads((tmp_path / "ckpt_00000007" / "manifest.json"
                    ).read_text())
    assert m["format"] == mgr_lib.FORMAT == "repro-torch-ckpt-v1"
    assert m["step"] == 7 and m["leaf_count"] == 2
    # dict keys sorted: "n" first, then "w" at byte 4
    assert m["leaves"] == [
        {"shape": [], "dtype": "<i4", "offset": 0, "nbytes": 4},
        {"shape": [2, 3], "dtype": "<f4", "offset": 4, "nbytes": 24}]
    assert m["extra"] == {"iteration": 7}
    assert isinstance(m["crc32"], int)


def test_manager_validates_restore_template(tmp_path):
    mgr = mgr_lib.CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.zeros(4)})
    with pytest.raises(ValueError, match=r"\['w'\]"):
        mgr.restore(1, {"w": torch.zeros(5)})


def test_manager_retention_gc_and_resave(tmp_path):
    mgr = mgr_lib.CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.full((3,), float(s))})
    assert mgr.steps() == [3, 4]
    assert mgr.latest_step() == 4
    mgr.save(4, {"x": torch.full((3,), 99.0)})
    restored, _ = mgr.restore(4, {"x": torch.zeros(3)})
    assert torch.equal(restored["x"], torch.full((3,), 99.0))
    keep_all = mgr_lib.CheckpointManager(str(tmp_path / "all"), keep=0)
    for s in (1, 2, 3, 4):
        keep_all.save(s, {"x": torch.zeros(1)})
    assert keep_all.steps() == [1, 2, 3, 4]


def test_manager_refuses_torn_data_and_resume_falls_back(tmp_path):
    mgr = mgr_lib.CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.full((8,), 1.0)})
    mgr.save(2, {"x": torch.full((8,), 2.0)})
    data = tmp_path / "ckpt_00000002" / "leaves.bin"
    data.write_bytes(data.read_bytes()[:-4] + b"\0\0\0\0")
    with pytest.raises(ValueError, match="checksum mismatch"):
        mgr.restore(2, {"x": torch.zeros(8)})
    assert not mgr.step_valid(2)
    assert mgr.latest_step() == ck.latest_step(str(tmp_path)) == 1


# ---------------------------------------------------------------------------
# AsyncCheckpointer
# ---------------------------------------------------------------------------

def test_async_checkpointer_commits_in_order(tmp_path):
    with mgr_lib.AsyncCheckpointer(str(tmp_path), keep=0) as ac:
        for s in (2, 4, 6):
            ac.save_async(s, {"x": torch.full((2,), float(s))},
                          extra={"iteration": s})
        assert ac.wait() == 6
        assert ac.last_committed_step() == 6
        assert ac.manager.steps() == [2, 4, 6]
        tree, extra = ac.restore(4, {"x": torch.zeros(2)})
    assert torch.equal(tree["x"], torch.full((2,), 4.0))
    assert extra["iteration"] == 4


def test_async_checkpointer_snapshot_isolation(tmp_path):
    """The host copy is taken at ``save_async``: the caller changing the
    tensor, or appending to a live ``extra`` list, does not reach the
    commit."""
    x = torch.zeros(3)
    metrics = [1.0]
    with mgr_lib.AsyncCheckpointer(str(tmp_path)) as ac:
        ac.save_async(1, {"x": x}, extra={"rewards": metrics})
        x[:] = -1.0
        metrics.append(2.0)
        ac.wait()
        tree, extra = ac.restore(1, {"x": torch.zeros(3)})
    assert torch.equal(tree["x"], torch.zeros(3))
    assert extra["rewards"] == [1.0]


def test_async_checkpointer_propagates_writer_errors(tmp_path):
    ac = mgr_lib.AsyncCheckpointer(str(tmp_path))

    def boom(*a, **k):
        raise OSError("disk on fire")

    ac.manager.commit_hosted = boom
    ac.save_async(1, {"x": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="async checkpoint write"):
        ac.wait()
    ac.close()
    with pytest.raises(RuntimeError, match="closed"):
        ac.save_async(2, {"x": torch.zeros(2)})


# ---------------------------------------------------------------------------
# crash injection
# ---------------------------------------------------------------------------

def test_crash_mid_save_keeps_previous_step(tmp_path, monkeypatch):
    """A save killed between staging and the rename: the directory stays
    loadable at the previous step, and the next save sweeps the debris."""
    mgr = mgr_lib.CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.full((2,), 1.0)}, extra={"iteration": 1})

    real_replace = os.replace

    def killed(src, dst):
        raise RuntimeError("killed mid-commit")

    monkeypatch.setattr(os, "replace", killed)
    with pytest.raises(RuntimeError, match="mid-commit"):
        mgr.save(2, {"x": torch.full((2,), 2.0)})
    monkeypatch.setattr(os, "replace", real_replace)

    assert [n for n in os.listdir(tmp_path) if ".tmp-" in n]
    assert mgr.latest_step() == 1
    assert ck.latest_step(str(tmp_path)) == 1
    tree, extra = mgr.restore(1, {"x": torch.zeros(2)})
    assert torch.equal(tree["x"], torch.full((2,), 1.0))
    assert extra["iteration"] == 1

    # a new writer on the directory (the restarted process) sweeps on
    # construction; its save leaves no staging entry behind
    with mgr_lib.AsyncCheckpointer(str(tmp_path)) as ac:
        ac.save_async(2, {"x": torch.full((2,), 2.0)})
        ac.wait()
    assert not [n for n in os.listdir(tmp_path) if ".tmp-" in n]
    assert mgr.latest_step() == 2
