"""Bitwise resume inside the port (the cases of ``tests/test_resume.py``).

Training to 3 with checkpoints on, then resuming from the newest step and
training to 6, gives the params, the optimizer and replay states and
every recorded metric bit for bit as the run to 6 that was never stopped
(and that ran with no checkpoint directory: saving cannot move the
trajectory either).  DQN and DDPG in all three topologies with the packed
int8 actor cache in the state, prioritized replay, the sequence actor
(its int8 KV caches ride in the env state) in the fused and async
drivers, PPO fused, and the launcher's ``--ckpt-dir`` / ``--resume``.

Catch runs a narrow conv net (4 filters, an fc of 16), the reference's
``hidden=(16,)`` being the default conv net there, to keep this file
light on the CPU.  The two-process case is marked slow, as the
reference's.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.ptq import tree_flatten
from repro_torch.launch import train as launch_train
from repro_torch.rl import loops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL = dict(n_envs=2, rollout_steps=2, updates_per_iter=2,
             buffer_size=64, batch_size=8, warmup=8)
NETS = {"catch": dict(conv_filters=(4,), fc_width=16),
        "pendulum": dict(hidden=(16,)),
        "catch_seq": {"transformer": dict(d_model=16, n_layers=1, d_ff=32)}}


def _train(algo, env, topo, *, ckpt_dir=None, iterations=6, resume=False,
           **kw):
    multi = topo != "fused"
    kw.setdefault("algo_overrides", dict(SMALL))
    return loops.train(
        algo, env, iterations=iterations, seed=3, record_every=3,
        eval_episodes=2, actor_backend="int8", net_kwargs=NETS.get(env),
        topology=topo, num_actors=2 if multi else 1,
        sync_every=2 if multi else 1,
        checkpoint_dir=ckpt_dir, checkpoint_every=3 if ckpt_dir else 0,
        resume=resume, device="cpu", **kw)


def _assert_bitwise(full, res):
    pa, la = tree_flatten(full.state)
    pb, lb = tree_flatten(res.state)
    assert pa == pb
    for x, y in zip(la, lb):
        assert torch.equal(x, y)
    assert full.rewards == res.rewards
    assert full.action_variances == res.action_variances
    assert full.divergences == res.divergences
    assert full.actor_lags == res.actor_lags
    assert full.eval_steps == res.eval_steps


def _resumed(tmp_path, algo, env, topo, **kw):
    d = str(tmp_path / "ckpt")
    full = _train(algo, env, topo, **kw)                  # no checkpoints
    _train(algo, env, topo, ckpt_dir=d, iterations=3, **kw)   # stopped at 3
    res = _train(algo, env, topo, ckpt_dir=d, resume=True, **kw)
    _assert_bitwise(full, res)
    return d


@pytest.mark.parametrize("topo", ["fused", "actor-learner", "async"])
@pytest.mark.parametrize("algo,env", [("dqn", "catch"),
                                      ("ddpg", "pendulum")])
def test_resume_bitwise_identical(tmp_path, algo, env, topo):
    d = _resumed(tmp_path, algo, env, topo)
    # the run's last save committed too, and retention kept both
    assert CheckpointManager(d).steps() == [3, 6]


def test_resume_bitwise_prioritized_replay(tmp_path):
    """The per-shard sum-trees ride the same contract."""
    _resumed(tmp_path, "dqn", "catch", "actor-learner",
             replay="prioritized", priority_exponent=0.6)


@pytest.mark.parametrize("topo", ["fused", "async"])
def test_resume_bitwise_seq_policy(tmp_path, topo):
    """The int8 KV-cache actor state (``actorq.seq_cache_zeros`` in the
    env state) is saved and restored with the rest of the run."""
    _resumed(tmp_path, "dqn", "catch_seq", topo)


def test_resume_bitwise_ppo_fused(tmp_path):
    _resumed(tmp_path, "ppo", "cartpole", "fused",
             algo_overrides=dict(n_envs=2, n_steps=8, n_minibatches=2,
                                 epochs=2))


def test_resume_noop_without_checkpoint(tmp_path):
    """resume=True over an empty directory starts from scratch."""
    full = _train("dqn", "catch", "fused")
    res = _train("dqn", "catch", "fused",
                 ckpt_dir=str(tmp_path / "empty"), resume=True)
    _assert_bitwise(full, res)


def test_checkpoint_knobs_validated():
    for bad in (dict(resume=True), dict(checkpoint_every=5)):
        with pytest.raises(ValueError, match="needs checkpoint_dir"):
            loops.train("dqn", "catch", iterations=1, device="cpu",
                        algo_overrides=dict(SMALL), net_kwargs=NETS["catch"],
                        **bad)


def test_launch_train_ckpt_dir_and_resume(tmp_path, capsys):
    base = ["--algo", "ddpg", "--env", "pendulum", "--actor-backend", "int8",
            "--device", "cpu", "--seed", "2"]
    ckpt = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2",
            "--ckpt-keep", "0"]

    def rewards(argv):
        assert launch_train.main(base + argv) == 0
        out = capsys.readouterr().out
        start = out.index("eval rewards")
        return out[start:out.index("]", start) + 1]
    full = rewards(["--iterations", "4"])
    assert full.startswith("eval rewards ['") and full.count("'") == 8
    rewards(["--iterations", "2"] + ckpt)
    assert CheckpointManager(str(tmp_path / "ck")).steps() == [2]
    assert rewards(["--iterations", "4", "--resume"] + ckpt) == full
    assert CheckpointManager(str(tmp_path / "ck")).steps() == [2, 4]
    with pytest.raises(ValueError, match="needs checkpoint_dir"):
        launch_train.main(base + ["--iterations", "2", "--resume"])


_PHASE_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch
    from repro_torch.core.ptq import tree_flatten
    from repro_torch.rl import loops

    ckpt_dir, iterations, resume, out = (
        sys.argv[1], int(sys.argv[2]), sys.argv[3] == "1", sys.argv[4])
    res = loops.train(
        "dqn", "catch", iterations=iterations, seed=3, record_every=3,
        eval_episodes=2, actor_backend="int8", topology="async",
        num_actors=2, sync_every=2,
        algo_overrides=dict(n_envs=2, rollout_steps=2, updates_per_iter=2,
                            buffer_size=64, batch_size=8, warmup=8),
        net_kwargs=dict(conv_filters=(4,), fc_width=16),
        checkpoint_dir=ckpt_dir or None,
        checkpoint_every=3 if ckpt_dir else 0, resume=resume, device="cpu")
    leaves = [x.tolist() for x in tree_flatten(res.state.params)[1]]
    json.dump({"params": leaves, "rewards": res.rewards}, open(out, "w"))
""")


@pytest.mark.slow
def test_resume_across_processes(tmp_path):
    """Nothing survives the first process but the checkpoint directory,
    and the resumed process still gives the run that was never stopped,
    bit for bit."""
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}

    def phase(ckpt_dir, iterations, resume, out):
        subprocess.run(
            [sys.executable, "-c", _PHASE_SCRIPT, ckpt_dir,
             str(iterations), "1" if resume else "0", out],
            check=True, env=env, cwd=REPO, timeout=600)

    d = str(tmp_path / "ckpt")
    phase("", 6, False, str(tmp_path / "full.json"))
    phase(d, 3, False, str(tmp_path / "phase1.json"))
    phase(d, 6, True, str(tmp_path / "resumed.json"))

    full = json.load(open(tmp_path / "full.json"))
    res = json.load(open(tmp_path / "resumed.json"))
    assert full["rewards"] == res["rewards"]
    assert full["params"] == res["params"]
