"""The port's RL serving launcher (``launch.serve --rl-env``) on the CPU.

Four configurations of the reference launcher's RL mode, each a few
training iterations and a few sessions: CartPole fused (PPO) with int8
actors, Pendulum (DDPG), DQN in the actor-learner topology with 2 actors,
and the async int4 actor calibrated on 16 observations (the fused kernel's
path).  Each prints the reference's lines, answers every session at every
step and moves the version at the hot-swap.  ``--replay prioritized``
with a fused discrete env exits as the reference's does, and a
``--kernel-backend`` other than ``auto`` is refused.
"""
import numpy as np
import pytest
import torch

from repro_torch.launch import serve

BASE = ["--device", "cpu", "--rl-iters", "4", "--steps-per-call", "2",
        "--serve-sessions", "12", "--serve-steps", "4"]

CONFIGS = {
    "cartpole_ppo_int8": (["--rl-env", "cartpole", "--actor-backend",
                           "int8"], "ppo"),
    "pendulum_ddpg": (["--rl-env", "pendulum"], "ddpg"),
    "actor_learner": (["--rl-env", "cartpole", "--topology",
                       "actor-learner", "--num-actors", "2",
                       "--actor-backend", "int8"], "dqn"),
    "async_int4_calibrated": (["--rl-env", "cartpole", "--topology",
                               "async", "--actor-backend", "int4",
                               "--calib-batch", "16"], "dqn"),
}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these nets are small, and the suite's workers
    share the machine's cores (bitwise comparisons stay inside a test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_serve_rl_configs(name, capsys):
    argv, algo = CONFIGS[name]
    args = serve.parse_args(BASE + argv)
    out = serve.serve_policy(args, *serve.train_policy(args))
    text = capsys.readouterr().out
    assert f"algo={algo}" in text and "device=cpu" in text
    assert "[serve-rl] hot-swap at step 2: now serving cache version 1" \
        in text
    assert "12 sessions x 4 steps" in text and "actions/s on cpu" in text
    assert out["answered"] == 12 * 4
    assert out["entry"].version == 0 and out["swap_version"] == 1
    stats = out["server"].stats()
    assert stats["served"] == 12 * 4 and stats["version"] == 1
    assert stats["worker"]["dispatch_failures"] == 0
    assert {r.version for r in out["last_results"]} == {1}
    assert all(np.all(np.isfinite(r.action)) for r in out["last_results"])
    if "calib" in name:
        assert "fused single-pass actor" in text
    if name == "actor_learner":
        assert "per-actor divergence" in text
    if name.startswith("async"):
        assert "async overlap" in text


def test_serve_rl_main_exits_zero(capsys):
    assert serve.main(["--rl-env", "cartpole", "--rl-iters", "1",
                       "--serve-sessions", "4", "--serve-steps", "2",
                       "--device", "cpu"]) == 0
    assert "[serve-rl] 4 sessions x 2 steps" in capsys.readouterr().out


def test_serve_rl_refusals():
    with pytest.raises(SystemExit, match="needs a replay algorithm"):
        serve.main(["--rl-env", "cartpole", "--replay", "prioritized",
                    "--device", "cpu"])
    with pytest.raises(ValueError, match="kernel_backend must be 'auto'"):
        serve.main(["--rl-env", "cartpole", "--kernel-backend", "ref",
                    "--rl-iters", "1", "--device", "cpu"])
