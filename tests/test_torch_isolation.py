"""The port stands alone: no file of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or the JAX package ``repro`` (whose name
is a prefix of ``repro_torch``, so the scan compares whole module names).
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def test_scan_sees_the_port():
    names = {p.name for p in PORT_FILES}
    assert {"server.py", "actorq.py", "ops.py", "chip_smoke.py",
            "seq_policy.py", "int8_cache_attention.py", "dqn.py",
            "wrappers.py", "fake_quant.py", "metrics.py", "cartpole.py",
            "adam.py", "buffer.py", "loops.py", "train.py",
            "flash_attention.py", "attention.py", "blocks.py",
            "transformer.py", "serve.py", "base.py", "h2o_danube_1_8b.py",
            "gemma2_9b.py", "quarl_atari.py", "mountaincar.py",
            "pendulum.py", "ddpg.py", "ppo.py", "a2c.py", "ckpt.py",
            "manager.py", "guards.py", "faults.py", "supervisor.py",
            "moe.py", "recurrent.py", "recurrentgemma_2b.py",
            "xlstm_125m.py", "mixtral_8x7b.py", "codeqwen1_5_7b.py",
            "stablelm_12b.py", "mixed_precision.py", "synthetic.py",
            "sgd.py", "schedule.py", "steps.py", "mesh.py", "distributed.py",
            "pipeline.py", "analytic.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {mod}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.serving, "
            "repro_torch.rl.actorq, repro_torch.kernels.ops, "
            "repro_torch.rl.envs, repro_torch.resilience.guards, "
            "repro_torch.rl.dqn, repro_torch.models.seq_policy, "
            "repro_torch.rl.loops, repro_torch.launch.train, "
            "repro_torch.core.fake_quant, repro_torch.core.metrics, "
            "repro_torch.kernels.flash_attention, repro_torch.configs.base, "
            "repro_torch.models.transformer, repro_torch.launch.serve, "
            "repro_torch.configs.quarl_atari, "
            "repro_torch.rl.envs.mountaincar, repro_torch.rl.envs.pendulum, "
            "repro_torch.rl.ddpg, repro_torch.rl.ppo, repro_torch.rl.a2c, "
            "repro_torch.checkpoint, repro_torch.resilience, "
            "repro_torch.resilience.faults, "
            "repro_torch.resilience.supervisor, repro_torch.models.moe, "
            "repro_torch.models.recurrent, repro_torch.core.mixed_precision, "
            "repro_torch.data, repro_torch.data.synthetic, "
            "repro_torch.optim.sgd, repro_torch.optim.schedule, "
            "repro_torch.optim.adam, repro_torch.launch.steps, "
            "repro_torch.rl.distributed, repro_torch.launch.mesh, "
            "repro_torch.launch.analytic, repro_torch.data.pipeline\n"
            "from repro_torch.configs import base\n"
            "[base.get(n) for n in base.names()]\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_checkpoint_uses_no_jax_msgpack_or_pickle():
    """``repro_torch.checkpoint`` writes raw bytes and JSON: it imports
    neither ``jax`` nor ``msgpack`` (absent on the card's host) and
    neither ``pickle`` nor ``torch.save`` / ``torch.load``."""
    files = sorted((ROOT / "src" / "repro_torch" / "checkpoint").glob(
        "*.py"))
    assert {p.name for p in files} == {"__init__.py", "ckpt.py",
                                       "manager.py"}
    for path in files:
        mods = {m.split(".")[0] for m in _imported_modules(path)}
        assert not mods & {"jax", "jaxlib", "msgpack", "pickle", "repro"}
        text = path.read_text()
        assert "torch.save" not in text and "torch.load" not in text
    code = ("import sys, repro_torch.checkpoint\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'msgpack', 'repro'))\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_resilience_uses_no_jax_msgpack_or_pickle():
    """``repro_torch.resilience`` keeps its own copy of the reference's
    plan parsing and guards: neither it nor the serve launcher imports
    ``jax``, ``msgpack``, ``pickle`` or anything of ``repro``, and running
    the launcher's ``--rl-env`` path with the supervisor layer loaded
    brings in no ``jax``, ``msgpack`` or ``repro`` module (``torch``
    itself loads ``pickle``)."""
    files = sorted((ROOT / "src" / "repro_torch" / "resilience").glob(
        "*.py"))
    assert {p.name for p in files} == {"__init__.py", "guards.py",
                                       "faults.py", "supervisor.py"}
    for path in files + [ROOT / "src" / "repro_torch" / "launch" /
                         "serve.py"]:
        mods = {m.split(".")[0] for m in _imported_modules(path)}
        assert not mods & {"jax", "jaxlib", "msgpack", "pickle", "repro"}
    code = ("import sys\n"
            "from repro_torch import resilience\n"
            "from repro_torch.launch import serve\n"
            "resilience.supervise, resilience.SupervisorAbort\n"
            "args = serve.parse_args(['--rl-env', 'cartpole', '--device', "
            "'cpu', '--rl-iters', '1', '--serve-sessions', '2', "
            "'--serve-steps', '1'])\n"
            "serve.serve_policy(args, *serve.train_policy(args))\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'msgpack', 'repro'))\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def _entry_points():
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import base as cfgs
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.data import ShardedBatcher
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer
    from repro_torch.resilience import supervise
    from repro_torch.rl import a2c, actorq, buffer, ddpg, distributed, dqn, \
        loops, networks, ppo
    from repro_torch.rl.env import batched_env
    from repro_torch.rl.envs import make
    from repro_torch.serving import PolicyServer

    spec = networks.mlp_spec(9, (8,), 25)
    gen = torch.Generator().manual_seed(0)
    env = make("airnav")
    seq_env = make("catch_seq")

    def seq_net():
        return networks.make_network(seq_env.spec.obs_shape, 3,
                                     transformer={"d_model": 8,
                                                  "n_layers": 1})
    return {
        "init_mlp": lambda: networks.init_mlp(spec, gen)["fc0"]["w"],
        "params_from_jax": lambda: networks.params_from_jax(
            {"out": {"w": np.zeros((9, 25), np.float32)}})["out"]["w"],
        "airnav_reset": lambda: env.reset(gen, 4)[1],
        "batched_env_reset": lambda: batched_env(env, 4).reset(gen)[1],
        "policy_server": lambda: PolicyServer(env.spec).device,
        "catch_reset": lambda: make("catch").reset(gen, 4)[1],
        "wrapper_reset": lambda: seq_env.reset(gen, 4)[1],
        "make_network_init": lambda: seq_net().init(gen)["embed"]["w"],
        "seq_cache_zeros": lambda: actorq.seq_cache_zeros(
            networks.make_network((6, 27), 3, transformer={},
                                  device="cpu").seq_cfg, 4, 8)["count"],
        "cartpole_reset": lambda: make("cartpole").reset(gen, 4)[1],
        "mountaincar_reset": lambda: make("mountaincar").reset(gen, 4)[1],
        "pendulum_reset": lambda: make("pendulum").reset(gen, 4)[1],
        "conv_network_init": lambda: networks.make_network(
            (5, 5, 1), 3, conv_filters=(2,), fc_width=4).init(gen)[
                "conv0"]["w"],
        "replay_init": lambda: buffer.replay_init(8, (4,)).size,
        "make_iteration": lambda: dqn.make_iteration(
            make("cartpole"), networks.make_network((4,), 2, device="cpu"),
            dqn.DQNConfig(n_envs=2))[2].reset(gen)[1],
        "loops_train": lambda: loops.train("dqn", "cartpole",
                                           iterations=1).device,
        "launch_train": lambda: launch_train.main(
            ["--algo", "dqn", "--iterations", "1"]),
        "launch_train_defaults": lambda: launch_train.main(
            ["--iterations", "1"]),
        "ddpg_make_nets": lambda: ddpg.make_nets(make("pendulum")).actor
        .init(gen)["fc0"]["w"],
        "ddpg_train": lambda: loops.train("ddpg", "pendulum",
                                          iterations=1).device,
        "ppo_make_iteration": lambda: ppo.make_iteration(
            make("cartpole"), networks.make_network((4,), 3, device="cpu"),
            ppo.PPOConfig(n_envs=2))[2].reset(gen)[1],
        "ppo_train": lambda: loops.train("ppo", "cartpole",
                                         iterations=1).device,
        "a2c_train": lambda: loops.train("a2c", "cartpole",
                                         iterations=1).device,
        "transformer_init_params": lambda: transformer.init_params(
            cfgs.get_reduced("h2o-danube-1.8b"), gen)["embed"]["w"],
        "transformer_init_caches": lambda: transformer.init_caches(
            cfgs.get_reduced("h2o-danube-1.8b"), 1, 4)["stacked"][
                "b0_attn_local"]["kv"].k,
        "launch_serve": lambda: launch_serve.main(
            ["--reduced", "--batch", "1", "--prompt-len", "2",
             "--new-tokens", "1"]),
        "recurrent_init_caches": lambda: transformer.init_caches(
            cfgs.get_reduced("recurrentgemma-2b"), 1, 4)["stacked"][
                "b0_rglru"]["h"],
        "launch_serve_recurrent": lambda: launch_serve.main(
            ["--arch", "xlstm-125m", "--reduced", "--batch", "1",
             "--prompt-len", "2", "--new-tokens", "1"]),
        "launch_serve_moe": lambda: launch_serve.main(
            ["--arch", "mixtral-8x7b", "--reduced", "--batch", "1",
             "--prompt-len", "2", "--new-tokens", "1", "--int8-cache"]),
        "launch_serve_rl": lambda: launch_serve.main(
            ["--rl-env", "cartpole", "--rl-iters", "1", "--serve-sessions",
             "2", "--serve-steps", "1"]),
        "supervise": lambda: supervise(dict(
            algo="dqn", env_name="cartpole", iterations=1))[0].device,
        "init_qat_collection": lambda: transformer.init_qat_collection(
            dataclasses.replace(cfgs.get_reduced("h2o-danube-1.8b"),
                                quant=QuantConfig.qat(8)))["embed/out"]
        .vmin,
        "launch_train_lm": lambda: launch_train.main(
            ["--mode", "lm", "--arch", "h2o-danube-1.8b", "--reduced",
             "--steps", "1", "--batch", "2", "--seq", "8"]),
        "make_distributed_a2c": lambda: distributed.make_distributed_a2c(
            make("cartpole"), networks.make_network((4,), 3, device="cpu"),
            a2c.A2CConfig(n_envs=2), None)[2].reset(gen)[1],
        "sharded_batcher": lambda: ShardedBatcher().put(
            {"x": np.zeros((2, 3), np.float32)})["x"],
        "make_host_mesh": _host_mesh_device,
    }


def _host_mesh_device():
    """``launch.mesh.make_host_mesh()``'s device type, on a world-1 gloo
    group of its own where there is a card (the mesh needs a group; it
    raises before looking for one without a card)."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh
    if not torch.cuda.is_available():
        return mesh.make_host_mesh()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            return torch.device(mesh.make_host_mesh().device_type)
        finally:
            dist.destroy_process_group()


@pytest.mark.parametrize("name", ["init_mlp", "params_from_jax",
                                  "airnav_reset", "batched_env_reset",
                                  "policy_server", "catch_reset",
                                  "wrapper_reset", "make_network_init",
                                  "seq_cache_zeros", "cartpole_reset",
                                  "mountaincar_reset", "pendulum_reset",
                                  "conv_network_init",
                                  "replay_init", "make_iteration",
                                  "loops_train", "launch_train",
                                  "launch_train_defaults", "ddpg_make_nets",
                                  "ddpg_train", "ppo_make_iteration",
                                  "ppo_train", "a2c_train",
                                  "transformer_init_params",
                                  "transformer_init_caches",
                                  "launch_serve", "launch_serve_rl",
                                  "recurrent_init_caches",
                                  "launch_serve_recurrent",
                                  "launch_serve_moe",
                                  "supervise", "init_qat_collection",
                                  "launch_train_lm", "make_distributed_a2c",
                                  "sharded_batcher", "make_host_mesh"])
def test_entry_points_default_to_the_card(name):
    """``device=None`` means ``cuda``: it lands there with a card and
    raises without one, never falling back to the CPU."""
    import torch
    call = _entry_points()[name]
    if torch.cuda.is_available():
        out = call()
        if name.startswith(("launch_train", "launch_serve")):  # exit code
            assert out == 0
            return
        assert (out if isinstance(out, torch.device) else out.device
                ).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
