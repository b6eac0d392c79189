"""Serving launcher of the port: LM decoding and RL policy serving.

Counterpart of ``repro/launch/serve.py``, with its flags and ``--device``.

**LM mode** (the default): a seeded model of ``--arch`` (``--reduced`` for the smoke-test
variant; any LM config of the reference), its float32 params drawn
by a generator on the device, optionally PTQ-simulated weights (``--quant
ptq_int8``: every weight of two or three dims through kernel B5 on the
card, four-dim ones per output channel) and an int8 KV cache
(``--int8-cache``, decode attention through kernel B3; a recurrent
layer's state stays float32), then a teacher-forced pass over a random
prompt and greedy decoding, one token at a time through
``transformer.decode_step``.  The encoder and cross-attention configs
(whisper-tiny, llama-3.2-vision-90b) get seeded stub embeddings, normal
times 0.02 of ``(batch, max(encoder_seq, 4), d_model)``, fed to every
step:

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma-2b --batch 4 --prompt-len 32 \\
        --new-tokens 32 --quant ptq_int8 --int8-cache

**RL mode** (``--rl-env``): trains a policy with ``loops.train`` (PPO on
a fused discrete env, DDPG on a continuous one, DQN or DDPG in the
``--topology actor-learner`` / ``async`` topologies; fp32, int8 or int4
actors; uniform or prioritized replay; ``--ckpt-dir`` / ``--resume``),
then stands up ``serving.PolicyServer`` over its packed cache
(``--calib-batch`` > 0 calibrates it on a greedy rollout, so an MLP actor
serves through the fused kernel B2; else B1 a layer) and drives
``--serve-sessions`` sessions, each stepping its own env, for
``--serve-steps`` steps, with a hot-swap at the halfway step:

    PYTHONPATH=src python -m repro_torch.launch.serve --rl-env cartpole \
        --topology async --actor-backend int4 --calib-batch 64 \
        --serve-sessions 256 --serve-steps 4

``--kernel-backend`` takes only ``auto``: the port dispatches its
kernels by device.  Both modes run on the card unless ``--device cpu``
is given, and print their rates with the device's name.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Any, Dict, List


def _device_name(torch, device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def train_policy(args):
    """The RL mode's training: ``(algo, env, TrainResult)`` of
    ``loops.train`` with the flags' topology, actors, replay and
    checkpoints; prints the reference's summary lines."""
    from repro_torch.rl import loops
    from repro_torch.rl.actor_learner import ALGOS as REPLAY_ALGOS
    from repro_torch.rl.envs import make as make_env

    env = make_env(args.rl_env)
    topo_kw: Dict[str, Any] = {}
    if args.topology in ("actor-learner", "async"):
        # replay algorithms only (the paper's DQN / D4PG analogues)
        algo = "dqn" if not env.spec.continuous else "ddpg"
        topo_kw = dict(topology=args.topology, num_actors=args.num_actors,
                       sync_every=args.sync_every)
    else:
        algo = "ppo" if not env.spec.continuous else "ddpg"
    if args.replay != "uniform" and algo not in REPLAY_ALGOS:
        raise SystemExit(
            f"--replay {args.replay} needs a replay algorithm; fused "
            f"discrete envs train {algo} -- use --topology actor-learner")
    if algo in REPLAY_ALGOS:
        topo_kw.update(replay=args.replay,
                       priority_exponent=args.priority_exponent,
                       is_beta=args.is_beta)
    iters = max(args.rl_iters, 1)
    res = loops.train(algo, args.rl_env, iterations=iters,
                      record_every=iters, eval_episodes=2, seed=args.seed,
                      steps_per_call=args.steps_per_call,
                      actor_backend=args.actor_backend,
                      calib_batch=args.calib_batch,
                      algo_overrides=dict(kernel_backend=args.kernel_backend),
                      checkpoint_dir=args.ckpt_dir,
                      checkpoint_every=args.ckpt_every, resume=args.resume,
                      device=args.device, **topo_kw)
    if algo in REPLAY_ALGOS and args.replay == "prioritized":
        print(f"[serve-rl] prioritized replay: alpha="
              f"{args.priority_exponent} is_beta={args.is_beta}")
    if args.topology in ("actor-learner", "async") and res.divergences:
        div = ", ".join(f"{d:.4f}" for d in res.divergences[-1])
        unit = "learner updates" if args.topology == "async" \
            else "iterations"
        print(f"[serve-rl] {args.topology} ({algo}): {args.num_actors} "
              f"actors, sync_every={args.sync_every} {unit}, last "
              f"per-actor divergence [{div}]")
    if args.topology == "async" and res.actor_lags:
        print(f"[serve-rl] async overlap: {len(res.actor_lags)} param "
              f"pushes, mean actor lag "
              f"{sum(res.actor_lags) / len(res.actor_lags):.1f} learner "
              f"updates")
    return algo, env, res


def serve_policy(args, algo: str, env, res) -> Dict[str, Any]:
    """The RL mode's serving: push the trained params into a
    ``PolicyServer`` (calibrated on a greedy rollout with
    ``--calib-batch``), warm it up, and drive ``--serve-sessions``
    sessions for ``--serve-steps`` steps with a hot-swap at the halfway
    step; prints the reference's lines.

    Returns what was served: ``server``, the first ``entry``, the
    hot-swap's ``swap_version``, ``answered`` requests, ``latencies_s``,
    ``actions_per_s`` over the served window, the last step's
    ``last_obs`` and ``last_results``, and the host ``spans`` of each
    step (``(name, t0, t1)`` on ``time.perf_counter``: ``submit``,
    ``wait``, ``env_step``, ``hot_swap``).
    """
    import numpy as np
    import torch

    from repro_torch import serving
    from repro_torch.core import ptq
    from repro_torch.rl import actorq
    from repro_torch.rl.env import batched_env

    device = res.device
    params = res.state.params
    fp32_bytes = ptq.tree_nbytes(params)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    server = serving.PolicyServer(
        env.spec, actor_backend=args.actor_backend, buckets=buckets,
        max_wait_us=args.max_wait_us, calib_batch=args.calib_batch,
        device=device)
    calib_obs = None
    if actorq.is_quantized(args.actor_backend) and args.calib_batch:
        # deploy-time calibration on the states the trained policy
        # visits: a short greedy rollout from reset
        qparams = actorq.pack_actor_params(
            params, actorq.backend_bits(args.actor_backend))
        calib_obs = serving.greedy_calib_obs(env, qparams, args.calib_batch,
                                             args.seed + 1)
    entry = server.push_params(params, calib_obs=calib_obs)
    if calib_obs is not None:
        if actorq.ACT_QUANT in entry.cache:
            print(f"[serve-rl] static requant: calibrated on "
                  f"{calib_obs.shape[0]} obs -> fused single-pass actor")
        else:
            print("[serve-rl] static requant: conv policy -- calibration "
                  "skipped, per-layer path served")
    server.warmup()
    print(f"[serve-rl] env={args.rl_env} algo={algo} "
          f"actor={args.actor_backend} kernel={args.kernel_backend} "
          f"params={fp32_bytes / 1e3:.1f}KB fp32 -> "
          f"{entry.nbytes / 1e3:.1f}KB served "
          f"({fp32_bytes / max(entry.nbytes, 1):.2f}x) "
          f"buckets={list(buckets)} max_wait={args.max_wait_us}us "
          f"device={_device_name(torch, device)}")

    # the sessions: each steps its own env with the actions served to it
    n = args.serve_sessions
    benv = batched_env(env, n)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    e_state, obs = benv.reset(gen, device)
    latencies: List[float] = []
    spans: List[tuple] = []
    swap_version = None
    answered = 0
    o_host, results = None, []
    t0 = time.perf_counter()
    with server:
        sids = [server.open_session() for _ in range(n)]
        for step_i in range(args.serve_steps):
            if step_i == args.serve_steps // 2 and args.serve_steps > 1:
                # live hot-swap under load: a repack and one reference
                # swap; the next dispatch serves the new version
                t_a = time.perf_counter()
                swap_version = server.push_params(params).version
                spans.append(("hot_swap", t_a, time.perf_counter()))
                print(f"[serve-rl] hot-swap at step {step_i}: now serving "
                      f"cache version {swap_version}")
            t_a = time.perf_counter()
            o_host = obs.cpu().numpy()
            reqs = [server.submit(sid, o_host[i])
                    for i, sid in enumerate(sids)]
            t_b = time.perf_counter()
            results = [r.result(timeout=120) for r in reqs]
            t_c = time.perf_counter()
            answered += len(results)
            latencies.extend(r.latency_s for r in results)
            actions = torch.from_numpy(
                np.stack([r.action for r in results])).to(device)
            e_state, obs, _, _ = benv.step(e_state, actions, gen)
            spans += [("submit", t_a, t_b), ("wait", t_b, t_c),
                      ("env_step", t_c, time.perf_counter())]
        for sid in sids:
            server.close_session(sid)
    dt = time.perf_counter() - t0
    stats = server.stats()
    lat = np.asarray(latencies) * 1e3
    print(f"[serve-rl] {n} sessions x {args.serve_steps} steps in "
          f"{dt:.3f}s ({len(latencies) / dt:.0f} actions/s on "
          f"{_device_name(torch, device)}); per-step latency p50 "
          f"{np.percentile(lat, 50):.2f}ms p99 "
          f"{np.percentile(lat, 99):.2f}ms; {stats['dispatches']} "
          f"dispatches, mean batch "
          f"{stats['served'] / max(stats['dispatches'], 1):.1f}, served by "
          f"cache v{stats['version']}")
    print("           first actions:",
          np.asarray(results[0].action).tolist() if env.spec.continuous
          else [int(r.action) for r in results[:8]])
    return dict(server=server, entry=entry, swap_version=swap_version,
                answered=answered, latencies_s=latencies,
                actions_per_s=len(latencies) / dt, last_obs=o_host,
                last_results=results, spans=spans)


def parse_args(argv=None) -> argparse.Namespace:
    """The launcher's flags (both modes)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="h2o-danube-1.8b",
                    help="transformer architecture to decode")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="decoding batch size")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--quant", default="none",
                    help="none | ptq_fp16 | ptq_int8 (weights)")
    ap.add_argument("--int8-cache", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rl-env", default=None,
                    help="serve an RL policy instead of an LM "
                         "(ActorQ deployment; e.g. cartpole, airnav)")
    ap.add_argument("--actor-backend", default="fp32",
                    choices=["fp32", "int8", "int4"],
                    help="int8 = W8A8 packed actor; int4 = byte-packed "
                         "W4A8 (half the served cache)")
    ap.add_argument("--kernel-backend", default="auto",
                    choices=["pallas", "interpret", "ref", "xla", "auto"],
                    help="only auto: the port dispatches its kernels by "
                         "device (the others raise ValueError)")
    ap.add_argument("--calib-batch", type=int, default=0,
                    help="static-requant calibration batch for quantized "
                         "actors: >0 calibrates per-layer activation "
                         "params (training caches at every sync, the "
                         "served cache once at deploy) and runs MLP "
                         "actors as one fused kernel launch; 0 = dynamic "
                         "per-layer quantization")
    ap.add_argument("--rl-iters", type=int, default=20,
                    help="training iterations before serving (--rl-env)")
    ap.add_argument("--steps-per-call", type=int, default=10,
                    help="chunk of the --rl-env training driver")
    ap.add_argument("--topology", default="fused",
                    choices=["fused", "actor-learner", "async"],
                    help="--rl-env training topology; actor-learner and "
                         "async need a replay algorithm, so discrete envs "
                         "train DQN there against PPO under fused")
    ap.add_argument("--num-actors", type=int, default=2,
                    help="actor replicas for the actor-learner topologies")
    ap.add_argument("--sync-every", type=int, default=1,
                    help="learner->actor push cadence: iterations under "
                         "actor-learner, learner updates under async")
    ap.add_argument("--replay", default="uniform",
                    choices=["uniform", "prioritized"],
                    help="--rl-env replay discipline (DQN/DDPG)")
    ap.add_argument("--priority-exponent", type=float, default=0.6,
                    help="PER alpha; 0.0 is bitwise uniform")
    ap.add_argument("--is-beta", type=float, default=0.4,
                    help="initial IS-correction exponent (anneals to 1)")
    ap.add_argument("--serve-sessions", type=int, default=64,
                    help="concurrent env sessions driven against the "
                         "policy server after training (--rl-env)")
    ap.add_argument("--serve-steps", type=int, default=5,
                    help="env steps each serving session takes (a live "
                         "hot-swap fires at the halfway step)")
    ap.add_argument("--buckets", default="8,32,128,512",
                    help="ascending padded batch shapes (largest = "
                         "admission max batch)")
    ap.add_argument("--max-wait-us", type=int, default=2000,
                    help="admission straggler wait (the tail-latency "
                         "knob; 0 = never wait)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint the training phase here")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="iterations between training checkpoints")
    ap.add_argument("--resume", action="store_true",
                    help="resume training from the newest checkpoint in "
                         "--ckpt-dir before serving")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    """Parse ``argv``, then decode (LM mode) or train and serve a policy
    (``--rl-env``), and print; 0 on success."""
    args = parse_args(argv)
    if args.rl_env:
        serve_policy(args, *train_policy(args))
        return 0

    import torch

    from repro_torch.configs import base as cfgs
    from repro_torch.core import ptq
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer

    device = resolve_device(args.device)
    cfg = cfgs.get_reduced(args.arch) if args.reduced else cfgs.get(args.arch)
    quant = QuantConfig.parse(args.quant)
    if args.int8_cache:
        cfg = dataclasses.replace(
            cfg, quant=dataclasses.replace(cfg.quant, int8_kv_cache=True))

    # drawn on the device: the CPU's draws of a full config's billions
    # of normals take seconds a billion, the card's a fraction of that
    params = transformer.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    fp32_bytes = ptq.tree_nbytes(params)
    if quant.is_ptq:
        params = ptq.ptq_simulate(params, quant)    # simulated int math
    print(f"[serve] {cfg.name} quant={quant.label()} "
          f"int8_cache={cfg.quant.int8_kv_cache} "
          f"params={fp32_bytes / 1e6:.1f}MB fp32"
          + (f" -> {fp32_bytes / 4 / 1e6:.1f}MB int8 packed"
             if quant.mode.value == "ptq_int" else ""))

    total_len = args.prompt_len + args.new_tokens
    caches = transformer.init_caches(cfg, args.batch, total_len,
                                     device=device)
    gen = torch.Generator().manual_seed(args.seed)
    tokens = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen).to(device)
    # the encoder / vision frontend's stub embeddings, fed to every step
    enc = None
    if cfg.cross_attn or cfg.encoder_layers:
        enc = (torch.randn((args.batch, max(cfg.encoder_seq, 4),
                            cfg.d_model), generator=gen) * 0.02).to(device)

    # prompt token by token (teacher forcing), then greedy decode; the
    # positions live on the device, so no step waits on a host copy
    positions = torch.arange(total_len, device=device)
    with torch.no_grad():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out_tokens = []
        tok = tokens[:, :1]
        for pos in range(total_len - 1):
            logits, caches = transformer.decode_step(
                cfg, params, tok, caches, positions[pos], encoder_out=enc)
            nxt = torch.argmax(logits[:, -1], -1)
            tok = tokens[:, pos + 1:pos + 2] if pos + 1 < args.prompt_len \
                else nxt[:, None]
            if pos + 1 >= args.prompt_len:
                out_tokens.append(nxt)
        first = [int(t[0]) for t in out_tokens]          # syncs the card
        dt = time.perf_counter() - t0
    name = _device_name(torch, device)
    n_gen = args.batch * len(out_tokens)
    print(f"[serve] generated {len(out_tokens)} tokens x {args.batch} seqs "
          f"in {dt:.4f}s ({n_gen / dt:.1f} tok/s on {name})")
    print("        first sequence:", first[:16])
    return 0


if __name__ == "__main__":
    sys.exit(main())
