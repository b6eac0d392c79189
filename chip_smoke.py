#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one H100.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each kernel against its plain PyTorch version on the card (the
integer GEMMs, the fake quantizer and its QAT site kernel bitwise, the
int8-cache and the flash attention within 1e-5) at the shapes its paths
give it (B1's rollout and calibration shapes recorded from the paths
themselves; B3 also at danube's decode shapes, reading the LM's strided
cache in place) and times both, then drives the port's four paths:

* serving -- ``PolicyServer`` answering batched AirNav sessions through
  the ActorQ int8 / int4 policy: every request answered, the hot-swap
  moves the version, the served actions equal the plain version's;
* sequence-actor rollouts -- the int8 / int4 KV-cache transformer actor
  (and the fp32 windowed one) collecting DQN behaviour-policy rollouts
  over 512 frame-stacked flickering AirNav envs: the Q-values match a CPU
  replay of the same step and a finished env's cache is reset; then an
  evaluation, and the windowed and cached actors held to the reference's
  contract on a catch_seq episode (and compared on an airnav_seq one);
* training -- ``loops.train`` runs DQN on CartPole (MLP 4-64-64-2, the
  reference's defaults, 200 iterations, the QAT run 100): QAT int8
  (every fake-quant site one launch of kernel B5's site kernel), the
  ActorQ int4 and int8 actors with calibrated
  caches (rollouts through kernel B2) and the fp32 baseline, then
  ``quarl_ptq`` evaluates the fp32 run at int8 and fp16; the eval
  rewards are held to the bars stated in ``PERF.md``, one TD update of
  the QAT run is replayed on the CPU (within 1e-5), and a profiled QAT
  iteration launches at most ``QAT_KERNEL_RATIO`` times the kernels of
  an fp32 one;
* the topologies -- ``loops.train`` runs the same DQN CartPole net with 4
  actors of 8 envs for 100 iterations, a push every 16 learner updates:
  the actor-learner topology with int8 actors (kernel B1), async with
  int8 actors (B1), int4 calibrated actors (B2) and fp32 actors, each
  held to its launch counts, a reward bar of 100, finite per-actor
  divergences and actor lags, and profiled per CUDA stream over two
  rounds (for async, the share of the round with kernels of both streams
  running); first, on the card, actor-learner with one actor is held
  bitwise to the fused driver and async in barrier mode bitwise to
  actor-learner;
* the algorithms -- ``loops.train`` runs PPO and A2C on CartPole and
  DDPG on Pendulum with their reference defaults: PPO fp32, ActorQ int8
  (B1 3 a forward), int4 calibrated (B2) and QAT int8 (B5), A2C fp32 and
  int8, DDPG fp32, int8, int4 calibrated, QAT int8, prioritized, and
  in the actor-learner and async topologies (4 actors x 8 envs), each
  with exact launch counts and, where the JAX package clears one, its
  bar (PPO fp32 > 100, PPO int8 > 50, A2C fp32 > 50); ``quarl_ptq`` on
  the PPO run; DDPG's three anchors bitwise on the card and one DDPG
  update replayed on the CPU; DDPG with actor and critic at Policy II's
  widths (256, 256, 256), fp32 / int8 / int4 calibrated, 100 iterations
  each in turns and profiled; ``repro_torch.launch.train``'s default
  run (PPO on CartPole); and B1 / B2 bitwise and timed at every shape
  these paths gave them (K 2 and 3, N 1 and 3, B2's width-1 head);
* the sequence actor in training -- ``loops.train`` runs DQN with the
  sequence actor (``d_model`` 32, 2 layers) on masked Catch at the
  reference's configs: the fused smoke and the convergence bar
  (``rewards[-1] >= 0.5`` after 200 iterations) in the fused,
  actor-learner and async topologies with int8 actors (B1 at each dense
  layer, B3 once a block a cached behaviour step), a fused QAT int8 run
  (B5 at the 28 sites of each TD forward), each with exact launch
  counts; the anchors bitwise on the card; one TD update of the QAT and
  of an fp32 run replayed on the CPU within 1e-5; the fp32 windowed,
  int8 and int4 cached and QAT actors timed in turns and profiled;
* checkpoints -- the reference's resume set (DQN on Catch and DDPG on
  Pendulum in the three topologies, prioritized replay, the sequence
  actor fused and async) trained to 3 with checkpoints, resumed to 6,
  and held bit for bit to the run to 6 that saved nothing, with the
  host time of each save and restore and the bytes of each checkpoint;
  ``repro_torch.launch.train`` with ``--ckpt-dir`` and then
  ``--resume``;
* the self-healing runtime -- the reference's chaos matrix (DQN on
  CartPole, int8 actors through B1) in the three topologies under the
  supervisor, every planned fault fired or recorded not applicable as in
  the reference; its retry and rollback cases and its 60-iteration
  convergence case bitwise their clean runs; its abort ladder; the
  actor-learner int8 run guarded against bare in turns; a
  ``PolicyServer`` shedding a burst with ``QueueFullError`` and
  restarting a crashed worker; ``launch.train --fault-plan``;
* RL serving -- ``repro_torch.launch.serve --rl-env`` trains and serves
  three configurations (CartPole async int4 calibrated through B2,
  AirNav int8 at 512 sessions and Pendulum's DDPG int8 through B1), each
  answering every request, moving the version at the hot-swap, with
  exact B1 / B2 counts and one dispatch bitwise its plain replay, and
  the host's stalls between dispatches set beside its spans and the
  garbage collector's passes;
* the conv actor -- the paper's Atari conv actor (3 conv + FC, its
  Policies A, B and C) on pixel Catch: each int8 / int4 actor's forward at
  8 and 256 envs bitwise its plain replay on the card (B1 five times a
  forward: three im2col convs, the fc and the head), fp32 through cuDNN,
  each within 1e-4 of the CPU at 8 envs, timed, profiled and rolled out
  for 100 steps; ``loops.train`` DQN on Catch at Policy A width (fp32,
  ActorQ int8 and int4, QAT int8 with exact B1 / B5 counts, one TD update
  replayed on the CPU), the async int8 Catch run of
  ``tests/test_async_actor_learner.py:215-228`` held to its bar, the
  three anchors bitwise at a small conv net, and B1 bitwise and timed at
  every shape these paths gave it (K 9 to 102,400);
* the LM -- ``transformer.prefill`` of h2o-danube-1.8b at full width and
  depth over 8,192 prompt tokens (every layer's attention through kernel
  B4), its 64-token logits held against the port's CPU path and against
  64 token-by-token decode steps, one decode step at a 4,096-token
  context over full int8 caches (B3 once a layer, the logits held to
  the same step through B3's plain version) and float32 caches, both
  profiled, then greedy decoding through
  ``repro_torch.launch.serve.main`` with an fp32 cache, an int8 cache
  (kernel B3) and PTQ int8 weights (kernel B5);

and checks that each path really launched its kernels.  Any failed check
raises.  The last line of standard output is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

the line before it the card's name and power limit, and the one before
that a JSON object listing every ported kernel with its launches on the
path it serves (serving for B1 and B2, the sequence-actor rollouts for
B3, the QAT training run for B5, the LM prefill for B4), its largest
difference from the plain
version and its times.  All rows are also written to
``chiprun_out/chip_smoke.json``.  Without CUDA, or outside the repository,
it exits with code 2 and prints no result.
"""
from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, int8 ops/s,
# float32 flop/s outside the tensor cores, TF32 flop/s on them
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12

BUCKETS = (8, 32, 128, 512)
SESSIONS, STEPS, SWAP_AT = 512, 200, 100
# each backend is served twice, in this order and then reversed, so that
# no backend always runs first or last on a host shared with others
SERVE_RUNS = (("int8", 0), ("int4", 64), ("fp32", 0))
SEED = 0
# the sequence actor the repo trains and benchmarks
# (tests/test_seq_policy.py:350, benchmarks/transformer_actor.py:30)
SEQ_NET = {"d_model": 32, "n_layers": 2, "d_ff": 64}
ROLL_ENVS, ROLL_STEPS = 512, 240          # two 120-step horizons
ROLL_RUNS = ("int8", "int4", "fp32")      # run in this order, then reversed
SAMPLE_STEPS = (0, 60, 119, 120, 239)     # CPU replays of the card's step
REPLAY_ATOL = 1e-4
# a flipped dynamic activation code moves Q by about one activation step
# times a weight (largest measured across packages on the CPU: 1.93e-3)
FLIP_ATOL = 5e-3
# B1 launches per env step: embed, q k v o fc proj per block, head
DENSE_PER_STEP = 1 + 6 * SEQ_NET["n_layers"] + 1
# B5 at the sites of the training path and beyond (label, shape): the
# CartPole net's weights, its activations at the TD batch (64) and the
# rollout batch (8 envs), the deployment policies' widest weights, odd
# sizes, and degenerate inputs
FQ_ROWS = (("cartpole fc0/w", (4, 64)), ("cartpole fc1/w", (64, 64)),
           ("cartpole out/w", (64, 2)), ("td fc/out", (64, 64)),
           ("td out/out", (64, 2)), ("rollout fc/out", (8, 64)),
           ("Policy II", (512, 256)), ("Policy III", (4096, 512)),
           ("odd", (1,)), ("odd", (7, 13)), ("odd", (2 ** 20 + 3,)),
           ("zeros", (8, 64)), ("positive", (64, 2)), ("ties", (4, 64)))
# B5's QAT site kernel at the CartPole net's sites (its weights, its
# activations at the TD batch of 64 and the rollout batch of 8 envs) and
# at Policy II's width: (label, site, shape)
SITE_ROWS = (("cartpole fc0/w", "weight", (4, 64)),
             ("cartpole fc1/w", "weight", (64, 64)),
             ("cartpole out/w", "weight", (64, 2)),
             ("td fc/out", "activation", (64, 64)),
             ("td out/out", "activation", (64, 2)),
             ("rollout fc/out", "activation", (8, 64)),
             ("rollout out/out", "activation", (8, 2)),
             ("Policy II", "activation", (512, 256)),
             ("Policy II", "weight", (512, 256)),
             # the sequence actor's sites (SEQ_NET on catch_seq's 6 x 27
             # stacks) at the TD batch of 32 and the 8 behaviour envs
             ("seq td embed/out", "activation", (32, 6, 32)),
             ("seq td fc/out", "activation", (32, 6, 64)),
             ("seq td head/out", "activation", (32, 3)),
             ("seq rollout blk/q/out", "activation", (8, 6, 32)),
             ("seq embed/w", "weight", (27, 32)),
             ("seq fc/w", "weight", (32, 64)),
             ("seq head/w", "weight", (32, 3)))
SITE_DELAY = 6                    # steps 5, 6, 9: before, at, after it
# kernels a profiled QAT iteration may launch per fp32 iteration: fp32's
# plus 6 site launches a forward (PERF.md, sections 2 and 5)
QAT_KERNEL_RATIO = 1.15
# the training phase: DQN on CartPole with the reference's defaults and
# the bar run of tests/test_fused_qmlp.py:300-307
# (200 of the reference's 400 iterations, to hold the script's time: the
# records at 50-200 are the same, bit for bit, and each run clears its bar
# by iteration 200, PERF.md)
TRAIN_ITERS, TRAIN_RECORD, TRAIN_SPC = 200, 50, 5
QAT_DELAY = 200                   # TD updates: iteration 25
# the QAT run takes 100 iterations, for time: quantization still turns
# on at iteration 25, and its bar is 9.0
QAT_TRAIN_ITERS = 100
# bars on max(eval rewards), stated in PERF.md before the first chip run:
# 100 where the JAX package clears it on the CPU with this config; the
# JAX package's QAT run collapses to about 9.4 once quantization turns
# on (ROADMAP queue C), so the QAT run is held to 9.0, the bar it clears
TRAIN_BARS = {"qat8": 9.0, "actorq_int4": 100.0, "actorq_int8": 100.0,
              "fp32": 100.0}
TD_ATOL = 1e-5
# the topology phase: DQN on CartPole at full width with the reference's
# defaults, 4 actors x 8 envs, 100 iterations, seed SEED, and one
# staleness in both topologies: a push every 16 learner updates (the
# actor-learner topology's 2 iterations of 8; async rounds of 2 rollouts
# and 16 updates)
# (100 of the reference's 400 iterations, for time: the records at 50 and
# 100 are the same, bit for bit, and each run clears its bar by 100,
# PERF.md)
TOPO_ACTORS, TOPO_ITERS, TOPO_RECORD, ASYNC_SPC = 4, 100, 50, 2
TOPO_RUNS = (
    ("al_int8", dict(topology="actor-learner", sync_every=2,
                     actor_backend="int8", steps_per_call=TRAIN_SPC)),
    ("async_int8", dict(topology="async", sync_every=16,
                        actor_backend="int8", steps_per_call=ASYNC_SPC)),
    ("async_int4", dict(topology="async", sync_every=16,
                        actor_backend="int4", calib_batch=32,
                        steps_per_call=ASYNC_SPC)),
    ("async_fp32", dict(topology="async", sync_every=16,
                        steps_per_call=ASYNC_SPC)))
# max eval reward of the JAX package on the CPU at each run's config
# (PERF.md, section 6): every one clears 100, so every run is held to 100
TOPO_JAX_MAX = {"al_int8": 500.0, "async_int8": 358.375,
                "async_int4": 312.25, "async_fp32": 500.0}
TOPO_BAR = 100.0
# the bitwise anchors' config (tests/test_actor_learner.py:31)
SMALL_DQN = dict(n_envs=4, rollout_steps=4, updates_per_iter=2,
                 buffer_size=512, batch_size=16, warmup=8)
# the LM phase: h2o-danube-1.8b (src/repro/configs/h2o_danube_1_8b.py, the
# serve launcher's default --arch) at full width and depth, random weights
# from SEED
LM_ARCH, LM_REDUCED = "h2o-danube-1.8b", False
LM_PREFILL = (1, 8192)            # batch x prompt: twice the 4096 window
LM_SHORT = 64                     # the CPU and token-by-token comparisons
# the card's 64-token prefill logits against the port's CPU path on the
# same params: cuBLAS and the CPU's BLAS, and B4 against the dense plain
# version, sum in other orders through 24 layers (PERF.md gives the
# measured difference)
LM_CPU_ATOL = 1e-3
LM_DECODE_ATOL = 2e-2             # tests/test_arch_smoke.py:155-186
# the reference serve launcher's defaults (src/repro/launch/serve.py:
# 192-198): batch 4, prompt 32, 32 new tokens, three ways
LM_SERVE_ARGS = ["--arch", LM_ARCH, "--batch", "4", "--prompt-len", "32",
                 "--new-tokens", "32", "--seed", str(SEED)]
LM_SERVE_RUNS = (("fp32 cache", []), ("int8 cache", ["--int8-cache"]),
                 ("ptq_int8", ["--quant", "ptq_int8"]))
# B4 at the shapes of its paths: (label, B, H, KV, S, T, D, causal,
# window, softcap); the gemma2 rows are its attention shape only
FLASH_ROWS = (
    ("danube prefill", 1, 32, 8, 8192, 8192, 80, True, 4096, None),
    ("gemma2 local", 1, 16, 8, 8192, 8192, 256, True, 4096, 50.0),
    ("gemma2 global", 1, 16, 8, 8192, 8192, 256, True, None, 50.0),
    ("whisper encoder", 1, 6, 6, 1500, 1500, 64, False, None, None),
    ("end-aligned", 1, 32, 8, 8, 4096, 80, True, None, None),
    ("ragged", 1, 32, 8, 1000, 1000, 80, True, None, None))
FLASH_ATOL = 1e-5                 # docs/contracts.md, "Attention parity"
# B3 at the shapes of its paths: (label, NB, NH, G, T, Dh, window, pos,
# layout).  "rows" is the sequence actor's (R, T, Dh) cache, R = NB * NH;
# "lm" the LM's (NB, T, NH, Dh) cache read through transpose(1, 2), as
# its decode step reads it: danube's 4 x 8 KV heads at the 4,096-slot ring
# (the window) and at the serve default of 64 slots
CACHE_ROWS = (
    ("airnav_seq", 1, ROLL_ENVS, 1, 121, 32, 8, "ragged", "rows"),
    ("airnav_seq", 1, ROLL_ENVS, 1, 121, 32, 8, "last", "rows"),
    ("catch_seq", 1, ROLL_ENVS, 1, 8, 32, 6, "ragged", "rows"),
    # the seq_train phase's behaviour steps: SEQ_ALGO's 8 envs, and 2
    # actors of 8
    ("catch_seq train", 1, 8, 1, 8, 32, 6, "ragged", "rows"),
    ("catch_seq train 2 actors", 1, 16, 1, 8, 32, 6, "ragged", "rows"),
    ("long", 1, 8, 4, 4096, 128, None, "last", "rows"),
    ("danube decode", 4, 8, 4, 4096, 80, None, "last", "lm"),
    ("danube serve", 4, 8, 4, 64, 80, None, "ragged", "lm"))
CACHE_ATOL = 1e-5                 # docs/contracts.md, "Attention parity"
# the LM decode step at a long context: batch 4 over a full 4,096-slot
# ring (danube's window), its logits held to the same step through B3's
# plain version
LM_LONG = (4, 4096)
LM_LONG_ATOL = 1e-3
# the conv phase: the paper's Atari conv actor (Appendix B; Policies A/B/C
# of Table 10, src/repro/configs/quarl_atari.py:29-32, the port's copy in
# src/repro_torch/configs/quarl_atari.py) on pixel Catch (10x10x1, 3
# actions): the forward at DQNConfig's 8 behaviour envs and at the 256 of
# benchmarks/actor_throughput.py:45-49, a 100-step rollout of each
CONV_ENVS = (8, 256)
# the rollouts take the backends in this order, reversed at every other
# (policy, envs) cell, so no backend always runs first
CONV_BACKENDS = ("fp32", "int8", "int4")
CONV_ROLL_STEPS = 50
CONV_CPU_ATOL = 1e-4              # the card's forward against the CPU's
# DQN on Catch at Policy A width (ATARI_DQN) with DQNConfig's defaults:
# (name, loops.train keywords); the QAT run's delay is QAT_DELAY
# (30 iterations, for time: the QAT run is 40 TD updates past its delay)
CONV_TRAIN_ITERS, CONV_TRAIN_RECORD = 30, 15
CONV_TRAIN_RUNS = (("qat8", {}), ("actorq_int4", dict(actor_backend="int4")),
                   ("actorq_int8", dict(actor_backend="int8")),
                   ("fp32", {}))
# bars on max(eval rewards): set only where the JAX package clears them on
# the CPU at the same config (tools/jax_catch_rewards.py; PERF.md)
CONV_TRAIN_BARS = {}
# A7's convergence bar, verbatim (tests/test_async_actor_learner.py:
# 215-228): async int8 on Catch, held to max(rewards) > A7_BAR
A7_RUN = dict(topology="async", num_actors=2, sync_every=16,
              steps_per_call=4, actor_backend="int8", iterations=800,
              record_every=100, eval_episodes=16, seed=0,
              net_kwargs=dict(conv_filters=(8, 8), fc_width=32),
              algo_overrides=dict(n_envs=8, rollout_steps=8,
                                  updates_per_iter=4, buffer_size=8192,
                                  batch_size=32, warmup=256,
                                  eps_decay_updates=800,
                                  target_update_every=100))
A7_BAR = 0.0
# the algo phase: PPO and A2C on CartPole, DDPG on Pendulum, each with its
# config's defaults (the reference's PPOConfig, A2CConfig, DDPGConfig):
# (name, algo, env, bar on max(eval rewards), loops.train keywords;
# "qat_delay" makes a QAT int8 run).  The bars and their configs are the
# JAX package's own on the CPU: PPO fp32 > 100 at seed 3 and A2C fp32 > 50
# at seed 1 (tests/test_rl.py:175-184), PPO int8 > 50 at seed 0
# (tests/test_actor_learner.py:369-382), QAT PPO with delay 10
# (tests/test_rl.py:196-202), DDPG finite (40 iterations there; 20 here,
# for time)
# (tests/test_rl.py:191-194; its int8 bar is red in the JAX package,
# ROADMAP queue C, so DDPG's rewards are recorded, not held).  DDPG's
# topologies: 4 actors x 8 envs, a push every 16 learner updates, as the
# topology phase's.
ALGO_RUNS = (
    # (40 of their 120 iterations, for time: the record at 40 is the
    # same, bit for bit, and clears the bars, PERF.md)
    ("ppo_fp32", "ppo", "cartpole", 100.0,
     dict(iterations=40, record_every=40, seed=3)),
    ("ppo_int8", "ppo", "cartpole", 50.0,
     dict(iterations=40, record_every=40, seed=0, actor_backend="int8")),
    ("ppo_int4_calib", "ppo", "cartpole", None,
     dict(iterations=20, record_every=10, seed=0, actor_backend="int4",
          calib_batch=16)),
    ("ppo_qat8", "ppo", "cartpole", None,
     dict(iterations=30, record_every=15, seed=0, qat_delay=10)),
    ("a2c_fp32", "a2c", "cartpole", 50.0,
     dict(iterations=500, record_every=250, seed=1)),
    ("a2c_int8", "a2c", "cartpole", None,
     dict(iterations=100, record_every=50, seed=0, actor_backend="int8")),
    ("ddpg_fp32", "ddpg", "pendulum", None,
     dict(iterations=20, record_every=10, seed=0)),
    ("ddpg_int8", "ddpg", "pendulum", None,
     dict(iterations=20, record_every=10, seed=0, actor_backend="int8")),
    ("ddpg_int4_calib", "ddpg", "pendulum", None,
     dict(iterations=20, record_every=10, seed=0, actor_backend="int4",
          calib_batch=8)),
    ("ddpg_qat8", "ddpg", "pendulum", None,
     dict(iterations=20, record_every=10, seed=0, qat_delay=100)),
    ("ddpg_per", "ddpg", "pendulum", None,
     dict(iterations=20, record_every=10, seed=0, replay="prioritized")),
    ("ddpg_al_int8", "ddpg", "pendulum", None,
     dict(iterations=20, record_every=10, seed=0, topology="actor-learner",
          num_actors=4, sync_every=2, actor_backend="int8",
          steps_per_call=TRAIN_SPC)),
    ("ddpg_async_int8", "ddpg", "pendulum", None,
     dict(iterations=20, record_every=10, seed=0, topology="async",
          num_actors=4, sync_every=16, actor_backend="int8",
          steps_per_call=ASYNC_SPC)))
# DDPG's anchors' config (tests/test_prioritized_replay.py:32)
SMALL_DDPG = dict(n_envs=4, rollout_steps=4, updates_per_iter=2,
                  buffer_size=512, batch_size=16, warmup=8)
# DDPG at Policy II's widths (Table 5): iterations each, in chunks taken
# in turns
ALGO_WIDE_ITERS, ALGO_WIDE_CHUNK = 20, 5   # cut from 40, 10 for time
# the launcher's default run (PPO on CartPole), these of its default 200
# iterations, for time
ALGO_LAUNCH_ITERS = 40
# the seq_train phase: DQN with the sequence actor (SEQ_NET) on catch_seq
# at the reference's configs (tests/test_seq_policy.py:318-351): the
# fused smoke, then the convergence bar in the three topologies, held to
# rewards[-1] >= SEQ_BAR (the JAX package clears it on the CPU in all
# three: PERF.md)
SEQ_ALGO = dict(n_envs=8, rollout_steps=8, updates_per_iter=4,
                buffer_size=4096, batch_size=32, warmup=64,
                eps_decay_updates=600, target_update_every=50, lr=1e-3)
SEQ_SMOKE = dict(n_envs=2, rollout_steps=2, updates_per_iter=1,
                 buffer_size=64, batch_size=8, warmup=8)
# (200 of the reference's 300 iterations, for time, at its record cadence
# of 50: the records at 50-200 are the same, bit for bit, and
# rewards[-1] is 1.0 at 200 in all three topologies, PERF.md)
SEQ_BAR_ITERS, SEQ_BAR_RECORD, SEQ_BAR = 200, 50, 0.5
# the fused QAT int8 run that counts B5: quantization on from TD update
# SEQ_QAT_DELAY (iteration 10 of 30)
SEQ_QAT_ITERS, SEQ_QAT_DELAY = 30, 40
# fp32 (windowed), int8 and int4 (cached) and QAT (the windowed fp32 actor
# under the context) at SEQ_ALGO, iterations each in chunks taken in turns
SEQ_TIME_RUNS = (("fp32", {}), ("int8", dict(actor_backend="int8")),
                 ("int4", dict(actor_backend="int4")),
                 ("qat8", dict(qat_delay=SEQ_QAT_DELAY)))
SEQ_TIME_ITERS, SEQ_TIME_CHUNK = 10, 5     # cut from 20, 10 for time
# the resume phase: tests/test_resume.py:31-99 at its small config (Catch
# with hidden=(16,) is the default conv net), each case trained to
# RESUME_AT with checkpoints, resumed to RESUME_TO, and held bitwise to the
# run to RESUME_TO that had no checkpoint directory
RESUME_SMALL = dict(n_envs=2, rollout_steps=2, updates_per_iter=2,
                    buffer_size=64, batch_size=8, warmup=8)
RESUME_SEQ = {"transformer": dict(d_model=16, n_layers=1, d_ff=32)}
RESUME_CASES = tuple(
    (f"{algo} {env} {topo}", algo, env, topo, {})
    for algo, env in (("dqn", "catch"), ("ddpg", "pendulum"))
    for topo in ("fused", "actor-learner", "async")) + (
    ("dqn catch actor-learner prioritized", "dqn", "catch", "actor-learner",
     dict(replay="prioritized", priority_exponent=0.6)),
    ("dqn catch_seq fused", "dqn", "catch_seq", "fused",
     dict(net_kwargs=RESUME_SEQ)),
    ("dqn catch_seq async", "dqn", "catch_seq", "async",
     dict(net_kwargs=RESUME_SEQ)))
RESUME_AT, RESUME_TO = 3, 6
# the resilience phase: tests/test_resilience.py's _kwargs config (DQN on
# CartPole, a 16-wide MLP, int8 actors through B1) under its MATRIX
# plans, its retry, rollback and abort cases, its 60-iteration
# convergence case at the default MLP (4-64-64-2), the topology phase's
# actor-learner int8 run guarded against bare (RZ_OVERHEAD_ITERS each, in
# turns), and the hardened server
RZ_SMALL = dict(n_envs=2, rollout_steps=2, updates_per_iter=2,
                buffer_size=64, batch_size=8, warmup=8)
RZ_MATRIX = (
    ("fused",
     "5:actor_crash@2,straggler@3:delay_s=0.01,nan_grad@4,"
     "bitflip_push@4,crash_commit@3,dropped_sync@2",
     {"actor_crash", "straggler", "nan_grad", "bitflip_push",
      "crash_commit"}, {"dropped_sync"}),
    ("actor-learner",
     "7:actor_crash@2,straggler@3:delay_s=0.01,nan_grad@5:mode=inf,"
     "bitflip_push@4,crash_commit@3,dropped_sync@2",
     {"actor_crash", "straggler", "nan_grad", "bitflip_push",
      "crash_commit"}, {"dropped_sync"}),
    ("async",
     "9:actor_crash@2,straggler@3:delay_s=0.01,nan_grad@5,"
     "bitflip_push@4,crash_commit@3,dropped_sync@6",
     {"actor_crash", "straggler", "nan_grad", "bitflip_push",
      "crash_commit", "dropped_sync"}, set()))
RZ_CONVERGE_PLAN = "11:actor_crash@5,nan_grad@10,bitflip_push@15," \
    "crash_commit@12"
RZ_OVERHEAD_ITERS, RZ_OVERHEAD_RECORD = 40, 20
# the load-shedding burst: offered at SHED_FACTOR x the rate the server
# sustains with a full queue, for SHED_S seconds, against a bound of
# SHED_QUEUE requests.  The server is a straggler (its fault hook sleeps
# SHED_DELAY_S a batch, at most 32 rows), so the rate it sustains is one
# a Python submitter sharing its interpreter lock can offer twice over
SHED_FACTOR, SHED_S, SHED_QUEUE, SHED_BUCKETS = 2.0, 0.5, 256, (8, 32)
SHED_DELAY_S = 0.005
# the serve_rl phase: launch.serve --rl-env, the reference launcher's
# example (async int4 calibrated, B2), AirNav at its 512-session serving
# contract (int8 uncalibrated, B1; 200 steps, the serve phase's window,
# so the host's stalls can show) and Pendulum's DDPG actor (int8, B1)
SERVE_RL_RUNS = (
    ("cartpole async int4 calibrated",
     ["--rl-env", "cartpole", "--topology", "async", "--actor-backend",
      "int4", "--calib-batch", "64", "--serve-sessions", "256",
      "--serve-steps", "4"]),
    ("airnav int8", ["--rl-env", "airnav", "--actor-backend", "int8",
                     "--serve-sessions", "512", "--serve-steps", "200"]),
    ("pendulum ddpg int8", ["--rl-env", "pendulum", "--actor-backend",
                            "int8"]))
STALL_MS = 50.0


def quarl_atari():
    """The paper's policy configs (deployment MLPs I-III of Table 5, conv
    Policies A-C of Table 10): the port's copy of
    ``src/repro/configs/quarl_atari.py``, a data module, loaded by its path
    so the tools that import this script against another tree's ``src``
    read this tree's configs."""
    path = ROOT / "src" / "repro_torch" / "configs" / "quarl_atari.py"
    spec = importlib.util.spec_from_file_location("_quarl_atari", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bound(nbytes: float, ops: float, ops_per_s: float = INT8_OPS_PER_S):
    """Least time (ms) the card could take, and what sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def device_ms(torch, fn, reps: int = 15, per_rep: int = 10) -> float:
    """Median device time of one call of ``fn`` (ms), by CUDA events.

    Each rep first parks the stream on a sleep kernel so the host can
    enqueue ``per_rep`` calls back to back; the events then time the
    calls' device work, not the host's launch cost.  The sleep lasts
    twice the host's measured enqueue time of ``per_rep`` calls (in
    cycles at 2 GHz, the H100's top clock, so at a lower clock it lasts
    longer), and at least 1e6 cycles.
    """
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(per_rep):
        fn()
    enqueue_s = time.perf_counter() - t
    torch.cuda.synchronize()
    sleep_cycles = int(max(2.0 * enqueue_s * 2e9, 1e6))
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(per_rep):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_rep)
    return statistics.median(times)


def profile_calls(torch, fn, n: int = 20, match: str = "") -> dict:
    """Where ``n`` calls of ``fn`` spend their time, from ``torch.profiler``.

    Returns the host wall time per call, the device time per call
    (kernels summed), the device's busy share of the wall time, kernels
    launched per call, the five kernels that took most device time, and
    with ``match`` the device time per call of the kernels whose name
    holds it.  Device numbers are ``None`` when the trace holds no device
    events.
    """
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / n
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    matched = sum(e.self_device_time_total for e in kernels
                  if match and match in e.key) / 1e3 / n
    return dict(
        host_ms_per_call=wall_ms,
        device_ms_per_call=dev_ms if kernels else None,
        device_busy_share=dev_ms / wall_ms if kernels else None,
        kernels_per_call=sum(e.count for e in kernels) / n,
        top=[[e.key[:60], e.self_device_time_total / 1e3 / n]
             for e in top],
        matched_device_ms_per_call=matched if kernels and match else None)


def profile_dispatch(torch, server, obs_host, n: int = 20) -> dict:
    """``profile_calls`` over ``n`` dispatches of ``obs_host`` through the
    server's act path."""
    cache = server.current.cache
    p = profile_calls(torch, lambda: server._act(cache, obs_host), n)
    return dict(
        bucket=int(obs_host.shape[0]),
        host_ms_per_dispatch=p["host_ms_per_call"],
        device_ms_per_dispatch=p["device_ms_per_call"],
        device_busy_share=p["device_busy_share"],
        kernels_per_dispatch=p["kernels_per_call"], top=p["top"])


def fake_quant_rows(torch, dev, gen) -> list:
    """Kernel B5 against its plain version at ``FQ_ROWS`` x bits 2, 4, 8:
    bitwise, and timed beside the plain version and
    ``torch.fake_quantize_per_tensor_affine`` (which rounds ``x * (1 /
    scale)`` and so differs at ties: a yardstick of time only)."""
    from repro_torch.core import affine
    from repro_torch.kernels import fake_quant
    rows = []
    for label, shape in FQ_ROWS:
        for bits in (2, 4, 8):
            if label == "zeros":
                x = torch.zeros(shape, device=dev)
            elif label == "positive":
                x = (torch.rand(shape, generator=gen) + 0.5).to(dev)
            elif label == "ties":      # x / delta = k + 0.5 on (-32, 32)
                k = torch.randint(-100, 100, shape, generator=gen)
                x = ((k.to(torch.float32) + 0.5) * (64.0 / 2 ** bits)
                     ).to(dev)
            else:
                x = (torch.randn(shape, generator=gen) * 1.7).to(dev)
            if label == "ties":
                lo = torch.tensor(-32.0, device=dev)
                hi = torch.tensor(32.0, device=dev)
            else:     # the activation sites clip: a range inside x's own
                lo = torch.clamp(x.amin(), max=0.0) * 0.9
                hi = torch.clamp(x.amax(), min=0.0) * 0.8
            got = fake_quant.fake_quant_cuda(x, lo, hi, bits)
            want = fake_quant.fake_quant_plain(x, lo, hi, bits)
            torch.cuda.synchronize()
            same = torch.equal(got, want)
            err = float((got - want).abs().max())
            check(same, f"fake_quant {label} {list(shape)} bits={bits} "
                        f"bitwise (max abs diff {err})")
            p = affine.affine_params_from_range(lo, hi, bits)
            top = 2 ** bits - 1
            scale = float(p.delta)
            zp = int(min(max(float(p.zero_point), 0), top))

            def lib(x=x, scale=scale, zp=zp, top=top):
                return torch.fake_quantize_per_tensor_affine(x, scale, zp,
                                                             0, top)
            n = x.numel()
            b_ms, b_by = bound(8.0 * n + 8, 8.0 * n, F32_OPS_PER_S)
            rows.append(dict(
                name="fake_quant", label=label, shape=list(shape),
                bits=bits, bitwise=same, max_abs_err=err,
                library_max_abs_diff=float((lib() - want).abs().max()),
                ms=device_ms(torch, lambda: fake_quant.fake_quant_cuda(
                    x, lo, hi, bits)),
                plain_ms=device_ms(torch, lambda: fake_quant.
                                   fake_quant_plain(x, lo, hi, bits)),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=device_ms(torch, lib),
                library="fake_quantize_per_tensor_affine"))
    return rows


def site_rows(torch, dev, gen) -> list:
    """B5's QAT site kernel against its plain version (the composition
    the context ran before: observe, fake quantizer, ``torch.where``) at
    ``SITE_ROWS``, 8 bits: bitwise in every phase (steps before, at and
    after the delay; a fresh and a stored observer), one launch a site up
    to 4,096 elements and two above, timed in the frozen phase beside the
    plain composition and ``torch.fused_moving_avg_obs_fake_quant`` (a
    batch min / max, a moving-average observer gated by device flags, then
    per-tensor fake quantization; it rounds ``x * (1 / scale)`` and leaves
    its range unextended: a yardstick of time only)."""
    from repro_torch.kernels import fake_quant
    rows = []
    for label, site, shape in SITE_ROWS:
        scale = 1.7 if site == "activation" else 0.2
        x = (torch.randn(shape, generator=gen) * scale).to(dev)
        per_site = 1 if x.numel() <= 4096 else 2
        worst, same = 0.0, True
        for step in (SITE_DELAY - 1, SITE_DELAY, SITE_DELAY + 3):
            st = torch.tensor(step, dtype=torch.int32, device=dev)
            for stored in ((False, True) if site == "activation"
                           else (False,)):
                state = ((torch.tensor(-1.25, device=dev),
                          torch.tensor(2.5, device=dev),
                          torch.tensor(True, device=dev)) if stored else
                         (torch.zeros((), device=dev),
                          torch.zeros((), device=dev),
                          torch.zeros((), dtype=torch.bool, device=dev)))
                n0 = fake_quant.launches.value
                if site == "activation":
                    got = fake_quant.activation_site_cuda(
                        x, *state, st, SITE_DELAY, 0.999, 8)
                    want = fake_quant.activation_site_plain(
                        x, *state, st, SITE_DELAY, 0.999, 8)
                else:
                    got = (fake_quant.weight_site_cuda(x, st, SITE_DELAY,
                                                       8),)
                    want = (fake_quant.weight_site_plain(x, st, SITE_DELAY,
                                                         8),)
                got_n = fake_quant.launches.value - n0
                check(got_n == per_site,
                      f"site {label} {list(shape)}: {got_n} launches a "
                      f"site (want {per_site})")
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    same &= bool(torch.equal(g, w))
                    worst = max(worst, float((g.to(torch.float32) - w.to(
                        torch.float32)).abs().max()))
                check(same, f"site {label} {site} {list(shape)} step {step} "
                            f"stored {stored}: bitwise (max abs diff "
                            f"{worst})")
        # timed in the frozen phase: a stored observer past the delay
        st = torch.tensor(SITE_DELAY + 3, dtype=torch.int32, device=dev)
        state = (torch.tensor(-1.25, device=dev),
                 torch.tensor(2.5, device=dev),
                 torch.tensor(True, device=dev))
        if site == "activation":
            def kern(x=x, st=st, state=state):
                return fake_quant.activation_site_cuda(
                    x, *state, st, SITE_DELAY, 0.999, 8)

            def plain(x=x, st=st, state=state):
                return fake_quant.activation_site_plain(
                    x, *state, st, SITE_DELAY, 0.999, 8)
        else:
            def kern(x=x, st=st):
                return fake_quant.weight_site_cuda(x, st, SITE_DELAY, 8)

            def plain(x=x, st=st):
                return fake_quant.weight_site_plain(x, st, SITE_DELAY, 8)
        # the library's observer: off for the frozen activation site, on
        # with averaging constant 1 (the batch range) for a weight site
        on = torch.ones(1, dtype=torch.long, device=dev)
        observer = (torch.zeros(1, dtype=torch.long, device=dev)
                    if site == "activation" else on)
        lib_state = (torch.tensor([-1.25], device=dev),
                     torch.tensor([2.5], device=dev),
                     torch.ones(1, device=dev),
                     torch.zeros(1, dtype=torch.int32, device=dev))
        averaging = 1.0 - 0.999 if site == "activation" else 1.0

        def lib(x=x, observer=observer, on=on, lib_state=lib_state,
                averaging=averaging):
            return torch.fused_moving_avg_obs_fake_quant(
                x, observer, on, *lib_state, averaging, 0, 255, 0)
        n = x.numel()
        # x read once, out written once, the step and the state
        b_ms, b_by = bound(8.0 * n + 32, 10.0 * n, F32_OPS_PER_S)
        rows.append(dict(
            name="fake_quant", kernel="site", label="site " + label,
            site=site, shape=list(shape), bits=8, bitwise=same,
            max_abs_err=worst, launches_per_site=per_site,
            ms=device_ms(torch, kern), plain_ms=device_ms(torch, plain),
            bound_ms=b_ms, bound_by=b_by, library_ms=device_ms(torch, lib),
            library="fused_moving_avg_obs_fake_quant"))
    return rows


def b1_row(torch, dev, gen, label, m, k, n, bits, reps=15) -> dict:
    """B1 at ``(m, k, n)``, ``bits``-bit weights, on seeded random inputs
    (drawn on ``gen``'s device): bitwise against its plain version, and
    timed beside it and ``torch._int_mm`` (where that takes the shape: M
    > 16, K and N multiples of 8, int8) with its bound."""
    from repro_torch.core import affine, ptq
    from repro_torch.kernels import int8_matmul
    x = torch.randn((m, k), generator=gen, device=gen.device).to(dev) * 1.5
    w = (torch.randn((k, n), generator=gen, device=gen.device)
         / k ** 0.5).to(dev)
    xq, xp = affine.quantize_to_int(x, 8)
    pw = ptq._pack_leaf(w, bits)
    del x, w
    args = (xq, pw.codes, xp.delta, xp.zero_point, pw.col_scale,
            pw.col_zero)
    got = int8_matmul.int8_matmul_cuda(*args, w_bits=bits)
    want = int8_matmul.int8_matmul_plain(*args, w_bits=bits)
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    err = float((got - want).abs().max())
    del got, want
    check(same, f"int8_matmul bits={bits} {m}x{k}x{n} bitwise "
                f"(max abs diff {err})")
    lib_ms = None
    if bits == 8 and m > 16 and k % 8 == 0 and n % 8 == 0:
        wq = pw.codes
        lib_ms = device_ms(torch, lambda: torch._int_mm(xq, wq), reps=reps)
    nbytes = m * k + pw.codes.numel() + 8 * n + 8 + 4 * m * n
    b_ms, b_by = bound(nbytes, 2.0 * m * k * n)
    return dict(
        name="int8_matmul", label=label, bits=bits, shape=[m, k, n],
        plan=int8_matmul.plan(m, k, n), bitwise=same, max_abs_err=err,
        ms=device_ms(torch, lambda: int8_matmul.int8_matmul_cuda(
            *args, w_bits=bits), reps=reps),
        plain_ms=device_ms(torch, lambda: int8_matmul.int8_matmul_plain(
            *args, w_bits=bits), reps=reps),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def b1_path_shapes(torch, dev, fn) -> list:
    """The ``(M, K, N, bits)`` of every B1 launch ``fn()`` makes (each
    launched and counted as usual), in order of first launch."""
    from repro_torch.kernels import int8_matmul
    seen, orig = [], int8_matmul.int8_matmul_cuda

    def record(x_q, w_q, *args, w_bits=8):
        key = (int(x_q.shape[0]), int(x_q.shape[1]), int(w_q.shape[1]),
               4 if w_bits <= 4 else 8)
        if key not in seen:
            seen.append(key)
        return orig(x_q, w_q, *args, w_bits=w_bits)
    int8_matmul.int8_matmul_cuda = record
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        int8_matmul.int8_matmul_cuda = orig
    return seen


def train_phase(torch, dev, smi, counters) -> dict:
    """The training path, through ``loops.train`` and ``quarl_ptq``.

    Each run is driven with every kernel count set to 0 just before it
    and read just after, and held to its launch counts and its bar."""
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.rl import loops
    runs = (("qat8", dict(quant=QuantConfig.qat(8, quant_delay=QAT_DELAY))),
            ("actorq_int4", dict(actor_backend="int4", calib_batch=32)),
            ("actorq_int8", dict(actor_backend="int8", calib_batch=32)),
            ("fp32", {}))
    rows, results = [], {}
    for name, kw in runs:
        for c in counters.values():
            c.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        iters = QAT_TRAIN_ITERS if name == "qat8" else TRAIN_ITERS
        res = loops.train("dqn", "cartpole", iterations=iters,
                          record_every=TRAIN_RECORD,
                          steps_per_call=TRAIN_SPC, seed=SEED, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        n = {k: c.value for k, c in counters.items()}
        cfg = res.algo_cfg
        steps = iters * cfg.rollout_steps          # batched env steps
        updates = iters * cfg.updates_per_iter
        records = len(res.rewards)
        if name == "qat8":
            want = {"fake_quant": 6 * (steps + res.eval_steps) + 12 * updates,
                    "int8_matmul": 0, "fused_qmlp": 0}
        elif cfg.calib_batch:
            # calibration runs the per-layer path over the 2 hidden layers
            # at every refresh: each iteration and each eval mint
            want = {"fused_qmlp": steps + res.eval_steps,
                    "int8_matmul": 2 * (iters + records),
                    "fake_quant": 0}
        else:
            want = {"fake_quant": 0, "int8_matmul": 0, "fused_qmlp": 0}
        want["int8_cache_attention"] = 0
        check(n == want, f"train {name}: launches {n}, the config implies "
                         f"{want}")
        check(len(res.rewards) == iters // TRAIN_RECORD
              and all(np.isfinite(res.rewards)),
              f"train {name}: rewards {res.rewards}")
        check(max(res.rewards) > TRAIN_BARS[name],
              f"train {name}: max eval reward {max(res.rewards)} does not "
              f"clear its bar {TRAIN_BARS[name]} ({res.rewards})")
        row = dict(run=name, rewards=res.rewards, bar=TRAIN_BARS[name],
                   wall_s=wall, updates_per_s=updates / wall,
                   env_steps_per_s=steps * cfg.n_envs / wall,
                   eval_env_steps=res.eval_steps, launches=n,
                   observers={k: [float(o.vmin), float(o.vmax)]
                              for k, o in res.state.observers.items()},
                   card=smi)
        rows.append(row)
        print("train " + json.dumps(row))
        results[name] = res

    # quarl_ptq on the fp32 run: its fp32, int8 and fp16 evaluations
    for c in counters.values():
        c.reset()
    ptq_rows = loops.quarl_ptq("dqn", "cartpole", bits_list=(8, 16),
                               result=results["fp32"], seed=SEED)
    n = {k: c.value for k, c in counters.items()}
    check(n["fake_quant"] == 3 and n["int8_matmul"] == n["fused_qmlp"] == 0,
          f"quarl_ptq: launches {n} (want 3 fake_quant: the ptq_int8 "
          f"weights)")
    for r in ptq_rows:
        check(np.isfinite(r.quant_reward), f"quarl_ptq {r.label}: {r}")
        row = dict(ptq=r.label, fp32_reward=r.fp32_reward,
                   quant_reward=r.quant_reward, error_pct=r.error_pct,
                   launches=n, card=smi)
        rows.append(row)
        print("train " + json.dumps(row))

    rows.append(dict(td_replay=td_replay(torch, dev, results["qat8"], smi,
                                         "train")))
    rows += profile_iterations(torch, dev, results, "train")
    per_iter = {r["profile"]["run"]: r["profile"]["kernels_per_call"]
                for r in rows if "profile" in r}
    side = dict(qat8=per_iter["qat8"], fp32=per_iter["fp32"],
                ratio=per_iter["qat8"] / per_iter["fp32"],
                bound=QAT_KERNEL_RATIO, card=smi)
    print("train kernels per iteration " + json.dumps(side))
    check(side["ratio"] <= QAT_KERNEL_RATIO,
          f"a QAT iteration launches {side['qat8']} kernels, fp32 "
          f"{side['fp32']}: more than {QAT_KERNEL_RATIO}x")
    rows.append(dict(kernels_per_iteration=side))
    return dict(rows=rows, qat_launches=next(
        r["launches"] for r in rows if r.get("run") == "qat8"))


def update_replay(torch, res, update, parts, smi: str, label: str,
                  noise=lambda path: False) -> dict:
    """One learner ``update`` of the run ``res`` (a QAT run past its
    delay) on the card and, from the same state and a batch drawn from its
    replay, on the CPU: the loss, ``|td|`` and the largest difference of
    each group of state tensors ``parts(state) -> {name: tree}``, printed
    and held to ``TD_ATOL``, with the leaf where it lies.  Leaves whose
    path ``noise(path)`` names have a gradient that is zero in exact
    arithmetic, so Adam's normalised step turns their rounding noise
    into an update of up to the learning rate; their Adam moments are
    held with the rest, their params and targets are printed
    (``noise_leaves``) and not held."""
    from repro_torch.core import ptq
    from repro_torch.rl import buffer as rb
    cfg = res.algo_cfg
    check(int(res.state.step) >= cfg.quant.quant_delay,
          f"{label}: the QAT run is past its delay")
    batch = rb.replay_sample(
        res.state.extras.replay,
        torch.Generator(device=res.device).manual_seed(SEED),
        cfg.batch_size)
    card_state, (card_loss, card_td) = update(res.state, batch,
                                              res.state.extras.replay.size)
    cpu_in = ptq.tree_to(res.state, "cpu")
    cpu_state, (cpu_loss, cpu_td) = update(cpu_in, ptq.tree_to(batch, "cpu"),
                                           cpu_in.extras.replay.size)
    card_parts, cpu_parts = parts(card_state), parts(cpu_state)
    diffs, where, noisy = {}, {}, {}
    for what, tree in card_parts.items():
        for (path, x), (_, y) in zip(ptq.tree_tensors(tree),
                                     ptq.tree_tensors(cpu_parts[what])):
            d = float((x.cpu().to(torch.float32)
                       - y.to(torch.float32)).abs().max())
            if noise(path) and what in ("params", "target"):
                noisy[f"{what}{path}"] = d
            elif d >= diffs.get(what, -1.0):
                diffs[what], where[what] = d, path
    td_diff = (card_td.cpu() - cpu_td).abs()
    replay = dict(step=int(res.state.step),
                  loss_card=float(card_loss), loss_cpu=float(cpu_loss),
                  loss_abs_diff=abs(float(card_loss) - float(cpu_loss)),
                  max_abs_diff=diffs, max_abs_diff_at=where,
                  noise_leaves=noisy,
                  td_rows_over_1e6=int((td_diff > 1e-6).sum()),
                  td_max_abs_diff=float(td_diff.max()), card=smi)
    print(f"{label} " + json.dumps(replay))
    check(replay["loss_abs_diff"] <= TD_ATOL
          and max(diffs.values(), default=0.0) <= TD_ATOL,
          f"{label}: the update on the card vs the CPU: {replay}")
    return replay


def td_replay(torch, dev, res, smi: str, label: str) -> dict:
    """``update_replay`` of one DQN TD update: params, target, Adam's
    moments and the observers.  A sequence policy's key biases
    (``blk{i}/k/b``) get no gradient in exact arithmetic: softmax is
    unchanged when ``q . b`` is added to every logit of a row."""
    from repro_torch.rl import dqn
    return update_replay(
        torch, res, dqn.make_td_update(res.env, res.net, res.algo_cfg),
        lambda st: {"params": st.params,
                    "target": st.extras.target_params,
                    "adam_m": st.opt.m, "adam_v": st.opt.v,
                    "observers": st.observers},
        smi, f"{label} td_replay",
        noise=lambda path: res.net.seq_cfg is not None
        and path.endswith("/k/b"))


def profile_iterations(torch, dev, results: dict, label: str) -> list:
    """Where an iteration's time goes: two further fused iterations of
    each run in ``results`` (name -> ``TrainResult``) under
    ``profile_calls``, after every timed run; printed, one row a run."""
    from repro_torch.rl import dqn
    rows = []
    for name, res in results.items():
        iteration, _, benv = dqn.make_iteration(res.env, res.net,
                                                res.algo_cfg, dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + 40)
        env_state, obs = benv.reset(gen, dev)
        carry = [res.state, env_state, obs]

        def one(iteration=iteration, carry=carry, gen=gen):
            carry[0], carry[1], carry[2], _ = iteration(*carry, gen)
        prof = dict(run=name, **profile_calls(torch, one, n=2))
        rows.append(dict(profile=prof))
        print(f"{label} profile " + json.dumps(prof))
    return rows


def _merged(spans):
    """Union of ``(start, end)`` spans, as sorted disjoint spans."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def profile_streams(torch, fn, n: int = 2) -> dict:
    """``n`` calls of ``fn`` under ``torch.profiler``, read per CUDA stream.

    Host ms a call (wall to a sync), device ms a call (kernel time
    summed), kernels a call, the device's busy share of the wall (the
    union of all kernels' spans), each stream's busy share, and the share
    of the wall in which kernels of two streams or more run at once, from
    the trace's kernel events.  Device numbers are ``None`` without them.
    """
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events
               if e.get("cat") == "kernel" and "dur" in e]
    by_stream = {}
    for e in kernels:
        stream = e.get("args", {}).get("stream", e.get("tid"))
        by_stream.setdefault(stream, []).append(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    if not kernels:
        return dict(host_ms_per_call=wall_us / 1e3 / n,
                    device_ms_per_call=None, kernels_per_call=0,
                    device_busy_share=None, stream_busy_share={},
                    both_streams_share=None)
    merged = {k: _merged(v) for k, v in by_stream.items()}
    # sweep: time with at least one / at least two streams busy
    edges = sorted([(a, 1) for m in merged.values() for a, _ in m]
                   + [(b, -1) for m in merged.values() for _, b in m])
    busy = both = 0.0
    active, last = 0, edges[0][0]
    for t_us, step in edges:
        if active >= 1:
            busy += t_us - last
        if active >= 2:
            both += t_us - last
        active += step
        last = t_us
    return dict(
        host_ms_per_call=wall_us / 1e3 / n,
        device_ms_per_call=sum(b - a for v in by_stream.values()
                               for a, b in v) / 1e3 / n,
        kernels_per_call=len(kernels) / n,
        device_busy_share=busy / wall_us,
        stream_busy_share={str(k): sum(b - a for a, b in m) / wall_us
                           for k, m in merged.items()},
        both_streams_share=both / wall_us)


def _bitwise_runs(torch, a, b) -> bool:
    """Two ``TrainResult``s with equal rewards, update counts and params,
    bit for bit."""
    from repro_torch.core import ptq
    return (a.rewards == b.rewards
            and int(a.state.extras.updates) == int(b.state.extras.updates)
            and all(torch.equal(x, y) for (_, x), (_, y) in zip(
                ptq.tree_tensors(a.state.params),
                ptq.tree_tensors(b.state.params))))


def anchor_runs(torch, env_name: str, smi: str, label: str,
                **net) -> dict:
    """The topologies' bitwise anchors on ``env_name`` at ``SMALL_DQN``,
    fp32 and int8 actors: actor-learner with one actor pushed every
    iteration is the fused driver, async in barrier mode is actor-learner,
    and ``steps_per_call`` 3 is the per-step driver.  Printed and checked;
    returns the verdicts and rewards by backend."""
    from repro_torch.rl import loops
    small = dict(iterations=6, record_every=3, eval_episodes=2, seed=7,
                 algo_overrides=dict(SMALL_DQN), **net)
    anchors = {}
    for backend in ("fp32", "int8"):
        kw = dict(small, actor_backend=backend)
        fused = loops.train("dqn", env_name, **kw)
        sync = loops.train("dqn", env_name, topology="actor-learner",
                           num_actors=1, sync_every=1, **kw)
        barrier = loops.train("dqn", env_name, topology="async",
                              num_actors=1,
                              sync_every=SMALL_DQN["updates_per_iter"],
                              async_barrier=True, steps_per_call=1, **kw)
        chunked = loops.train("dqn", env_name, steps_per_call=3, **kw)
        anchors[backend] = dict(
            actor_learner_is_fused=_bitwise_runs(torch, fused, sync),
            async_barrier_is_actor_learner=_bitwise_runs(torch, sync,
                                                         barrier),
            chunked_is_per_step=_bitwise_runs(torch, fused, chunked),
            rewards=sync.rewards)
        check(all(v for v in anchors[backend].values()
                  if isinstance(v, bool)),
              f"{backend} {label} anchors on the card: {anchors[backend]}")
    print(f"{label} anchors " + json.dumps(dict(anchors, card=smi)))
    return anchors


def topology_programs(torch, dev, backend: str, calib_batch: int = 0):
    """The async programs of the topology phase's config on the card and
    a first state: ``(progs, learner, wbuf, env_state, obs, snap)``."""
    from repro_torch.rl import actor_learner, dqn, networks
    from repro_torch.rl.envs import make
    env = make("cartpole")
    net = networks.make_network(env.spec.obs_shape, env.spec.n_actions,
                                device=dev)
    cfg = dqn.DQNConfig(actor_backend=backend, calib_batch=calib_batch)
    al = actor_learner.ActorLearnerConfig(num_actors=TOPO_ACTORS,
                                          sync_every=16)
    progs = actor_learner.make_async_actor_learner("dqn", env, net, cfg, al,
                                                   device=dev)
    learner, wbuf = actor_learner.init_async(
        torch.Generator().manual_seed(SEED), env, net, "dqn", cfg, al)
    env_state, obs = progs.benv_global.reset(
        torch.Generator(device=dev).manual_seed(SEED + 50), dev)
    progs.streams.start()
    progs.streams.share((learner, wbuf, env_state, obs))
    snap = progs.make_snapshot(learner, obs)
    return progs, learner, wbuf, env_state, obs, snap


def topology_phase(torch, dev, smi, counters) -> dict:
    """The actor-learner and async topologies through ``loops.train``.

    The bitwise anchors first (actor-learner with 1 actor and a push
    every iteration against the fused driver, async in barrier mode
    against actor-learner; fp32 and int8, at ``SMALL_DQN``), then the four
    ``TOPO_RUNS`` at full width, each with every kernel count set to 0
    just before it and read just after, held to its launch counts, its
    bar and finite divergences and lags; then two rounds of each,
    profiled per stream."""
    from repro_torch.rl import actor_learner, actorq, loops
    rows = [dict(anchors=anchor_runs(torch, "cartpole", smi, "topology"))]

    results = {}
    for name, kw in TOPO_RUNS:
        for c in counters.values():
            c.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = loops.train("dqn", "cartpole", iterations=TOPO_ITERS,
                          record_every=TOPO_RECORD, seed=SEED,
                          num_actors=TOPO_ACTORS, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        n = {k: c.value for k, c in counters.items()}
        cfg = res.algo_cfg
        steps = TOPO_ITERS * cfg.rollout_steps      # batched env steps
        envs = TOPO_ACTORS * cfg.n_envs
        updates = TOPO_ITERS * cfg.updates_per_iter
        records = len(res.rewards)
        is_async = kw["topology"] == "async"
        pushes = len(res.actor_lags) if is_async \
            else TOPO_ITERS // kw["sync_every"]
        heads = pushes * TOPO_ACTORS            # divergence heads, 1 an actor
        want = dict.fromkeys(counters, 0)
        if actorq.is_quantized(cfg.actor_backend):
            if cfg.calib_batch:
                # B2 a behaviour step, eval step and head; the per-layer
                # calibration (2 hidden layers) at the first mint, every
                # push and every eval mint
                want["fused_qmlp"] = steps + res.eval_steps + heads
                want["int8_matmul"] = 2 * (1 + pushes + records)
            else:
                want["int8_matmul"] = 3 * (steps + res.eval_steps + heads)
        check(n == want, f"topology {name}: launches {n}, the config "
                         f"implies {want}")
        check(records == TOPO_ITERS // TOPO_RECORD
              and all(np.isfinite(res.rewards)),
              f"topology {name}: rewards {res.rewards}")
        check(max(res.rewards) > TOPO_BAR,
              f"topology {name}: max eval reward {max(res.rewards)} does "
              f"not clear {TOPO_BAR} ({res.rewards}; the JAX package's "
              f"max {TOPO_JAX_MAX[name]})")
        divs = np.asarray(res.divergences, dtype=np.float64)
        check(divs.shape == ((pushes if is_async else records),
                             TOPO_ACTORS) and np.isfinite(divs).all(),
              f"topology {name}: divergences of shape {divs.shape}")
        if actorq.is_quantized(cfg.actor_backend):
            check(bool((divs > 0).any()), f"topology {name}: the quantized "
                                          f"actors diverge")
        elif is_async:
            check(bool((divs == 0).all()), f"topology {name}: fp32 "
                                           f"divergence at a push is 0")
        check(not is_async or (len(res.actor_lags) > 0 and all(
            lag == kw["sync_every"] for lag in res.actor_lags)),
              f"topology {name}: actor lags {sorted(set(res.actor_lags))}")
        row = dict(run=name, rewards=res.rewards,
                   jax_max_reward=TOPO_JAX_MAX[name], bar=TOPO_BAR,
                   wall_s=wall, updates_per_s=updates / wall,
                   env_steps_per_s=steps * envs / wall,
                   eval_env_steps=res.eval_steps, launches=n, pushes=pushes,
                   divergence_first=divs[0].tolist(),
                   divergence_last=divs[-1].tolist(),
                   divergence_mean=divs.mean(0).tolist(),
                   actor_lags=sorted(set(res.actor_lags)), card=smi)
        rows.append(row)
        print("topology " + json.dumps(row))
        results[name] = (res, kw)

    # two rounds of each run, profiled per stream (after every timed run)
    for name, (res, kw) in results.items():
        cfg = res.algo_cfg
        gen = torch.Generator(device=dev).manual_seed(SEED + 60)
        if kw["topology"] == "async":
            progs, _, wbuf, env_state, obs, snap = topology_programs(
                torch, dev, cfg.actor_backend, cfg.calib_batch)
            carry = [res.state, wbuf, env_state, obs, snap]

            def one(progs=progs, carry=carry, gen=gen):
                learner, wbuf, env_state, obs, snap = carry
                env_state, obs, wbuf, _ = progs.actor_chunk(
                    snap, env_state, obs, wbuf, gen, n_chunks=ASYNC_SPC)
                learner, _ = progs.learner_chunk(
                    learner, gen, n_updates=ASYNC_SPC * cfg.updates_per_iter)
                learner, wbuf = actor_learner.swap_read_slot(
                    learner, wbuf, progs.streams)
                snap = progs.make_snapshot(learner, obs)
                progs.divergence(learner, snap, obs)
                carry[:] = [learner, wbuf, env_state, obs, snap]
        else:
            al = actor_learner.ActorLearnerConfig(
                num_actors=TOPO_ACTORS, sync_every=kw["sync_every"])
            iteration, _, benv = actor_learner.make_actor_learner(
                "dqn", res.env, res.net, cfg, al, device=dev)
            env_state, obs = benv.reset(gen, dev)
            cache = actorq.make_actor_cache(res.state.params,
                                            cfg.actor_backend)
            # t = 1: the second of the two profiled iterations pushes
            state = actor_learner.ActorLearnerState(
                res.state, res.state.params, cache, 1,
                torch.zeros(TOPO_ACTORS, device=dev))
            carry = [state, env_state, obs]

            def one(iteration=iteration, carry=carry, gen=gen):
                carry[0], carry[1], carry[2], _ = iteration(*carry, gen)
        prof = dict(run=name, **profile_streams(torch, one, n=2))
        rows.append(dict(profile=prof))
        print("topology profile " + json.dumps(prof))
    return dict(rows=rows, launches=next(
        r["launches"] for r in rows if r.get("run") == "async_int8"))


def mlp_site_launches(dims, batch: int) -> int:
    """B5 launches of one QAT forward of the MLP ``dims[0] -> ... ->
    dims[-1]`` on ``batch`` rows: a weight site and an activation site a
    layer, each one launch up to 4,096 elements and two above."""
    def site(n):
        return 1 if n <= 4096 else 2
    return sum(site(k * n) + site(batch * n)
               for k, n in zip(dims[:-1], dims[1:]))


def algo_launches(algo: str, res, kw: dict, iters: int, names) -> dict:
    """The kernel launches ``loops.train(algo, ...)`` with ``kw`` must
    make in ``iters`` iterations, from its config: B1 a layer of each
    uncalibrated actor forward (the behaviour steps -- PPO's ``n_steps``
    and its bootstrap, A2C's ``n_steps``, DDPG's ``rollout_steps`` --
    the eval steps and the divergence heads, one an actor at each push);
    calibrated, B2 once a forward and B1 a hidden layer at each
    calibration (every iteration, or the first mint and every push, and
    every eval mint); B5 at each QAT site of every forward."""
    cfg = res.algo_cfg
    records = len(res.rewards)
    hidden = (64, 64)
    per_it = cfg.rollout_steps if algo == "ddpg" \
        else cfg.n_steps + (algo == "ppo")
    fwd = iters * per_it
    topo = kw.get("topology", "fused")
    pushes = len(res.actor_lags) if topo == "async" else (
        iters // kw["sync_every"] if topo == "actor-learner" else 0)
    heads = pushes * kw.get("num_actors", 1)
    want = dict.fromkeys(names, 0)
    if kw.get("actor_backend", "fp32") != "fp32":
        if kw.get("calib_batch"):
            mints = iters if topo == "fused" else 1 + pushes
            want["fused_qmlp"] = fwd + res.eval_steps + heads
            want["int8_matmul"] = len(hidden) * (mints + records)
        else:
            want["int8_matmul"] = (len(hidden) + 1) * (
                fwd + res.eval_steps + heads)
    if "qat_delay" in kw:
        obs_dim = res.env.spec.obs_shape[0]
        envs, evals = cfg.n_envs, kw.get("eval_episodes", 8)
        if algo == "ddpg":
            actor = (obs_dim,) + hidden + (1,)
            critic = (obs_dim + 1,) + hidden + (1,)
            b = cfg.batch_size
            want["fake_quant"] = (
                fwd * mlp_site_launches(actor, envs)
                + iters * cfg.updates_per_iter * (
                    2 * mlp_site_launches(actor, b)
                    + 3 * mlp_site_launches(critic, b))
                + res.eval_steps * mlp_site_launches(actor, evals))
        else:
            net = (obs_dim,) + hidden + (res.env.spec.n_actions + 1,)
            if algo == "ppo":
                mb = cfg.n_steps * cfg.n_envs // cfg.n_minibatches
                learner = cfg.epochs * cfg.n_minibatches \
                    * mlp_site_launches(net, mb)
            else:
                learner = mlp_site_launches(net, cfg.n_steps * cfg.n_envs) \
                    + mlp_site_launches(net, envs)
            want["fake_quant"] = (
                fwd * mlp_site_launches(net, envs) + iters * learner
                + res.eval_steps * mlp_site_launches(net, evals))
    return want


def _same_learner(torch, a, b) -> bool:
    """Two ``TrainResult``s with equal rewards and learner states (params,
    both Adam states, observers, step, and the extras but the replay,
    which one topology shards), bit for bit."""
    from repro_torch.core import ptq

    def learner(st):
        return (st.params, st.opt, st.observers, st.step,
                st.extras._replace(replay=()))
    x = list(ptq.tree_tensors(learner(a.state)))
    y = list(ptq.tree_tensors(learner(b.state)))
    return a.rewards == b.rewards and len(x) == len(y) and all(
        torch.equal(u, v) for (_, u), (_, v) in zip(x, y))


def ddpg_anchors(torch, smi: str) -> dict:
    """DDPG's three contracts on the card at ``SMALL_DDPG``, fp32 and int8
    actors: actor-learner with one actor pushed every iteration is the
    fused driver, async in barrier mode is actor-learner, and
    ``priority_exponent=0`` is uniform replay (fused and actor-learner
    with 2 actors), bit for bit.  Printed and checked."""
    from repro_torch.rl import loops
    small = dict(iterations=6, record_every=3, eval_episodes=2, seed=7,
                 algo_overrides=dict(SMALL_DDPG))
    anchors = {}
    for backend in ("fp32", "int8"):
        kw = dict(small, actor_backend=backend)
        fused = loops.train("ddpg", "pendulum", **kw)
        sync = loops.train("ddpg", "pendulum", topology="actor-learner",
                           num_actors=1, sync_every=1, **kw)
        barrier = loops.train("ddpg", "pendulum", topology="async",
                              num_actors=1,
                              sync_every=SMALL_DDPG["updates_per_iter"],
                              async_barrier=True, steps_per_call=1, **kw)
        alpha0 = {}
        for topo in ({}, dict(topology="actor-learner", num_actors=2,
                              sync_every=2)):
            uni = loops.train("ddpg", "pendulum", replay="uniform",
                              **topo, **kw)
            per0 = loops.train("ddpg", "pendulum", replay="prioritized",
                               priority_exponent=0.0, **topo, **kw)
            alpha0[topo.get("topology", "fused")] = _same_learner(
                torch, uni, per0)
        anchors[backend] = dict(
            actor_learner_is_fused=_same_learner(torch, fused, sync),
            async_barrier_is_actor_learner=_same_learner(torch, sync,
                                                         barrier),
            alpha0_is_uniform=alpha0, rewards=sync.rewards)
        check(anchors[backend]["actor_learner_is_fused"]
              and anchors[backend]["async_barrier_is_actor_learner"]
              and all(alpha0.values()),
              f"{backend} DDPG anchors on the card: {anchors[backend]}")
    print("algo ddpg anchors " + json.dumps(dict(anchors, card=smi)))
    return anchors


def ddpg_replay(torch, res, smi: str) -> dict:
    """``update_replay`` of one DDPG update: both nets, both targets,
    both Adam states and the observers."""
    from repro_torch.rl import ddpg
    return update_replay(
        torch, res, ddpg.make_update(res.env, res.net, res.algo_cfg),
        lambda st: {"actor": st.params,
                    "critic": st.extras.critic_params,
                    "target_actor": st.extras.target_actor,
                    "target_critic": st.extras.target_critic,
                    "adam": st.opt, "critic_adam": st.extras.critic_opt,
                    "observers": st.observers},
        smi, "algo ddpg_replay")


def b2_path_calls(torch, fn) -> list:
    """``(x_q, layers)`` of the first B2 launch ``fn()`` makes at each
    ``(M, K0, N_out, bits)`` (each launched and counted as usual), in
    order of first launch."""
    from repro_torch.kernels import fused_qmlp
    seen, calls, orig = [], [], fused_qmlp.fused_qmlp_cuda

    def record(x_q, layers):
        key = (int(x_q.shape[0]), int(layers[0].k), int(layers[-1].n),
               int(layers[0].bits))
        if key not in seen:
            seen.append(key)
            calls.append((x_q.clone(), layers))
        return orig(x_q, layers)
    fused_qmlp.fused_qmlp_cuda = record
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        fused_qmlp.fused_qmlp_cuda = orig
    return calls


def b2_row(torch, label, x_q, layers) -> dict:
    """B2 on a path's ``(x_q, layers)``: bitwise against its plain
    version, and timed beside it with its bound."""
    from repro_torch.kernels import fused_qmlp
    got = fused_qmlp.fused_qmlp_cuda(x_q, layers)
    want = fused_qmlp.fused_qmlp_plain(x_q, layers)
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    err = float((got - want).abs().max())
    m, k0 = int(x_q.shape[0]), int(layers[0].k)
    check(same, f"fused_qmlp {label} M={m} K0={k0} N={layers[-1].n} bits="
                f"{layers[0].bits} bitwise (max abs diff {err})")
    nbytes = m * k0 + 4 * m * layers[-1].n + sum(
        la.codes.numel() + 12 * la.n + 8 for la in layers)
    b_ms, b_by = bound(nbytes, 2.0 * m * sum(la.k * la.n for la in layers))
    return dict(
        name="fused_qmlp", label=label, bits=int(layers[0].bits),
        shape=[m, k0] + [int(la.n) for la in layers],
        plan=fused_qmlp.plan(m, k0, layers), bitwise=same,
        max_abs_err=err,
        ms=device_ms(torch, lambda: fused_qmlp.fused_qmlp_cuda(x_q,
                                                               layers)),
        plain_ms=device_ms(torch, lambda: fused_qmlp.fused_qmlp_plain(
            x_q, layers)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)


def algo_shape_rows(torch, dev, smi, widths) -> list:
    """B1 and B2 at every shape the algorithms' paths give them, recorded
    from one iteration of each (PPO and A2C on CartPole, PPO on
    MountainCar, DDPG on Pendulum at 64 and at ``widths``, the
    actor-learner's behaviour step and divergence heads, the calibrated
    caches), plus B1 at M 4 and 512 on the K 2 / 3 and N 1 / 3 edges:
    bitwise against the plain versions and timed."""
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.rl import actor_learner, ddpg, loops
    from repro_torch.rl.envs import make
    b1_seen, b2_calls = [], []

    def one_iteration(algo, env_name, hidden=(64, 64), **kw):
        """One fused iteration of ``algo``, as ``loops.train`` builds it."""
        env = make(env_name)
        gen = torch.Generator(device=dev).manual_seed(SEED + 90)
        net, cfg = loops._build(algo, env, QuantConfig.none(),
                                dict(hidden=hidden), kw, dev)
        mod = loops.MODULES[algo]
        state = mod.init(torch.Generator().manual_seed(SEED), env, net, cfg)
        iteration, _, benv = mod.make_iteration(env, net, cfg, dev)
        env_state, obs = benv.reset(gen, dev)
        return lambda: iteration(state, env_state, obs, gen)

    def al_round(backend):
        env = make("pendulum")
        nets = ddpg.make_nets(env, device=dev)
        cfg = ddpg.DDPGConfig(actor_backend=backend)
        al = actor_learner.ActorLearnerConfig(num_actors=4, sync_every=1)
        st = actor_learner.init(torch.Generator().manual_seed(SEED), env,
                                nets, "ddpg", cfg, al)
        iteration, _, benv = actor_learner.make_actor_learner(
            "ddpg", env, nets, cfg, al, device=dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + 91)
        env_state, obs = benv.reset(gen, dev)
        return lambda: iteration(st, env_state, obs, gen)

    for label, fn in (
            ("ppo cartpole", one_iteration("ppo", "cartpole",
                                           actor_backend="int8")),
            ("ppo cartpole", one_iteration("ppo", "cartpole",
                                           actor_backend="int4")),
            ("a2c cartpole", one_iteration("a2c", "cartpole",
                                           actor_backend="int8")),
            ("ppo mountaincar", one_iteration("ppo", "mountaincar",
                                              actor_backend="int8")),
            ("ppo mountaincar", one_iteration("ppo", "mountaincar",
                                              actor_backend="int4")),
            ("ddpg pendulum", one_iteration("ddpg", "pendulum",
                                            actor_backend="int8")),
            ("ddpg pendulum", one_iteration("ddpg", "pendulum",
                                            actor_backend="int4")),
            ("ddpg Policy II", one_iteration("ddpg", "pendulum",
                                             hidden=widths,
                                             actor_backend="int8")),
            ("ddpg actor-learner", al_round("int8")),
            ("ddpg actor-learner", al_round("int4"))):
        for shape in b1_path_shapes(torch, dev, fn):
            if all(shape != s[1:] for s in b1_seen):
                b1_seen.append((label,) + shape)
    for label, algo, env_name, hidden, bits, calib in (
            ("ppo cartpole calibrated", "ppo", "cartpole", (64, 64), "int4",
             16),
            ("ppo cartpole calibrated", "ppo", "cartpole", (64, 64), "int8",
             16),
            ("ppo mountaincar calibrated", "ppo", "mountaincar", (64, 64),
             "int4", 16),
            ("ddpg pendulum calibrated", "ddpg", "pendulum", (64, 64),
             "int4", 8),
            ("ddpg pendulum calibrated", "ddpg", "pendulum", (64, 64),
             "int8", 8),
            ("ddpg Policy II calibrated", "ddpg", "pendulum", widths,
             "int4", 8)):
        for call in b2_path_calls(torch, one_iteration(
                algo, env_name, hidden=hidden, actor_backend=bits,
                calib_batch=calib)):
            b2_calls.append((label,) + call)
    for m in (4, 512):
        for k in (2, 3):
            for n in (1, 3):
                for bits in (8, 4):
                    if all((m, k, n, bits) != s[1:] for s in b1_seen):
                        b1_seen.append(("edge", m, k, n, bits))
    gen = torch.Generator(device=dev).manual_seed(SEED + 92)
    rows = [b1_row(torch, dev, gen, label, m, k, n, bits)
            for label, m, k, n, bits in b1_seen]
    rows += [b2_row(torch, label, x_q, layers)
             for label, x_q, layers in b2_calls]
    shapes = {(r["shape"][1], r["shape"][2]) for r in rows
              if r["name"] == "int8_matmul"}
    check(all(any(k == kk for kk, _ in shapes) for k in (2, 3))
          and all(any(n == nn for _, nn in shapes) for n in (1, 3))
          and any(r["name"] == "fused_qmlp" and r["shape"][-1] == 1
                  for r in rows),
          f"the algorithms' paths gave B1 K 2 and 3, N 1 and 3, and B2 a "
          f"width-1 head: {sorted(shapes)}")
    print(f"algo shapes: {len(rows)} rows, B1 and B2 bitwise, card {smi}")
    return rows


def wide_rows(torch, dev, smi, counters, widths) -> list:
    """DDPG on Pendulum with its actor and critic at ``widths`` (Policy
    II): the fp32, ActorQ int8 (B1) and int4 calibrated (B2) actors,
    ``ALGO_WIDE_ITERS`` fused iterations each in chunks of
    ``ALGO_WIDE_CHUNK``, the three in turns (the order reversed every
    other chunk).  Each is held to its launch counts; updates/s and
    env-steps/s from the host clock around its chunks; host and device ms,
    kernels and device busy an iteration from two further profiled
    iterations."""
    from repro_torch.core import ptq
    from repro_torch.rl import ddpg
    from repro_torch.rl.envs import make
    env = make("pendulum")
    nets = ddpg.make_nets(env, hidden=widths, device=dev)
    runs = {"fp32": {}, "int8": dict(actor_backend="int8"),
            "int4_calib": dict(actor_backend="int4", calib_batch=8)}
    carry, progs = {}, {}
    for name, kw in runs.items():
        cfg = ddpg.DDPGConfig(**kw)
        state = ddpg.init(torch.Generator().manual_seed(SEED + 70), env,
                          nets, cfg)
        iteration, _, benv = ddpg.make_iteration(env, nets, cfg, dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + 71)
        env_state, obs = benv.reset(gen, dev)
        carry[name] = [state, env_state, obs, None]
        progs[name] = (iteration, gen, cfg)
    wall = dict.fromkeys(runs, 0.0)
    launches = {name: dict.fromkeys(counters, 0) for name in runs}
    rewards = {name: [] for name in runs}
    for c in counters.values():
        c.reset()
    for chunk in range(ALGO_WIDE_ITERS // ALGO_WIDE_CHUNK):
        order = list(runs) if chunk % 2 == 0 else list(runs)[::-1]
        for name in order:
            iteration, gen, _ = progs[name]
            before = {k: c.value for k, c in counters.items()}
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(ALGO_WIDE_CHUNK):
                st, es, ob, _ = carry[name]
                carry[name] = list(iteration(st, es, ob, gen))
            torch.cuda.synchronize()
            wall[name] += time.perf_counter() - t
            for k, c in counters.items():
                launches[name][k] += c.value - before[k]
            rewards[name].append(float(carry[name][3]["reward"]))
    rows = []
    for name in runs:
        cfg = progs[name][2]
        steps = ALGO_WIDE_ITERS * cfg.rollout_steps
        want = dict.fromkeys(counters, 0)
        if name == "int8":
            want["int8_matmul"] = (len(widths) + 1) * steps
        elif name == "int4_calib":
            want["fused_qmlp"] = steps
            want["int8_matmul"] = len(widths) * ALGO_WIDE_ITERS
        check(launches[name] == want,
              f"DDPG Policy II {name}: launches {launches[name]}, the "
              f"config implies {want}")
        state = carry[name][0]
        check(all(bool(torch.isfinite(t).all())
                  for _, t in ptq.tree_tensors((state.params,
                                                state.extras.critic_params))),
              f"DDPG Policy II {name}: finite params")
        iteration, gen, _ = progs[name]

        def one(name=name, iteration=iteration, gen=gen):
            st, es, ob, _ = carry[name]
            carry[name] = list(iteration(st, es, ob, gen))
        prof = profile_calls(torch, one, n=2)
        row = dict(run=f"ddpg_policy_ii_{name}", widths=list(widths),
                   iterations=ALGO_WIDE_ITERS, wall_s=wall[name],
                   updates_per_s=ALGO_WIDE_ITERS * cfg.updates_per_iter
                   / wall[name],
                   env_steps_per_s=steps * cfg.n_envs / wall[name],
                   launches=launches[name],
                   reward_per_episode_last=rewards[name][-1],
                   host_ms_per_iteration=prof["host_ms_per_call"],
                   device_ms_per_iteration=prof["device_ms_per_call"],
                   kernels_per_iteration=prof["kernels_per_call"],
                   device_busy_share=prof["device_busy_share"],
                   top=prof["top"], card=smi)
        rows.append(row)
        print("algo " + json.dumps(row))
    return rows


def algo_phase(torch, dev, smi, counters, widths) -> dict:
    """The other three algorithms through ``loops.train``: PPO and A2C on
    CartPole and DDPG on Pendulum (``ALGO_RUNS``), each driven with every
    kernel count set to 0 just before it and read just after, held to
    its launch counts, finite rewards and, where the JAX package has one,
    its bar; ``quarl_ptq`` on the PPO run; DDPG's three anchors bitwise
    and one DDPG update replayed on the CPU; DDPG at Policy II's width
    (``wide_rows``); ``launch.train``'s default run; B1 and B2 at every
    shape these paths gave them (``algo_shape_rows``)."""
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.rl import loops
    rows, results, seconds = [], {}, {}
    t_part = time.perf_counter()
    for name, algo, env_name, bar, spec in ALGO_RUNS:
        kw = dict(spec)
        if "qat_delay" in kw:
            kw["quant"] = QuantConfig.qat(8, quant_delay=kw.pop("qat_delay"))
        for c in counters.values():
            c.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = loops.train(algo, env_name, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        n = {k: c.value for k, c in counters.items()}
        iters = kw["iterations"]
        want = algo_launches(algo, res, spec, iters, counters)
        check(n == want, f"algo {name}: launches {n}, the config implies "
                         f"{want}")
        check(len(res.rewards) == iters // kw["record_every"]
              and all(np.isfinite(res.rewards)),
              f"algo {name}: rewards {res.rewards}")
        check(bar is None or max(res.rewards) > bar,
              f"algo {name}: max eval reward {max(res.rewards)} does not "
              f"clear its bar {bar} ({res.rewards})")
        cfg = res.algo_cfg
        if "quant" in kw:
            n_obs = 6 if algo == "ddpg" else 3
            check(len(res.state.observers) == n_obs and all(
                bool(o.initialized) for o in res.state.observers.values()),
                f"algo {name}: observers {sorted(res.state.observers)}")
        topo = kw.get("topology", "fused")
        actors = kw.get("num_actors", 1)
        divs = np.asarray(res.divergences, dtype=np.float64)
        if topo != "fused":
            check(divs.ndim == 2 and divs.shape[1] == actors
                  and divs.shape[0] > 0 and np.isfinite(divs).all()
                  and bool((divs > 0).any()),
                  f"algo {name}: divergences {res.divergences}")
        if topo == "async":
            check(len(res.actor_lags) > 0 and all(
                lag == kw["sync_every"] for lag in res.actor_lags),
                f"algo {name}: actor lags {sorted(set(res.actor_lags))}")
        if algo == "ddpg":
            per_it, updates = cfg.rollout_steps, iters * cfg.updates_per_iter
        elif algo == "ppo":
            per_it = cfg.n_steps
            updates = iters * cfg.epochs * cfg.n_minibatches
        else:
            per_it, updates = cfg.n_steps, iters
        row = dict(run=name, algo=algo, env=env_name, rewards=res.rewards,
                   bar=bar, wall_s=wall, updates_per_s=updates / wall,
                   env_steps_per_s=iters * per_it * cfg.n_envs * actors
                   / wall,
                   eval_env_steps=res.eval_steps, launches=n,
                   action_variances=res.action_variances,
                   divergence_last=divs[-1].tolist() if divs.size else None,
                   actor_lags=sorted(set(res.actor_lags)), card=smi)
        rows.append(row)
        print("algo " + json.dumps(row))
        results[name] = res
    seconds["runs"] = time.perf_counter() - t_part

    # quarl_ptq on the PPO fp32 run: the int8 weights through B5
    t_part = time.perf_counter()
    for c in counters.values():
        c.reset()
    ptq_rows = loops.quarl_ptq("ppo", "cartpole", bits_list=(8, 16),
                               result=results["ppo_fp32"], seed=SEED)
    n = {k: c.value for k, c in counters.items()}
    check(n["fake_quant"] == 3 and n["int8_matmul"] == n["fused_qmlp"] == 0,
          f"algo quarl_ptq: launches {n} (want 3 fake_quant: the ptq_int8 "
          f"weights)")
    for r in ptq_rows:
        check(np.isfinite(r.quant_reward), f"algo quarl_ptq {r.label}: {r}")
        rows.append(dict(ptq=r.label, algo="ppo", fp32_reward=r.fp32_reward,
                         quant_reward=r.quant_reward, error_pct=r.error_pct,
                         launches=n, card=smi))
        print("algo " + json.dumps(rows[-1]))
    rows.append(dict(anchors=ddpg_anchors(torch, smi)))
    rows.append(dict(ddpg_replay=ddpg_replay(torch, results["ddpg_qat8"],
                                             smi)))
    seconds["ptq_anchors_replay"] = time.perf_counter() - t_part

    t_part = time.perf_counter()
    rows += wide_rows(torch, dev, smi, counters, widths)
    seconds["policy_ii"] = time.perf_counter() - t_part

    # the launcher's default run (PPO on CartPole), ALGO_LAUNCH_ITERS of
    # its 200 iterations
    t_part = time.perf_counter()
    for c in counters.values():
        c.reset()
    check(launch_train.main(["--iterations", str(ALGO_LAUNCH_ITERS)]) == 0,
          "launch.train's default run")
    n = {k: c.value for k, c in counters.items()}
    check(not any(n.values()), f"the default fp32 PPO run: launches {n}")
    seconds["launch_train"] = time.perf_counter() - t_part

    t_part = time.perf_counter()
    shape_rows = algo_shape_rows(torch, dev, smi, widths)
    seconds["shapes"] = time.perf_counter() - t_part
    print("algo seconds " + json.dumps(seconds))
    launches = {r["run"]: r["launches"] for r in rows if "launches" in r
                and "run" in r}
    return dict(rows=rows, shape_rows=shape_rows, launches=launches,
                seconds=seconds)


def conv_boards(torch, dev, n: int, seed: int):
    """``n`` Catch observations three steps into their episodes (the ball
    in the board's fourth row), drawn on the card."""
    from repro_torch.rl.envs import make
    env = make("catch")
    gen = torch.Generator(device=dev).manual_seed(seed)
    state, obs = env.reset(gen, n, dev)
    for _ in range(3):
        state, obs, _, _ = env.step(state, torch.randint(
            0, 3, (n,), generator=gen, device=dev), gen)
    return obs


def with_plain_b1(fn):
    """``fn()`` with B1's plain version in the kernel's place: the same
    actor's plain replay on the card (no launch counted)."""
    from repro_torch.kernels import int8_matmul
    orig = int8_matmul.int8_matmul_cuda
    int8_matmul.int8_matmul_cuda = int8_matmul.int8_matmul_plain
    try:
        return fn()
    finally:
        int8_matmul.int8_matmul_cuda = orig


def qat_site_launches(filters, fc_width: int, batch: int, hw: int = 100,
                      n_out: int = 3) -> int:
    """B5 launches of one QAT forward of the Catch conv net on ``batch``
    boards of ``hw`` pixels: the activation sites ``conv{i}/out``,
    ``fc/out`` and ``out/out`` and the dense weight sites ``fc/w`` and
    ``out/w`` (the conv kernels' per-channel sites are plain torch), each
    one launch up to 4,096 elements and two above."""
    def site(n):
        return 1 if n <= 4096 else 2
    return (sum(site(batch * hw * f) for f in filters)
            + site(hw * filters[-1] * fc_width) + site(batch * fc_width)
            + site(fc_width * n_out) + site(batch * n_out))


def conv_phase(torch, dev, smi, counters) -> dict:
    """The conv path: the paper's Atari conv actor on pixel Catch.

    The int8 / int4 / fp32 actors of Policies A, B and C at ``CONV_ENVS``
    envs: each forward's launches, the quantized ones bitwise their plain
    replay on the card (B1's plain version), at 8 envs within
    ``CONV_CPU_ATOL`` of the CPU's, timed and profiled; a
    ``CONV_ROLL_STEPS`` rollout of each, in turns.  Then DQN on Catch at
    Policy A width (``CONV_TRAIN_RUNS``: exact launch counts, one QAT TD
    update replayed on the CPU, two profiled iterations a run), A7's async
    int8 bar (``A7_RUN``), the three anchors at a small conv net, and B1
    bitwise and timed at every shape these paths gave it.  Each run is
    driven with every count set to 0 just before it and read just after.
    """
    from repro_torch.core import ptq
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.rl import actorq, dqn, loops
    from repro_torch.rl import env as env_mod
    from repro_torch.rl import networks
    from repro_torch.rl.env import batched_env
    from repro_torch.rl.envs import make
    cfgs = quarl_atari()
    env = make("catch")
    rows = dict(forward=[], rollout=[], train=[], b1=[], seconds={})
    b1_seen = []
    t_part = [time.perf_counter()]

    def part_done(name):
        now = time.perf_counter()
        rows["seconds"][name] = now - t_part[0]
        t_part[0] = now

    def record(label, fn):
        for m, k, n, bits in b1_path_shapes(torch, dev, fn):
            if all((m, k, n, bits) != s[1:] for s in b1_seen):
                b1_seen.append((label, m, k, n, bits))

    def counted(fn):
        for c in counters.values():
            c.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t, {k: c.value
                                              for k, c in counters.items()}

    # ---- the actors of Policies A, B and C, params drawn on the card
    actors = {}
    for pname, pcfg in (("A", cfgs.POLICY_A), ("B", cfgs.POLICY_B),
                        ("C", cfgs.POLICY_C)):
        net = networks.make_network(
            env.spec.obs_shape, env.spec.n_actions,
            conv_filters=pcfg.conv_filters, fc_width=pcfg.fc_width,
            device=dev)
        params = net.init(torch.Generator(device=dev).manual_seed(SEED + 80))
        actors[pname] = (net, params, len(pcfg.conv_filters) + 2, {
            b: actorq.pack_actor_params(params, actorq.backend_bits(b))
            for b in ("int8", "int4")})
    for pname, (net, params, layers, caches) in actors.items():
        for n_envs in CONV_ENVS:
            obs = conv_boards(torch, dev, n_envs, SEED + 81)
            for backend in CONV_BACKENDS:
                cache = caches.get(backend)
                if cache is None:
                    def fwd(obs=obs, net=net, params=params):
                        return net.apply(params, obs)
                else:
                    def fwd(obs=obs, cache=cache):
                        return actorq.quantized_apply(cache, obs)
                got, _, n = counted(fwd)
                want = dict.fromkeys(counters, 0)
                if cache is not None:
                    want["int8_matmul"] = layers
                what = f"conv forward Policy {pname} {backend} {n_envs} envs"
                check(n == want, f"{what}: launches {n}, want {want}")
                check(tuple(got.shape) == (n_envs, env.spec.n_actions)
                      and bool(torch.isfinite(got).all()),
                      f"{what}: finite Q of shape {tuple(got.shape)}")
                row = dict(policy=pname, envs=n_envs, backend=backend,
                           launches=n)
                if cache is not None:
                    record(f"conv Policy {pname}", fwd)
                    plain = with_plain_b1(fwd)
                    torch.cuda.synchronize()
                    row["bitwise_plain_replay"] = bool(
                        torch.equal(got, plain)
                        and torch.equal(got.argmax(-1), plain.argmax(-1)))
                    check(row["bitwise_plain_replay"],
                          f"{what}: bitwise its plain replay on the card "
                          f"(max abs diff "
                          f"{float((got - plain).abs().max())})")
                if n_envs == CONV_ENVS[0]:
                    tree = ptq.tree_to(params if cache is None else cache,
                                       "cpu")
                    cpu = (net.apply(tree, obs.cpu()) if cache is None
                           else actorq.quantized_apply(tree, obs.cpu()))
                    diff = (got.cpu() - cpu).abs().amax(-1)
                    top2 = cpu.topk(2, dim=-1).values
                    must = (top2[:, 0] - top2[:, 1]) > 2 * diff
                    agree = got.cpu().argmax(-1) == cpu.argmax(-1)
                    row.update(cpu_max_abs_diff=float(diff.max()),
                               cpu_argmax_equal=int(agree.sum()))
                    check(float(diff.max()) <= CONV_CPU_ATOL
                          and bool(agree[must].all()),
                          f"{what}: the CPU replay differs by "
                          f"{float(diff.max())} (argmax equal on "
                          f"{int(agree.sum())} of {n_envs})")
                    del tree
                prof = profile_calls(torch, fwd, n=5)
                row.update(device_ms=device_ms(torch, fwd, reps=10,
                                               per_rep=5),
                           host_ms=prof["host_ms_per_call"],
                           profiled_device_ms=prof["device_ms_per_call"],
                           kernels=prof["kernels_per_call"],
                           device_busy_share=prof["device_busy_share"],
                           top=prof["top"], card=smi)
                rows["forward"].append(row)
                print("conv forward " + json.dumps(row))
    part_done("forwards")

    # ---- a rollout of each actor, the backends in turns
    cell = 0
    for pname, (net, params, layers, caches) in actors.items():
        for n_envs in CONV_ENVS:
            benv = batched_env(env, n_envs)
            order = CONV_BACKENDS[::-1] if cell % 2 else CONV_BACKENDS
            cell += 1
            for backend in order:
                cfg = dqn.DQNConfig(actor_backend=backend)
                # epsilon at eps_end: the updates count is past the decay
                pol = dqn.make_behaviour_policy(benv, net, cfg)(
                    params, {}, torch.tensor(0, device=dev),
                    torch.tensor(cfg.eps_decay_updates, device=dev),
                    qparams=caches.get(backend))
                gen = torch.Generator(device=dev).manual_seed(SEED + 82)
                state, obs = benv.reset(gen, dev)
                (_, _, traj), wall, n = counted(
                    lambda pol=pol, state=state, obs=obs, gen=gen:
                    env_mod.rollout(benv, pol, params, state, obs, gen,
                                    CONV_ROLL_STEPS))
                want = dict.fromkeys(counters, 0)
                if backend in caches:
                    want["int8_matmul"] = layers * CONV_ROLL_STEPS
                what = f"conv rollout Policy {pname} {backend} {n_envs} envs"
                check(n == want, f"{what}: launches {n}, want {want}")
                check(bool(torch.isfinite(traj.logits_or_value).all()),
                      f"{what}: finite Q-values")
                row = dict(policy=pname, envs=n_envs, backend=backend,
                           order=list(order), steps=CONV_ROLL_STEPS,
                           wall_s=wall,
                           env_steps_per_s=n_envs * CONV_ROLL_STEPS / wall,
                           episodes_ended=int(traj.done.sum()),
                           launches=n, card=smi)
                rows["rollout"].append(row)
                print("conv rollout " + json.dumps(row))
    del actors
    part_done("rollouts")

    # ---- DQN on Catch at Policy A width
    atari = cfgs.ATARI_DQN
    net_kw = dict(conv_filters=atari.conv_filters, fc_width=atari.fc_width)
    layers = len(atari.conv_filters) + 2
    results = {}
    for name, kw in CONV_TRAIN_RUNS:
        if name == "qat8":
            kw = dict(kw, quant=QuantConfig.qat(8, quant_delay=QAT_DELAY))
        box = []
        _, wall, n = counted(lambda kw=kw: record(
            "conv train", lambda: box.append(loops.train(
                "dqn", "catch", iterations=CONV_TRAIN_ITERS,
                record_every=CONV_TRAIN_RECORD, steps_per_call=TRAIN_SPC,
                seed=SEED, net_kwargs=net_kw, **kw))))
        res = box[0]
        cfg = res.algo_cfg
        steps = CONV_TRAIN_ITERS * cfg.rollout_steps    # batched env steps
        updates = CONV_TRAIN_ITERS * cfg.updates_per_iter
        want = dict.fromkeys(counters, 0)
        if name == "qat8":
            # the fp32 actor's forwards (8 envs; evaluations of 8 episodes)
            # and the learner's two a TD update
            f = atari.conv_filters
            want["fake_quant"] = (
                qat_site_launches(f, atari.fc_width, cfg.n_envs) * steps
                + qat_site_launches(f, atari.fc_width, 8) * res.eval_steps
                + 2 * qat_site_launches(f, atari.fc_width, cfg.batch_size)
                * updates)
        elif actorq.is_quantized(cfg.actor_backend):
            want["int8_matmul"] = layers * (steps + res.eval_steps)
        check(n == want, f"conv train {name}: launches {n}, the config "
                         f"implies {want}")
        check(len(res.rewards) == CONV_TRAIN_ITERS // CONV_TRAIN_RECORD
              and all(np.isfinite(res.rewards)),
              f"conv train {name}: rewards {res.rewards}")
        bar = CONV_TRAIN_BARS.get(name)
        check(bar is None or max(res.rewards) > bar,
              f"conv train {name}: max eval reward {max(res.rewards)} does "
              f"not clear its bar {bar} ({res.rewards})")
        row = dict(run=name, rewards=res.rewards, bar=bar, wall_s=wall,
                   updates_per_s=updates / wall,
                   env_steps_per_s=steps * cfg.n_envs / wall,
                   eval_env_steps=res.eval_steps, launches=n,
                   observers={k: [float(o.vmin), float(o.vmax)]
                              for k, o in res.state.observers.items()},
                   card=smi)
        rows["train"].append(row)
        print("conv train " + json.dumps(row))
        results[name] = res

    rows["train"].append(dict(td_replay=td_replay(
        torch, dev, results["qat8"], smi, "conv train")))
    rows["train"] += profile_iterations(torch, dev, results, "conv train")
    del results, res
    part_done("train")

    # ---- A7's convergence bar: async int8 on Catch, verbatim
    box = []
    _, wall, n = counted(lambda: record("conv async", lambda: box.append(
        loops.train("dqn", "catch", **A7_RUN))))
    res = box[0]
    cfg = res.algo_cfg
    steps = A7_RUN["iterations"] * cfg.rollout_steps
    pushes = len(res.actor_lags)
    a7_layers = len(A7_RUN["net_kwargs"]["conv_filters"]) + 2
    want = dict.fromkeys(counters, 0)
    want["int8_matmul"] = a7_layers * (steps + res.eval_steps
                                       + pushes * A7_RUN["num_actors"])
    check(n == want, f"conv async: launches {n}, the config implies {want}")
    divs = np.asarray(res.divergences, dtype=np.float64)
    check(divs.shape == (pushes, A7_RUN["num_actors"])
          and np.isfinite(divs).all() and bool((divs > 0).any()),
          f"conv async: divergences of shape {divs.shape}")
    check(pushes > 0 and all(lag == A7_RUN["sync_every"]
                             for lag in res.actor_lags),
          f"conv async: actor lags {sorted(set(res.actor_lags))}")
    check(max(res.rewards) > A7_BAR,
          f"conv async: max eval reward {max(res.rewards)} does not clear "
          f"{A7_BAR} ({res.rewards})")
    updates = A7_RUN["iterations"] * cfg.updates_per_iter
    row = dict(run="a7_async_int8", rewards=res.rewards, bar=A7_BAR,
               wall_s=wall, updates_per_s=updates / wall,
               env_steps_per_s=steps * cfg.n_envs * A7_RUN["num_actors"]
               / wall, eval_env_steps=res.eval_steps, launches=n,
               pushes=pushes, divergence_first=divs[0].tolist(),
               divergence_last=divs[-1].tolist(),
               divergence_mean=divs.mean(0).tolist(),
               actor_lags=sorted(set(res.actor_lags)), card=smi)
    rows["train"].append(row)
    print("conv async " + json.dumps(row))
    part_done("async")

    # ---- the anchors on the card at a small conv net (cuDNN deterministic)
    check(torch.backends.cudnn.deterministic, "cuDNN is deterministic")
    rows["train"].append(dict(anchors=anchor_runs(
        torch, "catch", smi, "conv",
        net_kwargs=dict(conv_filters=(8, 8), fc_width=32))))
    part_done("anchors")

    # ---- B1 at every shape the conv paths gave it
    gen = torch.Generator(device=dev).manual_seed(SEED + 83)
    for label, m, k, n, bits in b1_seen:
        rows["b1"].append(b1_row(torch, dev, gen, label, m, k, n, bits,
                                 reps=10))
        print("conv kernel " + json.dumps(rows["b1"][-1]))
    part_done("b1_rows")
    print("conv phase parts " + json.dumps(rows["seconds"]))
    return rows


def seq_site_launches(net: dict, batch: int, context: int = 6,
                      feat: int = 27, n_out: int = 3) -> int:
    """B5 launches of one QAT forward of the sequence policy ``net`` on
    ``batch`` frame stacks of ``context`` rows of ``feat`` features: a
    weight site and an activation site a dense layer (embed, q k v o fc
    proj a block, head), each one launch up to 4,096 elements and two
    above."""
    def site(n):
        return 1 if n <= 4096 else 2
    d, f, rows = net["d_model"], net["d_ff"], batch * context
    block = (4 * (site(d * d) + site(rows * d)) + site(d * f)
             + site(rows * f) + site(f * d) + site(rows * d))
    return (site(feat * d) + site(rows * d) + net["n_layers"] * block
            + site(d * n_out) + site(batch * n_out))


def seq_train_kw(topo: str, iterations: int, algo: dict,
                 record_every: int = 0) -> dict:
    """``loops.train`` keywords of the reference's sequence-actor runs
    (``tests/test_seq_policy.py:318-331``): int8, 2 actors pushed every 2
    iterations outside the fused topology, evaluations of 32 episodes
    every ``record_every`` iterations (0: 6 evaluations)."""
    multi = topo != "fused"
    return dict(iterations=iterations, seed=SEED, actor_backend="int8",
                topology=topo, num_actors=2 if multi else 1,
                sync_every=2 if multi else 1,
                net_kwargs={"transformer": dict(SEQ_NET)},
                algo_overrides=dict(algo),
                record_every=record_every or max(iterations // 6, 1),
                eval_episodes=32)


def seq_launches(res, kw: dict, counters) -> dict:
    """The launches a sequence-actor ``loops.train`` run with ``kw`` must
    make: with a quantized actor, B1 at each dense layer (2 + 6 a block)
    of every cached behaviour step, windowed eval step and divergence
    head (one an actor at each push), and B3 once a block a behaviour
    step; under QAT, B5 at every site of both forwards of each TD update
    (and, with the fp32 actor, of every behaviour and eval step)."""
    cfg = res.algo_cfg
    iters = kw["iterations"]
    steps = iters * cfg.rollout_steps
    topo = kw.get("topology", "fused")
    pushes = len(res.actor_lags) if topo == "async" else (
        iters // kw["sync_every"] if topo == "actor-learner" else 0)
    n_l = SEQ_NET["n_layers"]
    want = dict.fromkeys(counters, 0)
    if kw.get("actor_backend", "fp32") != "fp32":
        want["int8_matmul"] = (2 + 6 * n_l) * (
            steps + res.eval_steps + pushes * kw.get("num_actors", 1))
        want["int8_cache_attention"] = n_l * steps
    if "quant" in kw:
        updates = iters * cfg.updates_per_iter
        want["fake_quant"] = 2 * updates * seq_site_launches(
            SEQ_NET, cfg.batch_size)
        if kw.get("actor_backend", "fp32") == "fp32":
            want["fake_quant"] += (
                steps * seq_site_launches(SEQ_NET, cfg.n_envs)
                + res.eval_steps * seq_site_launches(
                    SEQ_NET, kw.get("eval_episodes", 8)))
    return want


def seq_time_rows(torch, dev, smi, counters) -> list:
    """``SEQ_TIME_RUNS`` at ``SEQ_ALGO``: ``SEQ_TIME_ITERS`` fused
    iterations each in chunks of ``SEQ_TIME_CHUNK``, the runs in turns (the
    order reversed every other chunk), each held to its launch counts;
    updates/s and env-steps/s from the host clock around its chunks; host
    and device ms, kernels and device busy an iteration from one further
    profiled iteration."""
    import dataclasses

    from repro_torch.core import ptq
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.rl import dqn, loops, networks
    from repro_torch.rl.envs import make
    env = make("catch_seq")
    net = networks.make_network(env.spec.obs_shape, env.spec.n_actions,
                                transformer=dict(SEQ_NET), device=dev)
    carry, progs = {}, {}
    for name, spec in SEQ_TIME_RUNS:
        kw = dict(spec)
        quant = QuantConfig.qat(8, quant_delay=kw.pop("qat_delay")) \
            if "qat_delay" in kw else QuantConfig.none()
        cfg = dataclasses.replace(dqn.DQNConfig(quant=quant), **SEQ_ALGO,
                                  **kw)
        state = dqn.init(torch.Generator().manual_seed(SEED + 90), env, net,
                         cfg)
        if quant.is_qat:
            state = state._replace(observers=loops._bootstrap_observers(
                "dqn", env, net, state, quant))
        iteration, _, benv = dqn.make_iteration(env, net, cfg, dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + 91)
        env_state, obs = benv.reset(gen, dev)
        carry[name] = [state, env_state, obs, None]
        progs[name] = (iteration, gen, cfg)
    names = [name for name, _ in SEQ_TIME_RUNS]
    wall = dict.fromkeys(names, 0.0)
    launches = {name: dict.fromkeys(counters, 0) for name in names}
    for chunk in range(SEQ_TIME_ITERS // SEQ_TIME_CHUNK):
        for name in (names if chunk % 2 == 0 else names[::-1]):
            iteration, gen, _ = progs[name]
            before = {k: c.value for k, c in counters.items()}
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(SEQ_TIME_CHUNK):
                st, es, ob, _ = carry[name]
                carry[name] = list(iteration(st, es, ob, gen))
            torch.cuda.synchronize()
            wall[name] += time.perf_counter() - t
            for k, c in counters.items():
                launches[name][k] += c.value - before[k]
    rows = []
    for name, spec in SEQ_TIME_RUNS:
        iteration, gen, cfg = progs[name]
        steps = SEQ_TIME_ITERS * cfg.rollout_steps
        updates = SEQ_TIME_ITERS * cfg.updates_per_iter
        want = dict.fromkeys(counters, 0)
        if cfg.actor_backend != "fp32":
            want["int8_matmul"] = (2 + 6 * SEQ_NET["n_layers"]) * steps
            want["int8_cache_attention"] = SEQ_NET["n_layers"] * steps
        if cfg.quant.is_qat:
            want["fake_quant"] = (
                steps * seq_site_launches(SEQ_NET, cfg.n_envs)
                + 2 * updates * seq_site_launches(SEQ_NET, cfg.batch_size))
        check(launches[name] == want,
              f"seq_train timed {name}: launches {launches[name]}, the "
              f"config implies {want}")

        def one(name=name, iteration=iteration, gen=gen):
            st, es, ob, _ = carry[name]
            carry[name] = list(iteration(st, es, ob, gen))
        prof = profile_calls(torch, one, n=1)
        check(all(bool(torch.isfinite(t).all())
                  for _, t in ptq.tree_tensors(carry[name][0].params)),
              f"seq_train timed {name}: finite params")
        row = dict(run=f"seq_time_{name}", iterations=SEQ_TIME_ITERS,
                   wall_s=wall[name], updates_per_s=updates / wall[name],
                   env_steps_per_s=steps * cfg.n_envs / wall[name],
                   launches=launches[name],
                   host_ms_per_iteration=prof["host_ms_per_call"],
                   device_ms_per_iteration=prof["device_ms_per_call"],
                   kernels_per_iteration=prof["kernels_per_call"],
                   device_busy_share=prof["device_busy_share"],
                   top=prof["top"], card=smi)
        rows.append(row)
        print("seq_train " + json.dumps(row))
    return rows


def seq_train_phase(torch, dev, smi, counters) -> dict:
    """The sequence actor in training through ``loops.train``: the
    reference's fused smoke and its convergence bar in the three
    topologies (int8 actors: B1 and B3), a fused QAT int8 run (B5 at every
    site of the TD forwards), each driven with every kernel count set to
    0 just before it and read just after, and held to its counts; the
    anchors bitwise on the card; one TD update of the QAT run and of an
    fp32 run replayed on the CPU within 1e-5; the four actors timed in
    turns (``seq_time_rows``); and B1 at every shape these paths gave it
    (B3's and B5's shapes are ``CACHE_ROWS`` and ``SITE_ROWS`` rows)."""
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.rl import loops
    rows, results, seconds, b1_seen = [], {}, {}, []
    runs = [("smoke", seq_train_kw("fused", 3, SEQ_SMOKE), None)]
    runs += [(f"bar_{topo}", seq_train_kw(topo, SEQ_BAR_ITERS, SEQ_ALGO,
                                          SEQ_BAR_RECORD), SEQ_BAR)
             for topo in ("fused", "actor-learner", "async")]
    qat = seq_train_kw("fused", SEQ_QAT_ITERS, SEQ_ALGO)
    qat["quant"] = QuantConfig.qat(8, quant_delay=SEQ_QAT_DELAY)
    runs.append(("qat8_int8", qat, None))
    fp32 = seq_train_kw("fused", SEQ_QAT_ITERS, SEQ_ALGO)
    fp32["actor_backend"] = "fp32"
    runs.append(("fp32", fp32, None))
    for name, kw, bar in runs:
        t_part = time.perf_counter()
        for c in counters.values():
            c.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        if name == "bar_fused":      # B1's shapes on this path, recorded
            seen = b1_path_shapes(torch, dev, lambda: results.__setitem__(
                name, loops.train("dqn", "catch_seq", **kw)))
            b1_seen += [("seq train", *x) for x in seen]
            res = results[name]
        else:
            res = loops.train("dqn", "catch_seq", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        n = {k: c.value for k, c in counters.items()}
        want = seq_launches(res, kw, counters)
        check(n == want, f"seq_train {name}: launches {n}, the config "
                         f"implies {want}")
        check(all(np.isfinite(res.rewards)) and len(res.rewards) == (
            kw["iterations"] // kw["record_every"]),
              f"seq_train {name}: rewards {res.rewards}")
        check(bar is None or res.rewards[-1] >= bar,
              f"seq_train {name}: last eval reward {res.rewards[-1]} does "
              f"not clear {bar} ({res.rewards})")
        if kw["topology"] != "fused":
            divs = np.asarray(res.divergences, dtype=np.float64)
            check(divs.ndim == 2 and divs.shape[1] == 2
                  and np.isfinite(divs).all() and bool((divs > 0).any()),
                  f"seq_train {name}: divergences {res.divergences}")
        if kw["topology"] == "async":
            # a push at the first round end sync_every updates on: rounds
            # of one rollout and updates_per_iter updates
            per = res.algo_cfg.updates_per_iter
            lag = -(-kw["sync_every"] // per) * per
            check(len(res.actor_lags) > 0 and all(
                x == lag for x in res.actor_lags),
                f"seq_train {name}: actor lags {sorted(set(res.actor_lags))}"
                f" (want {lag})")
        if "quant" in kw:
            check(len(res.state.observers) == 2 + 6 * SEQ_NET["n_layers"]
                  and all(bool(o.initialized)
                          for o in res.state.observers.values()),
                  f"seq_train {name}: observers "
                  f"{sorted(res.state.observers)}")
        cfg = res.algo_cfg
        iters = kw["iterations"]
        actors = kw["num_actors"]
        row = dict(run=name, topology=kw["topology"],
                   actor=kw["actor_backend"], iterations=iters,
                   rewards=res.rewards, bar=bar, wall_s=wall,
                   updates_per_s=iters * cfg.updates_per_iter / wall,
                   env_steps_per_s=iters * cfg.rollout_steps * cfg.n_envs
                   * actors / wall,
                   eval_env_steps=res.eval_steps, launches=n,
                   divergence_last=(res.divergences[-1] if res.divergences
                                    else None),
                   actor_lags=sorted(set(res.actor_lags)), card=smi)
        rows.append(row)
        print("seq_train " + json.dumps(row))
        results[name] = res
        seconds[name] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    rows.append(dict(anchors=anchor_runs(
        torch, "catch_seq", smi, "seq_train",
        net_kwargs={"transformer": dict(SEQ_NET)})))
    rows.append(dict(td_replay=td_replay(torch, dev, results["qat8_int8"],
                                         smi, "seq_train qat8")))
    rows.append(dict(td_replay=td_replay(torch, dev, results["fp32"], smi,
                                         "seq_train fp32")))
    seconds["anchors_replays"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    rows += seq_time_rows(torch, dev, smi, counters)
    seconds["timed"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    shape_rows = []
    gen = torch.Generator(device=dev).manual_seed(SEED + 92)
    for label, m, k, n, bits in b1_seen:
        shape_rows.append(b1_row(torch, dev, gen, label, m, k, n, bits,
                                 reps=10))
        print("seq_train kernel " + json.dumps(shape_rows[-1]))
    seconds["b1_rows"] = time.perf_counter() - t_part
    print("seq_train seconds " + json.dumps(seconds))
    return dict(rows=rows, shape_rows=shape_rows, seconds=seconds,
                qat_launches=next(r["launches"] for r in rows
                                  if r.get("run") == "qat8_int8"),
                bar_launches=next(r["launches"] for r in rows
                                  if r.get("run") == "bar_fused"))


def resume_phase(torch, dev, smi) -> dict:
    """Bitwise resume on the card: each ``RESUME_CASES`` case trained to
    ``RESUME_AT`` with a checkpoint every ``RESUME_AT`` iterations, resumed
    to ``RESUME_TO``, and held bit for bit to the run to ``RESUME_TO``
    without a checkpoint directory (every state leaf, the rewards, action
    variances, divergences, actor lags and eval steps); then
    ``launch.train`` with ``--ckpt-dir``/``--ckpt-every`` and again with
    ``--resume``.  Host ms of each save on the caller's thread and of each
    restore are timed around ``AsyncCheckpointer``'s calls; the bytes of
    each checkpoint and of the learner's fp32 params against their packed
    int8 cache are read."""
    import contextlib
    import io
    import shutil

    from repro_torch import checkpoint as ckpt_lib
    from repro_torch.core.ptq import tree_flatten
    from repro_torch.launch import train as launch_train
    from repro_torch.rl import actorq, loops
    times = {"save": [], "restore": []}
    real = {k: getattr(ckpt_lib.AsyncCheckpointer, f)
            for k, f in (("save", "save_async"), ("restore", "restore"))}

    def timed(key):
        def call(self, *a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real[key](self, *a, **k)
            torch.cuda.synchronize()
            times[key].append((time.perf_counter() - t) * 1e3)
            return out
        return call

    def nbytes(tree):
        return sum(x.numel() * x.element_size()
                   for x in tree_flatten(tree)[1])
    OUT_DIR.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="resume-", dir=OUT_DIR))
    rows = []
    ckpt_lib.AsyncCheckpointer.save_async = timed("save")
    ckpt_lib.AsyncCheckpointer.restore = timed("restore")
    try:
        for label, algo, env_name, topo, extra in RESUME_CASES:
            multi = topo != "fused"
            kw = dict(seed=3, record_every=RESUME_AT, eval_episodes=2,
                      actor_backend="int8",
                      algo_overrides=dict(RESUME_SMALL),
                      net_kwargs=dict(hidden=(16,)), topology=topo,
                      num_actors=2 if multi else 1,
                      sync_every=2 if multi else 1)
            kw.update(extra)
            d = str(root / label.replace(" ", "_"))
            n_save, n_restore = len(times["save"]), len(times["restore"])
            full = loops.train(algo, env_name, iterations=RESUME_TO, **kw)
            loops.train(algo, env_name, iterations=RESUME_AT,
                        checkpoint_dir=d, checkpoint_every=RESUME_AT, **kw)
            res = loops.train(algo, env_name, iterations=RESUME_TO,
                              checkpoint_dir=d, checkpoint_every=RESUME_AT,
                              resume=True, **kw)
            pa, la = tree_flatten(full.state)
            pb, lb = tree_flatten(res.state)
            same = dict(
                leaves=pa == pb and all(torch.equal(x, y)
                                        for x, y in zip(la, lb)),
                rewards=full.rewards == res.rewards,
                action_variances=full.action_variances
                == res.action_variances,
                divergences=full.divergences == res.divergences,
                actor_lags=full.actor_lags == res.actor_lags,
                eval_steps=full.eval_steps == res.eval_steps)
            check(all(same.values()), f"resume {label}: bitwise {same}")
            mgr = ckpt_lib.CheckpointManager(d)
            check(mgr.steps() == [RESUME_AT, RESUME_TO],
                  f"resume {label}: steps {mgr.steps()}")
            step_dir = Path(mgr.step_path(RESUME_TO))
            params = res.state.params
            row = dict(case=label, leaves=len(la), bitwise=same,
                       rewards=res.rewards,
                       checkpoint_bytes=(step_dir / "leaves.bin")
                       .stat().st_size,
                       manifest_bytes=(step_dir / "manifest.json")
                       .stat().st_size,
                       fp32_params_bytes=nbytes(params),
                       int8_cache_bytes=nbytes(
                           actorq.make_actor_cache(params, "int8")),
                       save_host_ms=times["save"][n_save:],
                       restore_ms=times["restore"][n_restore:], card=smi)
            rows.append(row)
            print("resume " + json.dumps(row))
        # the launcher: checkpoints, then a resume, against a run of 6
        d = str(root / "launch_train")
        argv = ["--algo", "ddpg", "--env", "pendulum", "--actor-backend",
                "int8", "--seed", str(SEED)]
        ckpt = ["--ckpt-dir", d, "--ckpt-every", "2"]

        def rewards(more):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                check(launch_train.main(argv + more) == 0,
                      f"launch.train {more}")
            text = out.getvalue()
            print(text.strip())
            start = text.index("eval rewards")
            return text[start:text.index("]", start) + 1]
        full = rewards(["--iterations", "6"])
        check(full.startswith("eval rewards ['") and full.count("'") == 12,
              f"launch.train's six rewards: {full}")
        rewards(["--iterations", "4"] + ckpt)
        resumed = rewards(["--iterations", "6", "--resume"] + ckpt)
        check(resumed == full, f"launch.train --resume: {resumed} against "
                               f"{full}")
        check(ckpt_lib.CheckpointManager(d).steps() == [2, 4, 6],
              "launch.train checkpoints at 2, 4 and 6")
        rows.append(dict(launch_train_resume_bitwise=True, rewards=full,
                         card=smi))
    finally:
        ckpt_lib.AsyncCheckpointer.save_async = real["save"]
        ckpt_lib.AsyncCheckpointer.restore = real["restore"]
        shutil.rmtree(root, ignore_errors=True)
    return dict(rows=rows)


def resilience_phase(torch, dev, smi, counters) -> dict:
    """The self-healing runtime on the card.

    The reference's chaos matrix in the three topologies (every count set
    to 0 just before it and read just after: B1 serves each int8 actor),
    each fired and not-applicable set the reference's and shard 0
    quarantined; its retry and rollback cases bitwise their clean runs
    (params and rewards); its abort ladder (4 attempts); its convergence
    case at full width, bitwise its clean run; the topology phase's
    actor-learner int8 run guarded but not faulted against bare, in turns
    (updates/s, no bound; the guarded run bitwise the bare one); a
    ``PolicyServer(max_queue=)`` offered a burst at ``SHED_FACTOR`` times
    its sustained rate; a worker crash through ``serving_fault_hook``; and
    ``launch.train --fault-plan``."""
    import contextlib
    import io
    import shutil

    from repro_torch import resilience as rz
    from repro_torch.core.ptq import tree_flatten
    from repro_torch.launch import train as launch_train
    from repro_torch.rl import loops

    def kwargs(topo, **kw):
        multi = topo != "fused"
        out = dict(algo="dqn", env_name="cartpole", iterations=6, seed=3,
                   record_every=3, eval_episodes=2, actor_backend="int8",
                   algo_overrides=dict(RZ_SMALL),
                   net_kwargs=dict(hidden=(16,)), topology=topo,
                   num_actors=2 if multi else 1,
                   sync_every=2 if multi else 1)
        out.update(kw)
        return out

    def same(a, b):
        la, lb = tree_flatten(a.state.params)[1], tree_flatten(
            b.state.params)[1]
        return all(torch.equal(x, y) for x, y in zip(la, lb)) \
            and a.rewards == b.rewards

    OUT_DIR.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="resilience-", dir=OUT_DIR))
    rows = []
    try:
        # the chaos matrix: the phase's main path
        for c in counters.values():
            c.reset()
        for topo, spec, fired, na in RZ_MATRIX:
            plan = rz.FaultPlan.parse(spec)
            t = time.perf_counter()
            res, rep = rz.supervise(
                kwargs(topo, iterations=8, checkpoint_dir=str(root / topo),
                       checkpoint_every=2),
                plan=plan, config=rz.SupervisorConfig(max_retries=4))
            wall = time.perf_counter() - t
            got_fired = {k for k, _, _ in rep.faults_fired}
            got_na = {k for k, _, _ in rep.faults_not_applicable}
            check(rep.status == "ok" and got_fired == fired
                  and got_na == na and rep.quarantined == [0]
                  and len(rep.faults_fired) + len(rep.faults_not_applicable)
                  == len(plan.faults) and all(np.isfinite(res.rewards)),
                  f"chaos {topo}: {rep.summary()}")
            row = dict(chaos=topo, plan=spec, attempts=rep.attempts,
                       retries=rep.retries, fired=rep.faults_fired,
                       not_applicable=[k for k, _, _ in
                                       rep.faults_not_applicable],
                       events=[e[0] for e in rep.events],
                       rewards=res.rewards, wall_s=wall, card=smi)
            rows.append(row)
            print("resilience " + json.dumps(row))
        matrix_launches = {k: c.value for k, c in counters.items()}
        check(matrix_launches["int8_matmul"] > 0,
              f"the chaos matrix launched no int8_matmul: {matrix_launches}")
        # retry and rollback, bitwise their clean runs
        ref = loops.train(**kwargs("fused"))
        res, rep = rz.supervise(
            kwargs("fused", checkpoint_dir=str(root / "retry"),
                   checkpoint_every=3),
            plan=rz.FaultPlan.parse("5:nan_grad@4"))
        check(rep.retries == 1 and rep.rollbacks == 0 and same(ref, res),
              f"retry: {rep.summary()}; bitwise {same(ref, res)}")
        quick = rz.SupervisorConfig(max_retries=1, max_rollbacks=1,
                                    backoff_base_s=0.001,
                                    backoff_cap_s=0.002)
        ref = loops.train(**kwargs("actor-learner", record_every=6))
        res, rep = rz.supervise(
            kwargs("actor-learner", record_every=6,
                   checkpoint_dir=str(root / "rollback"),
                   checkpoint_every=1),
            plan=rz.FaultPlan.parse("5:nan_grad@3"),
            guard=rz.GuardConfig(check_every=2), config=quick)
        check(rep.rollbacks == 1 and same(ref, res),
              f"rollback: {rep.summary()}; bitwise {same(ref, res)}")
        try:
            rz.supervise(kwargs("fused", iterations=4,
                                checkpoint_dir=str(root / "abort"),
                                checkpoint_every=2),
                         plan=rz.FaultPlan.parse("3:actor_crash@2:repeat=99"),
                         config=quick)
            check(False, "abort: the supervisor did not abort")
        except rz.SupervisorAbort as e:
            check(e.report.attempts == 4 and e.report.retries == 2
                  and e.report.rollbacks == 1,
                  f"abort: {e.report.summary()}")
        rows.append(dict(retry_bitwise=True, rollback_bitwise=True,
                         abort_attempts=4, card=smi))
        # the convergence case at full width
        kw = dict(algo="dqn", env_name="cartpole", iterations=60, seed=0,
                  record_every=20, eval_episodes=4, actor_backend="int8",
                  topology="actor-learner", num_actors=2, sync_every=2)
        t = time.perf_counter()
        ref = loops.train(**kw)
        t_ref = time.perf_counter() - t
        t = time.perf_counter()
        res, rep = rz.supervise(dict(kw, checkpoint_dir=str(root / "conv"),
                                     checkpoint_every=5),
                                plan=rz.FaultPlan.parse(RZ_CONVERGE_PLAN))
        t_sup = time.perf_counter() - t
        check(rep.status == "ok" and len(rep.faults_fired) == 4
              and same(ref, res),
              f"convergence: {rep.summary()}; bitwise {same(ref, res)}")
        row = dict(convergence=True, rewards=res.rewards,
                   attempts=rep.attempts, clean_wall_s=t_ref,
                   supervised_wall_s=t_sup, card=smi)
        rows.append(row)
        print("resilience " + json.dumps(row))
        # guard overhead: the topology phase's actor-learner int8 run,
        # guarded and unfaulted against bare, in turns
        name, topo_kw = TOPO_RUNS[0]
        walls = {"bare": [], "guarded": []}
        hook_s = []
        runs = {}
        for which in ("bare", "guarded", "guarded", "bare"):
            extra = {}
            if which == "guarded":
                extra["resilience"] = timed_hooks(rz.ResilienceContext(),
                                                  hook_s)
            torch.cuda.synchronize()
            t = time.perf_counter()
            runs[which] = loops.train(
                "dqn", "cartpole", iterations=RZ_OVERHEAD_ITERS,
                record_every=RZ_OVERHEAD_RECORD, seed=SEED,
                num_actors=TOPO_ACTORS, **topo_kw, **extra)
            torch.cuda.synchronize()
            walls[which].append(time.perf_counter() - t)
        check(same(runs["bare"], runs["guarded"]),
              "guard overhead: the guarded run is not the bare run")
        updates = RZ_OVERHEAD_ITERS * runs["bare"].algo_cfg.updates_per_iter
        row = dict(guard_overhead=name, iterations=RZ_OVERHEAD_ITERS,
                   wall_s=walls, hooks_s=sum(hook_s) / 2,
                   updates_per_s={k: [updates / w for w in v]
                                  for k, v in walls.items()},
                   ratio=sum(walls["guarded"]) / sum(walls["bare"]),
                   card=smi)
        rows.append(row)
        print("resilience " + json.dumps(row))
        rows += server_hardening(torch, dev, smi)
        # the launcher: one planned NaN, one retry
        d = str(root / "launch_train")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = launch_train.main(
                ["--algo", "dqn", "--env", "cartpole", "--actor-backend",
                 "int8", "--iterations", "20", "--fault-plan",
                 "5:nan_grad@4", "--ckpt-dir", d, "--ckpt-every", "2"])
        text = out.getvalue()
        print(text.strip())
        check(rc == 0 and "supervisor: ok after 2 attempt(s) (1 retries, "
              "0 rollbacks)" in text, f"launch.train --fault-plan: {text}")
        rows.append(dict(launch_train_fault_plan="status ok", card=smi))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict(rows=rows, launches=matrix_launches)


def timed_hooks(ctx, seconds: list):
    """``ctx`` with the host time of each driver hook it serves appended
    to ``seconds``."""
    for name in ("round_start", "dropped_sync_na", "after_round",
                 "verify_state_cache", "on_eval_cache",
                 "checkpoint_committed"):
        def timed(*a, _real=getattr(ctx, name), **k):
            t = time.perf_counter()
            try:
                return _real(*a, **k)
            finally:
                seconds.append(time.perf_counter() - t)
        setattr(ctx, name, timed)
    return ctx


def server_hardening(torch, dev, smi) -> list:
    """The hardened ``PolicyServer`` on the card (AirNav, Policy II,
    int8): a straggling server (``serving_fault_hook`` sleeping
    ``SHED_DELAY_S`` a batch) offered a burst at ``SHED_FACTOR`` times the
    rate it sustains with a full queue sheds with ``QueueFullError`` and
    answers every request it accepted; a worker crash through
    ``serving_fault_hook`` restarts the worker and later requests are
    answered."""
    from repro_torch.resilience import faults
    from repro_torch.rl import networks
    from repro_torch.rl.envs import make
    from repro_torch.serving import PolicyServer, QueueFullError
    env = make("airnav")
    widths = quarl_atari().DEPLOY_POLICY_II.widths
    params = networks.init_mlp(
        networks.mlp_spec(env.spec.obs_shape[0], widths, env.spec.n_actions),
        torch.Generator().manual_seed(SEED + 1), dev)
    _, obs = env.reset(torch.Generator().manual_seed(SEED), 512, dev)
    o_host = obs.cpu().numpy()
    slow = faults.ResilienceContext(faults.FaultInjector(
        faults.FaultPlan.parse(f"1:straggler@0:delay_s={SHED_DELAY_S}:"
                               f"repeat={10 ** 9}")))
    srv = PolicyServer(env.spec, actor_backend="int8", buckets=SHED_BUCKETS,
                       max_queue=SHED_QUEUE,
                       fault_hook=slow.serving_fault_hook(), device="cuda")
    srv.push_params(params)
    srv.warmup()
    sids = [srv.open_session() for _ in range(len(o_host))]
    rows = []
    with srv:
        # the rate it sustains: the bound's worth of requests queued at
        # once, again and again
        t = time.perf_counter()
        served = 0
        while time.perf_counter() - t < SHED_S:
            reqs = [srv.submit(sids[i], o_host[i])
                    for i in range(SHED_QUEUE)]
            for r in reqs:
                r.result(timeout=60)
            served += len(reqs)
        sustained = served / (time.perf_counter() - t)
        # the burst, paced at SHED_FACTOR x that rate; the submitter
        # sleeps when it is ahead, so the worker is not starved of the
        # interpreter lock
        rate = SHED_FACTOR * sustained
        accepted, shed, k = [], 0, 0
        t = time.perf_counter()
        while (now := time.perf_counter() - t) < SHED_S:
            while k < now * rate:
                try:
                    accepted.append(srv.submit(sids[k % len(sids)],
                                               o_host[k % len(sids)]))
                except QueueFullError:
                    shed += 1
                k += 1
            time.sleep(0.0002)
        offered_s = time.perf_counter() - t
        answered = sum(r.result(timeout=60) is not None for r in accepted)
        burst_s = time.perf_counter() - t
    stats = srv.stats()
    check(shed > 0 and stats["rejected"] == shed
          and answered == len(accepted)
          and stats["worker"]["dispatch_failures"] == 0,
          f"load shedding: {shed} shed, {answered} of {len(accepted)} "
          f"accepted answered, stats {stats}")
    row = dict(load_shedding=True, batch_delay_s=SHED_DELAY_S,
               sustained_per_s=sustained,
               offered_per_s=k / offered_s,
               served_in_burst_per_s=len(accepted) / burst_s,
               accepted=len(accepted), shed=shed, max_queue=SHED_QUEUE,
               card=smi)
    rows.append(row)
    print("resilience " + json.dumps(row))
    # a worker crash, then service again
    ctx = faults.ResilienceContext(faults.FaultInjector(
        faults.FaultPlan.parse("5:actor_crash@1")))
    srv = PolicyServer(env.spec, actor_backend="int8", buckets=SHED_BUCKETS,
                       max_wait_us=200, fault_hook=ctx.serving_fault_hook(),
                       device="cuda")
    srv.push_params(params)
    sid = srv.open_session()
    with srv:
        first = srv.submit(sid, o_host[0]).result(timeout=60)
        try:
            srv.submit(sid, o_host[1]).result(timeout=60)
            crashed = False
        except faults.ActorCrashError:
            crashed = True
        later = [srv.submit(sid, o_host[i]).result(timeout=60)
                 for i in range(2, 10)]
    stats = srv.stats()
    check(crashed and first is not None and len(later) == 8
          and stats["worker"]["crashes"] == 1
          and stats["worker"]["restarts"] == 1 and stats["served"] == 9,
          f"worker crash: crashed {crashed}, stats {stats}")
    row = dict(worker_crash=True, crashes=1, restarts=1,
               served_after=len(later), card=smi)
    rows.append(row)
    print("resilience " + json.dumps(row))
    return rows


def with_plain_b2(fn):
    """``fn()`` with B2's plain version in the kernel's place (no launch
    counted)."""
    from repro_torch.kernels import fused_qmlp
    orig = fused_qmlp.fused_qmlp_cuda
    fused_qmlp.fused_qmlp_cuda = fused_qmlp.fused_qmlp_plain
    try:
        return fn()
    finally:
        fused_qmlp.fused_qmlp_cuda = orig


def host_stalls(dispatches, spans, collections) -> dict:
    """The serving host's stalls: each gap over ``STALL_MS`` between one
    dispatch's end and the next one's start, and each dispatch over it,
    with the host spans (the launcher's steps, the garbage collector's
    passes) that overlap it."""
    def around(t0, t1):
        return [[name, (a - t0) * 1e3, (b - a) * 1e3]
                for name, a, b in spans + collections if a < t1 and b > t0]
    gaps = [dict(after_dispatch=i, gap_ms=(b0 - a1) * 1e3,
                 spans=around(a1, b0))
            for i, ((_, a1), (b0, _)) in enumerate(zip(dispatches,
                                                       dispatches[1:]))
            if (b0 - a1) * 1e3 > STALL_MS]
    slow = [dict(dispatch=i, ms=(t1 - t0) * 1e3, spans=around(t0, t1))
            for i, (t0, t1) in enumerate(dispatches)
            if (t1 - t0) * 1e3 > STALL_MS]
    return dict(gaps=gaps, slow_dispatches=slow,
                gc_passes=len(collections),
                gc_ms=sum((b - a) * 1e3 for _, a, b in collections))


def serve_rl_phase(torch, dev, smi, counters) -> dict:
    """``launch.serve --rl-env`` on the card, each of ``SERVE_RL_RUNS``:
    training through ``train_policy``, then, with every count set to 0,
    the serving stage (``serve_policy``: calibration, push, warmup,
    sessions, hot-swap).  Each run answers every request, moves the
    version at the hot-swap, launches exactly B1 (n_hidden + 1) a dispatch
    (warmup buckets included) and the calibration's per-layer launches,
    or B2 once a dispatch, and serves one dispatch's actions bitwise
    equal to the same cache's actions through the plain kernels on the
    card.  Each dispatch's host span and the garbage collector's passes
    are recorded for ``host_stalls``."""
    import gc

    from repro_torch.launch import serve
    from repro_torch.rl import actorq
    from repro_torch.serving import PolicyServer, pad_rows, select_bucket
    rows, totals = [], dict.fromkeys(counters, 0)
    real_serve_batch = PolicyServer.serve_batch
    dispatches, collections, gc_start = [], [], {}

    def timed_batch(self, requests):
        t0 = time.perf_counter()
        try:
            return real_serve_batch(self, requests)
        finally:
            dispatches.append((t0, time.perf_counter()))

    def on_gc(phase, info):
        if phase == "start":
            gc_start["t"] = time.perf_counter()
        elif "t" in gc_start:
            collections.append((f"gc{info['generation']}",
                                gc_start.pop("t"), time.perf_counter()))
    for label, argv in SERVE_RL_RUNS:
        args = serve.parse_args(argv + ["--seed", str(SEED)])
        t = time.perf_counter()
        algo, env, res = serve.train_policy(args)
        train_s = time.perf_counter() - t
        for c in counters.values():
            c.reset()
        dispatches.clear()
        collections.clear()
        PolicyServer.serve_batch = timed_batch
        gc.callbacks.append(on_gc)
        try:
            out = serve.serve_policy(args, algo, env, res)
        finally:
            gc.callbacks.remove(on_gc)
            PolicyServer.serve_batch = real_serve_batch
        n = {k: c.value for k, c in counters.items()}
        for k, v in n.items():
            totals[k] += v
        server, entry = out["server"], out["entry"]
        stats = server.stats()
        want_n = args.serve_sessions * args.serve_steps
        check(out["answered"] == want_n and stats["served"] == want_n
              and stats["worker"]["dispatch_failures"] == 0,
              f"serve_rl {label}: {out['answered']} of {want_n} answered")
        check(out["swap_version"] == entry.version + 1
              == stats["version"]
              and {r.version for r in out["last_results"]}
              == {out["swap_version"]},
              f"serve_rl {label}: versions {entry.version} -> "
              f"{out['swap_version']}, stats {stats['version']}")
        n_hidden = sum(1 for k in entry.cache if k.startswith("fc"))
        per_dispatch = stats["dispatches"] + len(server.buckets)
        want = dict.fromkeys(counters, 0)
        if actorq.ACT_QUANT in entry.cache:
            # greedy calibration: 7 uncalibrated steps; each of the two
            # pushes calibrates through its hidden layers
            want["int8_matmul"] = 7 * (n_hidden + 1) + 2 * n_hidden
            want["fused_qmlp"] = per_dispatch
        else:
            want["int8_matmul"] = (n_hidden + 1) * per_dispatch
        check(n == want, f"serve_rl {label}: launches {n}, want {want}")
        # one dispatch of the last step against the plain kernels on the
        # same cache, on the card
        groups = {}
        for i, r in enumerate(out["last_results"]):
            groups.setdefault(r.step, []).append(i)
        idx = next(iter(groups.values()))
        batch = pad_rows(out["last_obs"][idx],
                         select_bucket(len(idx), server.buckets))
        act = actorq.make_act_fn(env.spec)
        cache = server.current.cache
        plain = with_plain_b1(lambda: with_plain_b2(lambda: act(
            cache, torch.from_numpy(batch).to(dev)))).cpu().numpy()
        served = np.stack([out["last_results"][i].action for i in idx])
        check(np.array_equal(served, plain[:len(idx)]),
              f"serve_rl {label}: a dispatch of {len(idx)} served actions "
              f"equals the plain kernels' bitwise")
        lat = np.asarray(out["latencies_s"]) * 1e3
        row = dict(run=label, argv=argv, algo=algo, train_s=train_s,
                   sessions=args.serve_sessions, steps=args.serve_steps,
                   answered=out["answered"], dispatches=stats["dispatches"],
                   launches=n, actions_per_s=out["actions_per_s"],
                   p50_ms=float(np.percentile(lat, 50)),
                   p99_ms=float(np.percentile(lat, 99)),
                   versions=[entry.version, out["swap_version"]],
                   stalls=host_stalls(dispatches, out["spans"],
                                      collections),
                   card=smi)
        rows.append(row)
        print("serve_rl " + json.dumps(row))
    return dict(rows=rows, launches=totals)


def cache_inputs(torch, dev, gen, nb, nh, g, t, dh, how, layout):
    """Seeded B3 inputs for a ``CACHE_ROWS`` row on the card: ``(q,
    k_codes, k_scale, v_codes, v_scale, pos)``, the cache as a strided
    view in the "lm" layout."""
    from repro_torch.core import affine
    shape = (nb, t, nh, dh) if layout == "lm" else (nb * nh, t, dh)
    kc, ks = affine.quantize_symmetric(
        torch.randn(shape, generator=gen).to(dev) * 2.0)
    vc, vs = affine.quantize_symmetric(torch.randn(shape, generator=gen
                                                   ).to(dev))
    lead = (nb, nh) if layout == "lm" else (nb * nh,)
    q = torch.randn(lead + (g, dh), generator=gen).to(dev)
    pos = (torch.randint(0, t, lead, generator=gen) if how == "ragged"
           else torch.full(lead, t - 1)).to(torch.int32).to(dev)
    if layout == "lm":
        kc, ks, vc, vs = (x.transpose(1, 2) for x in (kc, ks, vc, vs))
    return q, kc, ks, vc, vs, pos


def cache_rows(torch, dev, gen) -> list:
    """B3 against its plain version at every ``CACHE_ROWS`` row, timed
    beside its plain version, its bound and one SDPA call."""
    import torch.nn.functional as F

    from repro_torch.kernels import int8_cache_attention as ca
    rows = []
    for label, nb, nh, g, t, dh, window, how, layout in CACHE_ROWS:
        r = nb * nh
        args = cache_inputs(torch, dev, gen, nb, nh, g, t, dh, how, layout)
        q, kc, ks, vc, vs, pos = args
        got = ca.int8_cache_attention_cuda(*args, window)
        again = ca.int8_cache_attention_cuda(*args, window)
        want = ca.int8_cache_attention_plain(*args, window)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(bool(torch.allclose(got, want, rtol=CACHE_ATOL,
                                  atol=CACHE_ATOL)),
              f"int8_cache_attention {label} pos={how} within {CACHE_ATOL} "
              f"of the plain version (max abs diff {err})")
        check(torch.equal(got, again), f"int8_cache_attention {label}: two "
                                       f"calls in a row agree")
        p = pos.reshape(-1).cpu()
        lo = (p - window + 1).clamp(min=0) if window else 0
        n_slots = int((p - lo + 1).sum())         # the slots B3 must read
        # yardstick: one SDPA call on K/V dequantized beforehand (the
        # dequant left out), with the boolean causal / window mask
        kf = (kc.to(torch.float32) * ks).reshape(r, t, dh)
        vf = (vc.to(torch.float32) * vs).reshape(r, t, dh)
        qf, pf = q.reshape(r, g, dh), pos.reshape(r, 1)
        idx = torch.arange(t, device=dev)
        mask = idx <= pf
        if window:
            mask &= idx > pf - window
        mask = mask[:, None, :]

        def sdpa(qf=qf, kf=kf, vf=vf, mask=mask):
            return F.scaled_dot_product_attention(qf, kf, vf,
                                                  attn_mask=mask)
        io = 2 * 4 * r * g * dh + 4 * r           # q in, out, pos
        b_ms, b_by = bound(n_slots * (2 * dh + 8) + io,
                           4.0 * n_slots * g * dh, F32_OPS_PER_S)
        rows.append(dict(
            name="int8_cache_attention", label=label, pos=how,
            layout=layout, shape=[nb, nh, g, t, dh], window=window,
            slots_read=n_slots, plan=ca.plan(r, g, t, dh, window),
            max_abs_err=err,
            sdpa_max_abs_err=float((sdpa().reshape(want.shape) - want
                                    ).abs().max()),
            ms=device_ms(torch, lambda: ca.int8_cache_attention_cuda(
                *args, window)),
            plain_ms=device_ms(torch, lambda: ca.int8_cache_attention_plain(
                *args, window)),
            bound_ms=b_ms, bound_by=b_by,
            full_cache_bound_ms=bound(r * t * (2 * dh + 8) + io, 0.0)[0],
            library_ms=device_ms(torch, sdpa),
            library="scaled_dot_product_attention, K/V dequantized before"))
        del args, q, kc, ks, vc, vs, kf, vf, got, again, want
    return rows


def flash_pairs(s: int, t: int, causal: bool, window) -> int:
    """Unmasked (query, key) pairs of one head, query positions aligned to
    the end of the kv axis."""
    q_pos = np.arange(s) + (t - s)
    hi = np.minimum(q_pos, t - 1) if causal else np.full(s, t - 1)
    lo = np.maximum(q_pos - window + 1, 0) if window else np.zeros(s, int)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_rows(torch, dev, gen) -> list:
    """Kernel B4 against its plain version at ``FLASH_ROWS``, within
    ``FLASH_ATOL``, timed beside the plain version and, where there is no
    soft-cap, one ``scaled_dot_product_attention`` call with the same
    boolean mask (K and V repeated to the query heads beforehand)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, ref
    rows = []
    for label, b, h, kv, s, t, d, causal, window, softcap in FLASH_ROWS:
        q = torch.randn((b, s, h, d), generator=gen, device=dev)
        k = torch.randn((b, t, kv, d), generator=gen, device=dev) * 1.5
        v = torch.randn((b, t, kv, d), generator=gen, device=dev)
        kw = dict(causal=causal, window=window, softcap=softcap)
        got = flash_attention.flash_attention_cuda(q, k, v, **kw)
        want = flash_attention.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(bool(torch.allclose(got, want, rtol=FLASH_ATOL,
                                  atol=FLASH_ATOL)),
              f"flash_attention {label} within {FLASH_ATOL} of the plain "
              f"version (max abs diff {err})")
        del got, want
        pairs = b * h * flash_pairs(s, t, causal, window)
        nbytes = 4 * (2 * b * s * h * d + 2 * b * t * kv * d)
        # the float32 work on the FMA pipes, or three times it on the TF32
        # tensor cores (3xTF32 holds float32 accuracy): the faster binds
        fma_ms, fma_by = bound(nbytes, 4.0 * d * pairs, F32_OPS_PER_S)
        b_ms, b_by = bound(nbytes, 3 * 4.0 * d * pairs, TF32_OPS_PER_S)
        kind = "3xTF32 tensor cores"
        if fma_ms < b_ms:
            b_ms, b_by, kind = fma_ms, fma_by, "float32 FMA"
        big = s * t > 2 ** 22
        reps = dict(reps=5, per_rep=2) if big else {}
        lib_ms = lib_err = None
        if softcap is None:
            g = h // kv
            qt = q.transpose(1, 2).contiguous()
            kt = k.transpose(1, 2).repeat_interleave(g, 1).contiguous()
            vt = v.transpose(1, 2).repeat_interleave(g, 1).contiguous()
            mask = ref.attention_mask(s, t, causal=causal, window=window,
                                      device=dev)

            def sdpa(qt=qt, kt=kt, vt=vt, mask=mask, d=d):
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask,
                                                      scale=d ** -0.5)
            lib_ms = device_ms(torch, sdpa, **reps)
            lib_err = float((sdpa().transpose(1, 2) - flash_attention.
                             flash_attention_plain(q, k, v, **kw)).abs()
                            .max())
            del qt, kt, vt, mask
        rows.append(dict(
            name="flash_attention", label=label,
            shape=dict(B=b, H=h, KV=kv, S=s, T=t, D=d), causal=causal,
            window=window, softcap=softcap, unmasked_pairs=pairs,
            plan=flash_attention.plan(b, s, t, h, kv, d, causal=causal,
                                      window=window),
            max_abs_err=err,
            ms=device_ms(torch, lambda: flash_attention.flash_attention_cuda(
                q, k, v, **kw), **reps),
            plain_ms=device_ms(torch, lambda: flash_attention.
                               flash_attention_plain(q, k, v, **kw), **reps),
            bound_ms=b_ms, bound_by=b_by, bound_kind=kind,
            fma_bound_ms=fma_ms, library_ms=lib_ms,
            library=("scaled_dot_product_attention, K/V repeated before"
                     if softcap is None else None),
            library_max_abs_diff=lib_err))
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def lm_phase(torch, dev, smi, counters) -> dict:
    """The LM inference path at full width and depth.

    ``transformer.prefill`` of ``LM_PREFILL`` tokens (B4 once per layer;
    counted, then timed twice and profiled once), the card's 64-token
    prefill against the port's CPU path on the same params, and against
    64 token-by-token ``decode_step``s; a decode step at a ``LM_LONG``
    context (``decode_long``); then ``launch.serve.main`` three ways (fp32
    cache, int8 cache through B3, PTQ int8 weights through B5), each with
    every count set to 0 just before it and read just after."""
    import contextlib
    import io
    import re

    from repro_torch.configs import base as cfgs
    from repro_torch.core import ptq
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    cfg = cfgs.get_reduced(LM_ARCH) if LM_REDUCED else cfgs.get(LM_ARCH)
    rows = {}
    t = time.perf_counter()
    # drawn on the card (a CUDA generator), then copied to the CPU for
    # the comparisons: the CPU's draws of 1.83 B normals took about 17 s
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    t = time.perf_counter()
    params_cpu = ptq.tree_to(params, "cpu")
    to_cpu_s = time.perf_counter() - t
    n_params = sum(x.numel() for _, x in ptq.tree_tensors(params))
    b, s = LM_PREFILL
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=torch.Generator(
        ).manual_seed(SEED + 30)).to(dev)

    def prefill():
        return transformer.prefill(cfg, params, tokens)
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits = prefill()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    n = {k: c.value for k, c in counters.items()}
    want = {k: 0 for k in counters}
    want["flash_attention"] = cfg.n_layers
    check(n == want, f"prefill launches {n}, want {want}")
    check(tuple(logits.shape) == (b, 1, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"prefill logits {tuple(logits.shape)} finite")
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    prof = profile_calls(torch, prefill, n=1)
    rows["prefill"] = dict(
        arch=cfg.name, params=n_params, batch=b, tokens=s,
        init_card_s=init_s, params_to_cpu_s=to_cpu_s, first_s=first_s,
        wall_s=walls, tokens_per_s=[b * s / w for w in walls],
        peak_gb=torch.cuda.max_memory_allocated() / 1e9, launches=n,
        profile=prof, card=smi)
    print("lm prefill " + json.dumps(rows["prefill"]))

    # the card against the port's CPU path, on a LM_SHORT-token prompt
    short = tokens[:, :LM_SHORT]
    card = transformer.prefill(cfg, params, short).cpu()
    t = time.perf_counter()
    cpu = transformer.prefill(cfg, params_cpu, short.cpu())
    cpu_s = time.perf_counter() - t
    diff = float((card - cpu).abs().max())
    check(diff <= LM_CPU_ATOL, f"card vs CPU prefill logits: max abs diff "
                               f"{diff} (tolerance {LM_CPU_ATOL})")
    # ... and against token-by-token decode on the card
    full = transformer.forward(cfg, params, short)
    caches = transformer.init_caches(cfg, b, LM_SHORT, device=dev)
    worst = 0.0
    for pos in range(LM_SHORT):
        step, caches = transformer.decode_step(cfg, params,
                                               short[:, pos:pos + 1], caches,
                                               pos)
        worst = max(worst, float((step[:, 0] - full[:, pos]).abs().max()))
    check(worst <= LM_DECODE_ATOL, f"prefill vs {LM_SHORT} decode steps: "
                                   f"max abs diff {worst}")
    # where a decode step's time goes (batch 1, the last slot rewritten)
    tok, last_pos = short[:, -1:], torch.tensor(LM_SHORT - 1, device=dev)
    decode_prof = profile_calls(torch, lambda: transformer.decode_step(
        cfg, params, tok, caches, last_pos), n=5)
    print("lm decode profile " + json.dumps(decode_prof))
    last = float((card - full[:, -1:].cpu()).abs().max())
    rows["parity"] = dict(tokens=LM_SHORT, card_vs_cpu_max_abs_diff=diff,
                          card_vs_cpu_tolerance=LM_CPU_ATOL,
                          logits_max_abs=float(cpu.abs().max()),
                          cpu_prefill_s=cpu_s,
                          prefill_vs_decode_max_abs_diff=worst,
                          prefill_vs_forward_last_max_abs_diff=last,
                          decode_step_profile=decode_prof)
    print("lm parity " + json.dumps(rows["parity"]))
    del params_cpu, logits, full, caches
    torch.cuda.empty_cache()
    rows["decode_long"] = decode_long(torch, dev, cfg, params, counters, smi)
    del params
    torch.cuda.empty_cache()

    # decode through the serve launcher, three ways
    n_weights = _spec_weights(transformer.param_specs(cfg))
    check(LM_REDUCED or n_weights == 11,
          f"danube has 11 weight leaves for PTQ, counted {n_weights}")
    steps = sum(int(LM_SERVE_ARGS[LM_SERVE_ARGS.index(f) + 1])
                for f in ("--prompt-len", "--new-tokens")) - 1
    rows["serve"] = []
    for label, extra in LM_SERVE_RUNS:
        argv = LM_SERVE_ARGS + (["--reduced"] if LM_REDUCED else []) + extra
        for c in counters.values():
            c.reset()
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = serve.main(argv)
        wall = time.perf_counter() - t
        out = buf.getvalue()
        print(out, end="")
        n = {k: c.value for k, c in counters.items()}
        want = {k: 0 for k in counters}
        if "--int8-cache" in extra:
            want["int8_cache_attention"] = cfg.n_layers * steps
        if "--quant" in extra:
            want["fake_quant"] = n_weights
        check(rc == 0, f"serve {label}: exit {rc}")
        check(n == want, f"serve {label}: launches {n}, want {want}")
        m = re.search(r"in ([\d.]+)s \(([\d.]+) tok/s on (.+)\)", out)
        check(m is not None and m.group(3) == torch.cuda.get_device_name(0),
              f"serve {label}: printed its rate on the card ({out!r})")
        first = re.search(r"first sequence: \[(.*)\]", out).group(1)
        row = dict(run=label, argv=argv, decode_s=float(m.group(1)),
                   tokens_per_s=float(m.group(2)), main_wall_s=wall,
                   launches=n, first_sequence=first, card=smi)
        rows["serve"].append(row)
        print("lm serve " + json.dumps(row))
    return rows


def long_caches(torch, dev, cfg, batch: int, size: int):
    """Full decode caches of ``size`` slots, every slot written: seeded
    int8 codes and scales, and the float32 cache holding the same K and V
    (codes times scales).  Returns ``(int8 caches, float32 caches)``."""
    from repro_torch.models import transformer
    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    c8 = transformer.init_caches(cfg, batch, size, int8=True, device=dev)
    c32 = transformer.init_caches(cfg, batch, size, int8=False, device=dev)
    pairs = [(a["kv"], b["kv"]) for a, b in zip(
        list(c8["stacked"].values()) + c8["remainder"],
        list(c32["stacked"].values()) + c32["remainder"])]
    for kv8, kv32 in pairs:
        for codes, scale, full in ((kv8.k, kv8.k_scale, kv32.k),
                                   (kv8.v, kv8.v_scale, kv32.v)):
            codes.copy_(torch.randint(-127, 128, codes.shape, generator=gen,
                                      device=dev, dtype=torch.int8))
            scale.copy_(torch.rand(scale.shape, generator=gen, device=dev)
                        * 0.04 + 0.01)
            full.copy_(codes.to(torch.float32) * scale)
        for kv in (kv8, kv32):
            kv.positions.copy_(torch.arange(
                size, dtype=torch.int32, device=dev).expand_as(kv.positions))
    return c8, c32


def decode_long(torch, dev, cfg, params, counters, smi) -> dict:
    """One ``transformer.decode_step`` at position ``LM_LONG[1] - 1`` over
    full caches of ``LM_LONG[1]`` slots, int8 (B3 once a layer) and
    float32: the int8 step's launches counted, its logits held to the
    same step through B3's plain version (each on its own clone of the
    cache), and both steps profiled."""
    from repro_torch.core import ptq
    from repro_torch.kernels import int8_cache_attention as ca
    from repro_torch.models import transformer
    b, size = LM_LONG
    c8, c32 = long_caches(torch, dev, cfg, b, size)
    tok = torch.randint(0, cfg.vocab, (b, 1), generator=torch.Generator(
        ).manual_seed(SEED + 33)).to(dev)
    pos = torch.tensor(size - 1, device=dev)

    def clone(caches):
        return {"stacked": {k: {"kv": type(v["kv"])(*(
                    None if x is None else x.clone() for x in v["kv"]))}
                    for k, v in caches["stacked"].items()},
                "remainder": [{"kv": type(u["kv"])(*(
                    None if x is None else x.clone() for x in u["kv"]))}
                    for u in caches["remainder"]]}

    def nbytes(caches):
        return sum(x.numel() * x.element_size()
                   for v in list(caches["stacked"].values())
                   + caches["remainder"] for x in v["kv"] if x is not None)
    for c in counters.values():
        c.reset()
    logits, _ = transformer.decode_step(cfg, params, tok, clone(c8), pos)
    torch.cuda.synchronize()
    n = {k: c.value for k, c in counters.items()}
    want = {k: 0 for k in counters}
    want["int8_cache_attention"] = cfg.n_layers
    check(n == want, f"long decode step launches {n}, want {want}")
    real = ca.int8_cache_attention_cuda
    ca.int8_cache_attention_cuda = ca.int8_cache_attention_plain
    try:
        plain, _ = transformer.decode_step(cfg, params, tok, clone(c8), pos)
    finally:
        ca.int8_cache_attention_cuda = real
    diff = float((logits - plain).abs().max())
    check(tuple(logits.shape) == (b, 1, cfg.vocab)
          and bool(torch.isfinite(logits).all()) and diff <= LM_LONG_ATOL,
          f"long decode step: B3 vs its plain version, max abs diff {diff} "
          f"(tolerance {LM_LONG_ATOL})")
    row = dict(batch=b, slots=size, pos=size - 1, launches=n,
               logits_vs_plain_max_abs_diff=diff,
               logits_max_abs=float(plain.abs().max()),
               tolerance=LM_LONG_ATOL, params_gb=sum(
                   x.numel() * x.element_size()
                   for _, x in ptq.tree_tensors(params)) / 1e9,
               int8_cache_gb=nbytes(c8) / 1e9,
               fp32_cache_gb=nbytes(c32) / 1e9, card=smi)
    for label, caches in (("int8", c8), ("fp32", c32)):
        prof = profile_calls(torch, lambda caches=caches: transformer.
                             decode_step(cfg, params, tok, caches, pos),
                             n=5, match="int8_cache_attention")
        dev_ms, b3_ms = (prof["device_ms_per_call"],
                         prof["matched_device_ms_per_call"])
        row[label] = dict(
            host_ms=prof["host_ms_per_call"], device_ms=dev_ms,
            kernels_per_step=prof["kernels_per_call"], b3_device_ms=b3_ms,
            b3_share=b3_ms / dev_ms if dev_ms else None, top=prof["top"])
    print("lm decode_long " + json.dumps(row))
    del c8, c32
    torch.cuda.empty_cache()
    return row


def _spec_weights(spec) -> int:
    """Leaves of two dims or more in a spec tree: what PTQ quantizes."""
    if isinstance(spec, dict):
        return sum(_spec_weights(v) for v in spec.values())
    return int(len(spec.shape) >= 2)


def check(cond: bool, what: str) -> None:
    """Raise unless ``cond``."""
    if not cond:
        raise AssertionError(f"chip_smoke check failed: {what}")


def main() -> int:
    """Run every phase; 0 on success, 2 without a card or the repo."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    import torch.nn.functional as F

    from repro_torch.core import affine, ptq
    from repro_torch.kernels import (build, fake_quant, flash_attention,
                                     fused_qmlp, int8_cache_attention,
                                     int8_matmul)
    from repro_torch.rl import actorq, dqn, networks
    from repro_torch.rl import env as env_mod
    from repro_torch.rl.env import batched_env
    from repro_torch.rl.envs import make
    from repro_torch.serving import (PolicyServer, greedy_calib_obs,
                                     pad_rows, select_bucket)

    policies = quarl_atari()
    POLICY_II = policies.DEPLOY_POLICY_II.widths
    POLICY_III = policies.DEPLOY_POLICY_III.widths
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    dev = torch.device("cuda")
    networks.full_fp32()
    t0 = time.perf_counter()

    # ---- build ------------------------------------------------------------
    t_build = time.perf_counter()
    took = build.build()
    print(f"build: {time.perf_counter() - t_build:.2f}s wall "
          f"({', '.join(f'{k} {v:.2f}s' for k, v in took.items())})")
    for name, log in build.ptxas_log.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line:
                print(f"  ptxas {name}: {line.strip()}")

    gen = torch.Generator().manual_seed(SEED)
    env = make("airnav")
    obs_dim, n_act = env.spec.obs_shape[0], env.spec.n_actions

    def policy_params(widths, seed):
        spec = networks.mlp_spec(obs_dim, widths, n_act)
        return networks.init_mlp(spec, torch.Generator().manual_seed(seed),
                                 dev)

    # ---- kernel phase -----------------------------------------------------
    rows = []
    # B1 at the serving shapes (Policy II's layers, Policy III's widest,
    # a partial bucket), then at the shapes the sequence-actor rollout
    # and the CartPole cache calibration give it, recorded from one
    # rollout step and one calibration of each width
    b1_rows = [(label, m, k, n, bits) for bits in (8, 4)
               for label, (m, k, n) in (
                   ("serving", (512, obs_dim, 256)),
                   ("serving", (512, 256, 256)),
                   ("serving", (512, 256, n_act)),
                   ("Policy III", (512, 4096, 512)),
                   ("serving", (37, obs_dim, 256)))]
    seq_env = make("airnav_seq")
    seq_net = networks.make_network(seq_env.spec.obs_shape,
                                    seq_env.spec.n_actions,
                                    transformer=dict(SEQ_NET), device=dev)
    seq_p = seq_net.init(torch.Generator().manual_seed(SEED + 20))
    cp_params = networks.init_mlp(networks.mlp_spec(4, (64, 64), 2),
                                  torch.Generator().manual_seed(SEED + 7),
                                  dev)
    for bits, backend in ((8, "int8"), (4, "int4")):
        benv = actorq.maybe_attach_seq_state(
            batched_env(seq_env, ROLL_ENVS), seq_net, backend, ROLL_ENVS)
        pol = dqn.make_behaviour_policy(benv, seq_net, dqn.DQNConfig(
            actor_backend=backend))(seq_p, {}, torch.tensor(0, device=dev),
                                    torch.tensor(0, device=dev),
                                    qparams=actorq.pack_actor_params(
                                        seq_p, bits))
        rgen = torch.Generator(device=dev).manual_seed(SEED + 25)
        st0, ob0 = benv.reset(rgen)
        for m, k, n, b in b1_path_shapes(torch, dev, lambda: env_mod.rollout(
                benv, pol, seq_p, st0, ob0, rgen, 1)):
            b1_rows.append(("rollout", m, k, n, b))
        calib = (torch.randn((32, 4), generator=gen) * 0.5).to(dev)
        qp = actorq.pack_actor_params(cp_params, bits)
        for m, k, n, b in b1_path_shapes(torch, dev, lambda: actorq.
                                         calibrate_actor_cache(qp, calib)):
            b1_rows.append(("cartpole calibration", m, k, n, b))
        # the topology path: a rollout of 4 actors x 8 envs and the
        # per-actor divergence heads of a push
        progs, learner, wbuf, st0, ob0, snap = topology_programs(
            torch, dev, backend)
        tgen = torch.Generator(device=dev).manual_seed(SEED + 26)

        def topology_calls(progs=progs, snap=snap, learner=learner,
                           st0=st0, ob0=ob0, wbuf=wbuf, tgen=tgen):
            progs.actor_chunk(snap, st0, ob0, wbuf, tgen, n_chunks=1)
            progs.divergence(learner, snap, ob0)
        for m, k, n, b in b1_path_shapes(torch, dev, topology_calls):
            b1_rows.append(("topology", m, k, n, b))
    for label, m, k, n, bits in b1_rows:
        rows.append(b1_row(torch, dev, gen, label, m, k, n, bits))
    for bits in (8, 4):
        for pname, widths in (("II", POLICY_II), ("III", POLICY_III)):
            qp = actorq.pack_actor_params(
                policy_params(widths, SEED + 10), bits)
            _, calib = env.reset(gen, 64, dev)
            cache = actorq.calibrate_actor_cache(qp, calib)
            layers = actorq._fused_layers(cache, len(widths))
            for m in (8, 512):
                _, obs = env.reset(gen, m, dev)
                xq = affine.quantize_with_params(
                    obs, affine.AffineParams(layers[0].x_delta,
                                             layers[0].x_zero, 8))
                got = fused_qmlp.fused_qmlp_cuda(xq, layers)
                want = fused_qmlp.fused_qmlp_plain(xq, layers)
                torch.cuda.synchronize()
                same = torch.equal(got, want)
                err = float((got - want).abs().max())
                check(same, f"fused_qmlp bits={bits} Policy {pname} M={m} "
                            f"bitwise (max abs diff {err})")
                nbytes = m * obs_dim + 4 * m * n_act + sum(
                    la.codes.numel() + 12 * la.n + 8 for la in layers)
                ops = 2.0 * m * sum(la.k * la.n for la in layers)
                b_ms, b_by = bound(nbytes, ops)
                rows.append(dict(
                    name="fused_qmlp", bits=bits, policy=pname, shape=[m],
                    plan=fused_qmlp.plan(m, obs_dim, layers),
                    bitwise=same, max_abs_err=err,
                    ms=device_ms(torch, lambda: fused_qmlp.fused_qmlp_cuda(
                        xq, layers)),
                    plain_ms=device_ms(torch, lambda: fused_qmlp.
                                       fused_qmlp_plain(xq, layers)),
                    bound_ms=b_ms, bound_by=b_by, library_ms=None))
    # B2 at the training runs' shapes: the CartPole net 4-64-64-2,
    # calibrated on 32 observations, at the behaviour batch of the fused
    # topology and of one actor's divergence head (8 envs) and at the
    # topology runs' behaviour batch (4 actors x 8 envs)
    for bits, m in ((4, 8), (8, 8), (4, 32), (8, 32)):
        cache = actorq.calibrate_actor_cache(
            actorq.pack_actor_params(cp_params, bits),
            (torch.randn((32, 4), generator=gen) * 0.5).to(dev))
        layers = actorq._fused_layers(cache, 2)
        obs = (torch.randn((m, 4), generator=gen) * 0.5).to(dev)
        xq = affine.quantize_with_params(
            obs, affine.AffineParams(layers[0].x_delta, layers[0].x_zero, 8))
        got = fused_qmlp.fused_qmlp_cuda(xq, layers)
        want = fused_qmlp.fused_qmlp_plain(xq, layers)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        err = float((got - want).abs().max())
        check(same, f"fused_qmlp bits={bits} CartPole M={m} bitwise (max "
                    f"abs diff {err})")
        nbytes = m * 4 + 4 * m * 2 + sum(la.codes.numel() + 12 * la.n + 8
                                          for la in layers)
        b_ms, b_by = bound(nbytes, 2.0 * m * sum(la.k * la.n
                                                  for la in layers))
        rows.append(dict(
            name="fused_qmlp", bits=bits,
            policy="cartpole train" if m == 8 else "topology",
            shape=[m], plan=fused_qmlp.plan(m, 4, layers), bitwise=same,
            max_abs_err=err,
            ms=device_ms(torch, lambda: fused_qmlp.fused_qmlp_cuda(
                xq, layers)),
            plain_ms=device_ms(torch, lambda: fused_qmlp.fused_qmlp_plain(
                xq, layers)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None))
    rows += cache_rows(torch, dev, gen)
    rows += fake_quant_rows(torch, dev, gen)
    rows += site_rows(torch, dev, gen)
    t_flash = time.perf_counter()
    rows += flash_rows(torch, dev,
                       torch.Generator(device=dev).manual_seed(SEED + 31))
    flash_s = time.perf_counter() - t_flash
    for r in rows:
        print("kernel " + json.dumps(r))
    print(f"kernel phase: {len(rows)} rows (B1, B2, B5 and its site kernel "
          f"bitwise; B3, B4 "
          f"within 1e-5; B4 rows {flash_s:.1f}s), "
          f"{time.perf_counter() - t0:.1f}s so far")

    # ---- serve phase (the main path) --------------------------------------
    counters = (int8_matmul.launches, fused_qmlp.launches)
    for c in counters:
        c.reset()
    serve_rows = []

    def plain_actions(cache, obs_host):
        """The plain version's actions: the same cache on the CPU."""
        act = actorq.make_act_fn(env.spec)
        return act(ptq.tree_to(cache, "cpu"),
                   torch.from_numpy(obs_host)).numpy()

    profiled = {}
    for rnd, (backend, calib_batch) in enumerate(
            SERVE_RUNS + SERVE_RUNS[::-1]):
        params = policy_params(POLICY_II, SEED + 1)
        server = PolicyServer(env.spec, actor_backend=backend,
                              buckets=BUCKETS, calib_batch=calib_batch,
                              device="cuda")
        calib_obs = None
        if calib_batch:
            calib_obs = greedy_calib_obs(
                env, actorq.pack_actor_params(
                    params, actorq.backend_bits(backend)),
                calib_batch, SEED + 2)
        entry = server.push_params(params, calib_obs=calib_obs)
        check((actorq.ACT_QUANT in entry.cache) == bool(calib_batch),
              f"{backend}: calibrated push selects the fused cache")
        server.warmup()
        mm0, fq0 = (c.value for c in counters)
        d0 = server.stats()["dispatches"]
        benv = batched_env(env, SESSIONS)
        state, obs = benv.reset(torch.Generator().manual_seed(SEED), dev)
        # only the serving steps are timed (submit to the last answer):
        # not the server's start and stop, the hot-swap push, the replay
        # of the plain version or the clients' env step
        latencies, step_s, n_answered, swap_version = [], [], 0, None
        with server:
            sids = [server.open_session() for _ in range(SESSIONS)]
            for step in range(STEPS):
                if step == SWAP_AT:
                    swap_version = server.push_params(
                        policy_params(POLICY_II, SEED + 3)).version
                    check(swap_version == entry.version + 1,
                          f"{backend}: hot-swap moves the version")
                o_host = obs.cpu().numpy()
                t_step = time.perf_counter()
                reqs = [server.submit(sid, o_host[i])
                        for i, sid in enumerate(sids)]
                results = [r.result(timeout=120) for r in reqs]
                step_s.append(time.perf_counter() - t_step)
                n_answered += sum(r.action is not None for r in results)
                latencies += [r.latency_s for r in results]
                versions = {r.version for r in results}
                check(versions == {swap_version if step >= SWAP_AT
                                   else entry.version},
                      f"{backend}: step {step} served by versions "
                      f"{versions}")
                actions = np.stack([r.action for r in results])
                if step == 0 and backend != "fp32":
                    # replay each dispatch as the server padded it: the
                    # uncalibrated path quantizes every dispatched batch
                    # with that batch's own range
                    groups = {}
                    for i, r in enumerate(results):
                        groups.setdefault(r.step, []).append(i)
                    for idx in groups.values():
                        batch = pad_rows(o_host[idx],
                                         select_bucket(len(idx), BUCKETS))
                        want = plain_actions(entry.cache, batch)[:len(idx)]
                        check(np.array_equal(actions[idx], want),
                              f"{backend}: a dispatch of {len(idx)} served "
                              f"actions equals the plain version's bitwise")
                state, obs, _, _ = benv.step(
                    state, torch.from_numpy(actions).to(dev))
            for sid in sids:
                server.close_session(sid)
        stats = server.stats()
        dispatches = stats["dispatches"] - d0
        d_mm = counters[0].value - mm0
        d_fq = counters[1].value - fq0
        check(n_answered == SESSIONS * STEPS,
              f"{backend}: {n_answered} of {SESSIONS * STEPS} answered")
        check(stats["worker"]["dispatch_failures"] == 0,
              f"{backend}: dispatch failures {stats['last_error']}")
        if calib_batch:
            # one launch per dispatch; the hot-swap push recalibrates
            # through the per-layer path (one GEMM per hidden layer)
            check(d_fq == dispatches and d_mm == len(POLICY_II),
                  f"{backend}: fused launches {d_fq} for {dispatches} "
                  f"dispatches, int8_matmul launches {d_mm}")
        elif backend == "fp32":
            check(d_mm == 0 and d_fq == 0, "fp32: no quantized kernel")
        else:
            check(d_mm == (len(POLICY_II) + 1) * dispatches and d_fq == 0,
                  f"{backend}: int8_matmul launches {d_mm} for "
                  f"{dispatches} dispatches, fused launches {d_fq}")
        lat = np.asarray(latencies) * 1e3
        slow = 5 * float(np.median(step_s))
        row = dict(backend=backend, round=rnd // len(SERVE_RUNS),
                   calib_batch=calib_batch,
                   requests=n_answered, dispatches=dispatches,
                   int8_matmul_launches=d_mm, fused_qmlp_launches=d_fq,
                   served_s=sum(step_s),
                   actions_per_s=n_answered / sum(step_s),
                   step_p50_ms=float(np.percentile(step_s, 50)) * 1e3,
                   slow_steps=[[i, t * 1e3] for i, t in enumerate(step_s)
                               if t > slow],
                   p50_ms=float(np.percentile(lat, 50)),
                   p99_ms=float(np.percentile(lat, 99)),
                   versions=[entry.version, swap_version], card=smi)
        serve_rows.append(row)
        print("serve " + json.dumps(row))
        profiled[backend] = (server, o_host)
    # profiled after every timed run, so the profiler's hooks cannot slow
    # a run that follows
    for backend, (server, o_host) in profiled.items():
        prof = dict(backend=backend,
                    **profile_dispatch(torch, server, o_host))
        serve_rows.append(dict(profile=prof))
        print("profile " + json.dumps(prof))

    # Policy III: one calibrated int8 push, one bucket-512 batch
    params = policy_params(POLICY_III, SEED + 4)
    server = PolicyServer(env.spec, actor_backend="int8", buckets=(512,),
                          calib_batch=64, device="cuda")
    calib_obs = greedy_calib_obs(env, actorq.pack_actor_params(params, 8),
                                 64, SEED + 5)
    entry = server.push_params(params, calib_obs=calib_obs)
    check(actorq.ACT_QUANT in entry.cache, "Policy III: fused cache")
    mm0, fq0 = (c.value for c in counters)
    _, obs = env.reset(torch.Generator().manual_seed(SEED + 6), 512, dev)
    o_host = obs.cpu().numpy()
    sids = [server.open_session() for _ in range(512)]
    actions = np.stack(server.serve(list(zip(sids, o_host))))
    check(server.stats()["dispatches"] == 1, "Policy III: one dispatch")
    check(counters[1].value - fq0 == 1 and counters[0].value == mm0,
          "Policy III: one fused launch, no per-layer launch")
    check(np.array_equal(actions, plain_actions(entry.cache, o_host)),
          "Policy III: served actions equal the plain version's bitwise")
    print(f"serve Policy III int8 calibrated: 512 actions bitwise, "
          f"cache {entry.nbytes} bytes")
    launches = {c.name: c.value for c in counters}
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched on the serving path")

    # ---- rollout phase (the sequence-actor path) --------------------------
    seq_env = make("airnav_seq")
    spec = seq_env.spec
    net = networks.make_network(spec.obs_shape, spec.n_actions,
                                transformer=dict(SEQ_NET), device=dev)
    seq_params = net.init(torch.Generator().manual_seed(SEED + 20))
    context, n_layers = net.seq_cfg.context, net.seq_cfg.n_layers
    roll_counters = (int8_matmul.launches, fused_qmlp.launches,
                     int8_cache_attention.launches)
    for c in roll_counters:
        c.reset()
    roll_rows, roll_profiled = [], {}
    for rnd, backend in enumerate(ROLL_RUNS + ROLL_RUNS[::-1]):
        quantized = actorq.is_quantized(backend)
        cfg = dqn.DQNConfig(actor_backend=backend)
        qp = actorq.pack_actor_params(
            seq_params, actorq.backend_bits(backend)) if quantized else None
        benv = actorq.maybe_attach_seq_state(
            batched_env(seq_env, ROLL_ENVS), net, backend, ROLL_ENVS)
        # epsilon at eps_end: the updates count is past the decay
        pol = dqn.make_behaviour_policy(benv, net, cfg)(
            seq_params, {}, torch.tensor(0, device=dev),
            torch.tensor(cfg.eps_decay_updates, device=dev), qparams=qp)
        gen = torch.Generator(device=dev).manual_seed(SEED + 21)
        state, obs = benv.reset(gen)
        before = [c.value for c in roll_counters]
        saved, card_q = {}, {}
        bad_reset = torch.zeros((), dtype=torch.int64, device=dev)
        n_done = torch.zeros_like(bad_reset)
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(ROLL_STEPS + 1)]
        torch.cuda.synchronize()
        t_roll = time.perf_counter()
        events[0].record()
        for step in range(ROLL_STEPS):
            if quantized and step in SAMPLE_STEPS:
                # device copies only: the replay runs after the timed loop
                saved[step] = (ptq.tree_map(torch.clone, state[1]),
                               obs.clone())
            state, obs, traj = env_mod.rollout(benv, pol, seq_params, state,
                                               obs, gen, 1)
            done = traj.done[0] > 0
            n_done += done.sum()
            if quantized:
                bad_reset += (done & (state[1]["count"] != 0)).sum()
                if step in SAMPLE_STEPS:
                    card_q[step] = traj.logits_or_value[0]
            events[step + 1].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_roll
        d_mm, d_fq, d_ca = (c.value - b for c, b in zip(roll_counters,
                                                          before))
        if quantized:
            check(d_ca == n_layers * ROLL_STEPS and d_fq == 0
                  and d_mm == DENSE_PER_STEP * ROLL_STEPS,
                  f"{backend} rollout: int8_cache_attention launches {d_ca} "
                  f"(want {n_layers * ROLL_STEPS}), int8_matmul {d_mm} "
                  f"(want {DENSE_PER_STEP * ROLL_STEPS}), fused_qmlp {d_fq}")
            check(int(bad_reset) == 0,
                  f"{backend} rollout: {int(bad_reset)} finished envs kept "
                  f"a nonzero cache count")
        else:
            check(d_ca == d_mm == d_fq == 0,
                  "fp32 rollout: no quantized kernel")
        check(int(n_done) >= ROLL_ENVS,
              f"{backend} rollout: {int(n_done)} episodes ended in "
              f"{ROLL_STEPS} steps (every env times out at 120)")
        check(bool(torch.isfinite(traj.logits_or_value).all()),
              f"{backend} rollout: finite Q-values")
        replays = []
        if quantized:
            qp_cpu = ptq.tree_to(qp, "cpu")
            for step in SAMPLE_STEPS:
                ps, ob = saved[step]
                want, _ = actorq.quantized_seq_step(
                    qp_cpu, ob[:, -1, :].cpu(), ptq.tree_to(ps, "cpu"),
                    context=context)
                got = card_q[step].cpu()
                diff = (got - want).abs().amax(-1)
                top2 = want.topk(2, dim=-1).values
                must = (top2[:, 0] - top2[:, 1]) > torch.clamp(
                    2 * diff, min=REPLAY_ATOL)
                agree = got.argmax(-1) == want.argmax(-1)
                over = diff > REPLAY_ATOL
                check(float(diff.max()) <= FLIP_ATOL and bool(agree[must]
                                                               .all()),
                      f"{backend} step {step}: card Q vs CPU replay max abs "
                      f"diff {float(diff.max())}, argmax equal on "
                      f"{int(agree[must].sum())} of {int(must.sum())} rows "
                      f"that must agree")
                replays.append(dict(
                    step=step, max_abs_diff=float(diff.max()),
                    rows_over_atol=int(over.sum()),
                    max_abs_diff_within_atol=float(
                        diff[~over].max()) if bool((~over).any()) else None,
                    argmax_equal_rows=int(agree.sum()),
                    rows_that_must_agree=int(must.sum())))
        step_ms = [events[i].elapsed_time(events[i + 1])
                   for i in range(ROLL_STEPS)]
        row = dict(backend=backend, round=rnd // len(ROLL_RUNS),
                   envs=ROLL_ENVS, steps=ROLL_STEPS, wall_s=wall,
                   env_steps_per_s=ROLL_ENVS * ROLL_STEPS / wall,
                   step_p50_ms=float(np.percentile(step_ms, 50)),
                   step_p99_ms=float(np.percentile(step_ms, 99)),
                   int8_matmul_per_step=d_mm / ROLL_STEPS,
                   int8_cache_attention_per_step=d_ca / ROLL_STEPS,
                   episodes_ended=int(n_done), replays=replays, card=smi)
        roll_rows.append(row)
        print("rollout " + json.dumps(row))
        roll_profiled[backend] = (benv, pol, state, obs, gen)
    roll_launches = {c.name: c.value for c in roll_counters}
    check(roll_launches["int8_cache_attention"] > 0
          and roll_launches["int8_matmul"] > 0,
          "the rollout path launched int8_cache_attention and int8_matmul")
    # profiled after every timed run, as the serve phase does
    for backend, (benv, pol, state, obs, gen) in roll_profiled.items():
        carry = [state, obs]

        def one_step(benv=benv, pol=pol, gen=gen, carry=carry):
            carry[0], carry[1], _ = env_mod.rollout(
                benv, pol, seq_params, carry[0], carry[1], gen, 1)
        prof = dict(backend=backend, **profile_calls(torch, one_step))
        roll_rows.append(dict(profile=prof))
        print("rollout profile " + json.dumps(prof))

    # ---- eval phase -------------------------------------------------------
    qp8 = actorq.pack_actor_params(seq_params, 8)
    t_eval = time.perf_counter()
    ret = float(env_mod.evaluate(
        seq_env, actorq.make_act_fn(spec), qp8,
        torch.Generator(device=dev).manual_seed(SEED + 22), ROLL_ENVS))
    eval_s = time.perf_counter() - t_eval
    check(np.isfinite(ret), f"evaluate: mean return {ret}")
    # windowed and cached int8 actors on one episode each: the
    # reference's contract (within 2e-2, equal argmax) was measured on
    # catch_seq and holds there; on airnav_seq the JAX package's own
    # actors differ by more (up to 0.077 on the CPU), so that episode is
    # measured and not held to it
    def windowed_vs_cached(env_name, seed, contract):
        env = make(env_name)
        enet = networks.make_network(env.spec.obs_shape, env.spec.n_actions,
                                     transformer=dict(SEQ_NET), device=dev)
        eqp = actorq.pack_actor_params(
            enet.init(torch.Generator().manual_seed(SEED + 20)), 8)
        egen = torch.Generator(device=dev).manual_seed(seed)
        state, obs = env.reset(egen, 1, dev)
        ps = actorq.seq_cache_zeros(enet.seq_cfg, 1, env.spec.max_steps + 1)
        worst, n_steps, same = 0.0, 0, 0
        for _ in range(env.spec.max_steps):
            q_w = actorq.quantized_seq_apply(eqp, obs)
            q_c, ps = actorq.quantized_seq_step(
                eqp, obs[:, -1], ps, context=enet.seq_cfg.context)
            diff = float((q_w - q_c).abs().max())
            agree = int(q_w.argmax()) == int(q_c.argmax())
            worst, same = max(worst, diff), same + agree
            check(not contract or (diff <= 2e-2 and agree),
                  f"{env_name} windowed vs cached at step {n_steps}: max abs "
                  f"diff {diff}, argmax agree {agree}")
            state, obs, _, done = env.step(state, q_c.argmax(-1), egen)
            n_steps += 1
            if bool(done.any()):
                break
        check(np.isfinite(worst), f"{env_name}: finite windowed vs cached")
        return dict(env=env_name, steps=n_steps, max_abs_diff=worst,
                    argmax_equal_steps=same, held_to_contract=contract)
    eval_row = dict(episodes=ROLL_ENVS, mean_return=ret, eval_s=eval_s,
                    windowed_vs_cached=[
                        windowed_vs_cached("catch_seq", SEED + 23, True),
                        windowed_vs_cached("airnav_seq", SEED + 24, False)],
                    card=smi)
    print("eval " + json.dumps(eval_row))

    # ---- train phase (the learner's path) ---------------------------------
    t_train = time.perf_counter()
    train = train_phase(torch, dev, smi, {
        c.name: c for c in (int8_matmul.launches, fused_qmlp.launches,
                            int8_cache_attention.launches,
                            fake_quant.launches)})
    print(f"train phase: {time.perf_counter() - t_train:.1f}s")

    # ---- topology phase (the actor-learner and async topologies) ---------
    t_topo = time.perf_counter()
    topo = topology_phase(torch, dev, smi, {
        c.name: c for c in (int8_matmul.launches, fused_qmlp.launches,
                            int8_cache_attention.launches,
                            fake_quant.launches)})
    print(f"topology phase: {time.perf_counter() - t_topo:.1f}s")

    # ---- algo phase (DDPG, PPO and A2C) -----------------------------------
    t_algo = time.perf_counter()
    algo = algo_phase(torch, dev, smi, {
        c.name: c for c in (int8_matmul.launches, fused_qmlp.launches,
                            int8_cache_attention.launches,
                            fake_quant.launches)}, POLICY_II)
    rows += algo["shape_rows"]
    print(f"algo phase: {time.perf_counter() - t_algo:.1f}s")

    # ---- seq_train phase (the sequence actor in training) ----------------
    t_seq = time.perf_counter()
    seq = seq_train_phase(torch, dev, smi, {
        c.name: c for c in (int8_matmul.launches, fused_qmlp.launches,
                            int8_cache_attention.launches,
                            fake_quant.launches)})
    rows += seq["shape_rows"]
    print(f"seq_train phase: {time.perf_counter() - t_seq:.1f}s")

    # ---- resume phase (checkpoints and bitwise resume) --------------------
    t_resume = time.perf_counter()
    resume = resume_phase(torch, dev, smi)
    print(f"resume phase: {time.perf_counter() - t_resume:.1f}s")

    # ---- resilience phase (the self-healing runtime) ----------------------
    t_rz = time.perf_counter()
    rz = resilience_phase(torch, dev, smi, {
        c.name: c for c in (int8_matmul.launches, fused_qmlp.launches)})
    print(f"resilience phase: {time.perf_counter() - t_rz:.1f}s")

    # ---- serve_rl phase (launch.serve --rl-env) ---------------------------
    t_srl = time.perf_counter()
    serve_rl = serve_rl_phase(torch, dev, smi, {
        c.name: c for c in (int8_matmul.launches, fused_qmlp.launches)})
    print(f"serve_rl phase: {time.perf_counter() - t_srl:.1f}s")

    # ---- conv phase (the paper's Atari conv actor on pixel Catch) --------
    t_conv = time.perf_counter()
    conv = conv_phase(torch, dev, smi, {
        c.name: c for c in (int8_matmul.launches, fused_qmlp.launches,
                            int8_cache_attention.launches,
                            fake_quant.launches)})
    rows += conv["b1"]
    print(f"conv phase: {time.perf_counter() - t_conv:.1f}s")

    # ---- LM phase (prefill and greedy decode) -----------------------------
    t_lm = time.perf_counter()
    lm = lm_phase(torch, dev, smi, {
        c.name: c for c in (int8_matmul.launches, fused_qmlp.launches,
                            int8_cache_attention.launches,
                            fake_quant.launches, flash_attention.launches)})
    print(f"lm phase: {time.perf_counter() - t_lm:.1f}s")

    # ---- report -----------------------------------------------------------
    def head(name, **want):
        """The kernel-phase row that stands for ``name`` in the report."""
        return next(r for r in rows if r["name"] == name and all(
            r.get(k) == v for k, v in want.items()))

    report = []
    for name, src, replaces, n, pick in (
            ("int8_matmul", "src/repro_torch/kernels/csrc/int8_matmul.cu",
             "src/repro/kernels/int8_matmul.py:76", launches["int8_matmul"],
             head("int8_matmul", bits=8, shape=[512, 256, 256])),
            ("fused_qmlp", "src/repro_torch/kernels/csrc/fused_qmlp.cu",
             "src/repro/kernels/fused_qmlp.py:115", launches["fused_qmlp"],
             head("fused_qmlp", bits=4, policy="II", shape=[512])),
            ("int8_cache_attention",
             "src/repro_torch/kernels/csrc/int8_cache_attention.cu",
             "src/repro/kernels/int8_cache_attention.py:70",
             roll_launches["int8_cache_attention"],
             head("int8_cache_attention", label="airnav_seq",
                  pos="ragged")),
            ("fake_quant", "src/repro_torch/kernels/csrc/fake_quant.cu",
             "src/repro/kernels/fake_quant.py:36",
             train["qat_launches"]["fake_quant"],
             head("fake_quant", label="site td fc/out")),
            ("flash_attention",
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:91",
             lm["prefill"]["launches"]["flash_attention"],
             head("flash_attention", label="danube prefill"))):
        report.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=n,
            max_abs_err=max(r["max_abs_err"] for r in rows
                            if r["name"] == name),
            ms=pick["ms"], plain_ms=pick["plain_ms"],
            bound_ms=pick["bound_ms"], bound_by=pick["bound_by"],
            library_ms=pick["library_ms"]))
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        dict(card=smi, kernel_rows=rows, serve_rows=serve_rows,
             rollout_rows=roll_rows, eval_row=eval_row,
             train_rows=train["rows"], topology_rows=topo["rows"],
             algo_rows=dict(runs=algo["rows"],
                            shapes=algo["shape_rows"],
                            seconds=algo["seconds"]),
             conv_rows=dict(forward=conv["forward"],
                            rollout=conv["rollout"], train=conv["train"],
                            seconds=conv["seconds"]),
             seq_train_rows=dict(runs=seq["rows"],
                                 shapes=seq["shape_rows"],
                                 seconds=seq["seconds"]),
             resume_rows=resume["rows"],
             resilience_rows=rz["rows"], serve_rl_rows=serve_rl["rows"],
             lm_rows=lm,
             path_launches=dict(serve=launches, rollout=roll_launches,
                                train_qat=train["qat_launches"],
                                topology_async_int8=topo["launches"],
                                algo=algo["launches"],
                                seq_train_fused=seq["bar_launches"],
                                seq_train_qat8_int8=seq["qat_launches"],
                                resilience_chaos=rz["launches"],
                                serve_rl=serve_rl["launches"],
                                lm_prefill=lm["prefill"]["launches"]),
             kernels=report, seconds=time.perf_counter() - t0), indent=1))
    print(f"total {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
