"""Training launcher of the port: ``--mode rl`` and ``--mode lm``.

Counterpart of ``repro/launch/train.py``, with the same flags and
``--actor-backend`` (the ActorQ actor: ``fp32``, ``int8`` or ``int4``).
Trains any of the four algorithms with the fused driver on the card
(``--device cpu`` runs the plain versions on the CPU) and prints the
recorded eval rewards.  The defaults, as the reference's, train PPO on
CartPole for 200 iterations:

    PYTHONPATH=src python -m repro_torch.launch.train
    PYTHONPATH=src python -m repro_torch.launch.train --algo ddpg \\
        --env pendulum --actor-backend int8
    PYTHONPATH=src python -m repro_torch.launch.train --mode rl \\
        --algo dqn --env cartpole --quant qat8:delay=200 --iterations 400

``--ckpt-dir DIR --ckpt-every N`` saves the run every ``N`` iterations
(the newest ``--ckpt-keep`` steps are kept), and ``--resume`` continues
from the newest one, bitwise the run that was not stopped:

    PYTHONPATH=src python -m repro_torch.launch.train --algo dqn \
        --env catch --iterations 40 --ckpt-dir /tmp/ckpt --ckpt-every 10

``--fault-plan SEED:SPEC`` (a ``repro_torch.resilience.FaultPlan``) or
``--supervised`` runs the training under the resilience supervisor
(retry from the newest valid checkpoint, ``--max-retries`` of them, then
``--rollback`` newest-checkpoint deletions, then abort with exit code 1)
and prints its report:

    PYTHONPATH=src python -m repro_torch.launch.train --algo dqn \
        --env cartpole --actor-backend int8 --fault-plan "5:nan_grad@4" \
        --ckpt-dir /tmp/ckpt --ckpt-every 2

``--mode lm`` trains a language model (``--arch``, ``--reduced`` for the
smoke-test variant, ``--steps``, ``--batch``, ``--seq``, ``--lr``) on the
synthetic token stream with the config's mixed precision, QAT and 8-bit
Adam, through ``launch.steps.make_train_step``; ``--ckpt-dir`` /
``--ckpt-every`` save the params and ``--resume`` warm-starts from the
newest ones (params only, as the reference's LM loop):

    PYTHONPATH=src python -m repro_torch.launch.train --mode lm \
        --arch h2o-danube-1.8b --reduced --steps 4 --device cpu

The params are drawn in the config's ``param_dtype`` (grok-1-314b:
bfloat16); the encoder and cross-attention configs (whisper-tiny,
llama-3.2-vision-90b) train on a zero ``encoder_out`` of ``(batch,
max(encoder_seq, 4), d_model)`` in the compute dtype, as the
reference's loop feeds them.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    """Parse ``argv`` and run; 0 on success."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", choices=("rl", "lm"), default="rl")
    ap.add_argument("--algo", default="ppo")
    ap.add_argument("--env", default="cartpole")
    ap.add_argument("--iterations", type=int, default=200)
    ap.add_argument("--quant", default="none")
    ap.add_argument("--actor-backend", default="fp32",
                    choices=("fp32", "int8", "int4"),
                    help="the rollout and eval actor (ActorQ)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized variant")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest valid checkpoint in "
                         "--ckpt-dir (bitwise the run that was not "
                         "stopped)")
    ap.add_argument("--ckpt-keep", type=int, default=3,
                    help="checkpoints kept in --ckpt-dir (<= 0: all)")
    ap.add_argument("--fault-plan", default=None, metavar="SEED:SPEC",
                    help="run under the resilience supervisor with this "
                         "deterministic fault plan, e.g. "
                         "'7:bitflip_push@4,straggler@6:delay_s=0.2'")
    ap.add_argument("--supervised", action="store_true",
                    help="run under the resilience supervisor without "
                         "injected faults (retry/rollback on real ones)")
    ap.add_argument("--max-retries", type=int, default=2,
                    help="supervisor resume-retries per rollback level")
    ap.add_argument("--rollback", type=int, default=1,
                    help="supervisor rollback-to-previous-checkpoint "
                         "escalations after retries exhaust")
    args = ap.parse_args(argv)
    if args.mode == "lm":
        return run_lm(args)
    return run_rl(args)


def run_rl(args) -> int:
    """Train with ``loops.train`` (under the supervisor with
    ``--fault-plan`` or ``--supervised``) and print the eval rewards; 1
    when the supervisor aborts."""
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.rl import loops
    quant = QuantConfig.parse(args.quant)
    kwargs = dict(algo=args.algo, env_name=args.env,
                  iterations=args.iterations, quant=quant, seed=args.seed,
                  record_every=max(args.iterations // 10, 1),
                  actor_backend=args.actor_backend,
                  checkpoint_dir=args.ckpt_dir,
                  checkpoint_every=args.ckpt_every, resume=args.resume,
                  checkpoint_keep=args.ckpt_keep, device=args.device)
    if args.fault_plan is not None or args.supervised:
        from repro_torch import resilience
        plan = (resilience.FaultPlan.parse(args.fault_plan)
                if args.fault_plan else None)
        sup_cfg = resilience.SupervisorConfig(
            max_retries=args.max_retries, max_rollbacks=args.rollback)
        try:
            res, report = resilience.supervise(kwargs, plan=plan,
                                               config=sup_cfg)
        except resilience.SupervisorAbort as e:
            print(f"[train/rl] {e.report.summary()}")
            return 1
        print(f"[train/rl] {report.summary()}")
    else:
        res = loops.train(**kwargs)
    print(f"[train/rl] {args.algo} on {args.env} quant={quant.label()} "
          f"actor={args.actor_backend} device={res.device}: eval rewards "
          f"{['%.1f' % r for r in res.rewards]} ({res.wall_time_s:.0f}s)")
    return 0


def run_lm(args) -> int:
    """Train the LM for ``--steps`` steps, printing the loss and the
    grad norm about ten times; 0 on success."""
    import torch

    from repro_torch import checkpoint as ckpt_lib
    from repro_torch.configs import base as cfgs
    from repro_torch.core.ptq import tree_tensors
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.device import resolve_device
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import transformer
    from repro_torch.optim import adam as adam_lib

    cfg = cfgs.get_reduced(args.arch) if args.reduced else cfgs.get(args.arch)
    dev = resolve_device(args.device)
    adam_cfg = adam_lib.AdamConfig(lr=args.lr, eightbit=cfg.optimizer_8bit)
    train_step, adam_cfg = steps_lib.make_train_step(cfg, adam_cfg)
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev,
        dtype=getattr(torch, cfg.mp.param_dtype))
    if args.resume and args.ckpt_dir:
        # params-only warm start, as the reference's LM loop
        last = ckpt_lib.latest_step(args.ckpt_dir)
        if last is not None:
            params = ckpt_lib.load_checkpoint(
                args.ckpt_dir, {"params": params}, step=last)["params"]
            print(f"[train/lm] resumed params from step {last}")
    opt = adam_lib.adam_init(params, adam_cfg)
    qat = (transformer.init_qat_collection(cfg, dev) if cfg.quant.is_qat
           else {})
    n_params = sum(x.numel() for _, x in tree_tensors(params))
    print(f"[train/lm] {cfg.name}: {n_params / 1e6:.1f}M params, "
          f"quant={cfg.quant.label()}, mp={cfg.mp.compute_dtype}, "
          f"8bit-adam={adam_cfg.eightbit}")

    data = SyntheticLMDataset(vocab=cfg.vocab, seq_len=args.seq,
                              batch=args.batch, seed=args.seed)
    t0 = time.time()
    for step, batch in enumerate(data.batches()):
        if step >= args.steps:
            break
        tbatch = {k: torch.from_numpy(v).long().to(dev)
                  for k, v in batch.items()}
        if cfg.cross_attn or cfg.encoder_layers:
            tbatch["encoder_out"] = torch.zeros(
                (args.batch, max(cfg.encoder_seq, 4), cfg.d_model),
                dtype=getattr(torch, cfg.mp.compute_dtype), device=dev)
        params, opt, qat, metrics = train_step(params, opt, tbatch, qat)
        if step % max(args.steps // 10, 1) == 0 or step == args.steps - 1:
            print(f"  step {step:5d}  loss {float(metrics['loss']):.4f}  "
                  f"grad_norm {float(metrics.get('grad_norm', 0)):.3f}  "
                  f"({time.time() - t0:.0f}s)")
        if args.ckpt_dir and args.ckpt_every and \
                (step + 1) % args.ckpt_every == 0:
            path = ckpt_lib.save_checkpoint(args.ckpt_dir,
                                            {"params": params}, step=step)
            print(f"  saved {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
