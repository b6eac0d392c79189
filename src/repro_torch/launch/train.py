"""Training launcher of the port: the ``--mode rl`` path.

Counterpart of ``repro/launch/train.py:26-101``, with the same flags and
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

Not ported yet, and raising ``NotImplementedError`` naming the ROADMAP
queue A item: ``--mode lm`` (item 13), the checkpoint flags (item 9),
``--fault-plan`` and ``--supervised`` (item 11).
"""
from __future__ import annotations

import argparse
import sys


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
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fault-plan", default=None, metavar="SEED:SPEC")
    ap.add_argument("--supervised", action="store_true")
    args = ap.parse_args(argv)
    if args.mode == "lm":
        raise NotImplementedError("--mode lm is not ported yet (ROADMAP "
                                  "queue A, item 13)")
    if args.ckpt_dir or args.ckpt_every or args.resume:
        raise NotImplementedError("checkpointing is not ported yet "
                                  "(ROADMAP queue A, item 9)")
    if args.fault_plan is not None or args.supervised:
        raise NotImplementedError("the resilience supervisor is not ported "
                                  "yet (ROADMAP queue A, item 11)")
    return run_rl(args)


def run_rl(args) -> int:
    """Train with ``loops.train`` and print the eval rewards."""
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.rl import loops
    quant = QuantConfig.parse(args.quant)
    res = loops.train(args.algo, args.env, iterations=args.iterations,
                      quant=quant, seed=args.seed,
                      record_every=max(args.iterations // 10, 1),
                      actor_backend=args.actor_backend, device=args.device)
    print(f"[train/rl] {args.algo} on {args.env} quant={quant.label()} "
          f"actor={args.actor_backend} device={res.device}: eval rewards "
          f"{['%.1f' % r for r in res.rewards]} ({res.wall_time_s:.0f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
