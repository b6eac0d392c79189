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

Not ported yet, and raising ``NotImplementedError`` naming the ROADMAP
queue A item: ``--mode lm`` (item 13).
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
        raise NotImplementedError("--mode lm is not ported yet (ROADMAP "
                                  "queue A, item 13)")
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


if __name__ == "__main__":
    sys.exit(main())
