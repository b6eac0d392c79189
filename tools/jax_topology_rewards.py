"""The JAX package's eval rewards at the configs of ``chip_smoke.py``'s
topology runs, on the CPU: the reference each run's reward bar rests on.

Runs ``repro.rl.loops.train("dqn", "cartpole", ...)`` once for each of
``chip_smoke.TOPO_RUNS`` (4 actors, ``TOPO_ITERS`` iterations,
``TOPO_RECORD`` between evaluations, seed ``SEED``) and prints one JSON
object a run: the recorded rewards, their max, the last push's per-actor
divergence, the distinct actor lags and the wall time.  Where the max
clears 100, ``chip_smoke.TOPO_BAR`` holds the port's run to 100:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/jax_topology_rewards.py

About a minute on a CPU.
"""
from __future__ import annotations

import importlib.util
import json
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    """Run every topology config and print its row; 0 on success."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro.rl import loops
    for name, kw in cs.TOPO_RUNS:
        t = time.perf_counter()
        res = loops.train("dqn", "cartpole", iterations=cs.TOPO_ITERS,
                          record_every=cs.TOPO_RECORD, seed=cs.SEED,
                          num_actors=cs.TOPO_ACTORS, **kw)
        print(json.dumps(dict(
            run=name, rewards=res.rewards, max_reward=max(res.rewards),
            divergence_last=res.divergences[-1],
            actor_lags=sorted(set(res.actor_lags)),
            wall_s=time.perf_counter() - t)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
