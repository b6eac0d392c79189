"""The JAX package's eval rewards at the configs of ``chip_smoke.py``'s
conv training runs, on the CPU: what a reward bar on them may rest on.

Runs ``repro.rl.loops.train("dqn", "catch", ...)`` at Policy A width
(``ATARI_DQN``: 3 conv x 128, FC 128) once for each of
``chip_smoke.CONV_TRAIN_RUNS`` (``CONV_TRAIN_ITERS`` iterations,
``CONV_TRAIN_RECORD`` between evaluations, ``steps_per_call``
``TRAIN_SPC``, seed ``SEED``; the QAT run's delay ``QAT_DELAY``) and
prints one JSON object a run: the recorded rewards, their max and the
wall time.  ``--runs`` picks some of them by name:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/jax_catch_rewards.py

A few minutes a run on a CPU.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    """Run the chosen conv training configs and print a row each."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--runs", nargs="*",
                    default=[name for name, _ in cs.CONV_TRAIN_RUNS])
    args = ap.parse_args(argv)
    from repro.configs.quarl_atari import ATARI_DQN
    from repro.core.qconfig import QuantConfig
    from repro.rl import loops
    net = dict(conv_filters=ATARI_DQN.conv_filters,
               fc_width=ATARI_DQN.fc_width)
    for name, kw in cs.CONV_TRAIN_RUNS:
        if name not in args.runs:
            continue
        if name == "qat8":
            kw = dict(kw, quant=QuantConfig.qat(8, quant_delay=cs.QAT_DELAY))
        t = time.perf_counter()
        res = loops.train("dqn", "catch", iterations=cs.CONV_TRAIN_ITERS,
                          record_every=cs.CONV_TRAIN_RECORD,
                          steps_per_call=cs.TRAIN_SPC, seed=cs.SEED,
                          net_kwargs=net, **kw)
        print(json.dumps(dict(run=name, rewards=res.rewards,
                              max_reward=max(res.rewards),
                              wall_s=time.perf_counter() - t)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
