"""Time the actor mesh at world 1 on one card, with nothing else running.

Runs ``chip_smoke.mesh_world1`` (each of its runs once untimed on a
world-1 NCCL mesh, held bitwise to the run without one, then timed in
turns: no mesh, mesh, mesh, no mesh) ``--repeat`` times in this one
process, after building the kernels.  In ``chip_smoke.py`` the same runs
share the card and the host with six worker processes; here they run
alone, so the mesh's wall time an update over the no-mesh run's can be
set beside the host time it spends in collectives and in packing them
(``collective_host_ms_per_update``, ``pack_host_ms_per_update``).

    python3 tools/mesh_times.py --repeat 2

Prints chip_smoke's ``mesh`` row for each run and repeat, then the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeat", type=int, default=2)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import (build, fake_quant, fused_qmlp,
                                     int8_cache_attention, int8_matmul)
    from repro_torch.rl import networks
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    networks.full_fp32()
    build.build()
    counters = {c.name: c for c in (int8_matmul.launches,
                                    fused_qmlp.launches,
                                    int8_cache_attention.launches,
                                    fake_quant.launches)}
    for r in range(args.repeat):
        print(f"repeat {r}", flush=True)
        chip_smoke.mesh_world1(torch, torch.device("cuda"), smi, counters)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
