"""The pod dry-run: trace every (arch x input shape x mesh) step once on a
fake 256- or 512-rank mesh and record what one rank's step costs.

Counterpart of ``repro/launch/dryrun.py``.  Where the reference forces 512
host devices and lowers and compiles each step, the port starts a fake
process group of 256 or 512 ranks in this process
(``launch.mesh.init_fake_group``), builds the production mesh over it,
and traces the step on DTensor inputs whose local shards are
``FakeTensor``s (``launch.steps.lower_step``): nothing of the model's
size is allocated and no kernel launches.

    python -m repro_torch.launch.dryrun --arch xlstm-125m \\
        --shape decode_32k --device cpu

writes one JSON record a pair to ``--out`` (``artifacts/dryrun_torch/``
by default), with the reference's keys (``trace_s`` in place of
``lower_s`` / ``compile_s``), prints a line for each, lists the pairs
that failed and exits 1 if any did.  ``--device`` is where the fake
shards claim to lie: ``cuda`` (the default) on the card's machine, ``cpu``
elsewhere (DTensor will not take a fake CUDA tensor where torch has no
CUDA).  ``--depths 1,2,3`` (the default) traces one, two and three
repeats of each config's layer pattern and carries the counts to its
depth along the polynomial through them (each repeat runs the same ops
on the same shapes; the peak is carried along a line, an estimate);
``--depths all`` traces every layer (minutes a pair for the big train
steps).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

from repro_torch.configs import base as cfgs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")


def run_one(arch: str, shape_name: str, *, multi_pod: bool, out_dir: str,
            device: str = "cuda", depths=None) -> dict:
    """One pair on the current fake group's production mesh: its record,
    written to ``out_dir`` and printed."""
    cfg = cfgs.get(arch)
    shape = cfgs.INPUT_SHAPES[shape_name]
    cfg, variant = steps_lib.resolve_arch_for_shape(cfg, shape)
    mesh = mesh_lib.make_production_mesh(multi_pod, device=device)
    rec, kind = steps_lib.lower_step(cfg, shape, mesh, multi_pod=multi_pod,
                                     device=device, depths=depths)
    coll = rec["collective_breakdown"]
    record = {
        "arch": arch, "shape": shape_name, "kind": kind, "variant": variant,
        "multi_pod": multi_pod, "devices": mesh_lib.n_chips(multi_pod),
        "trace_s": round(rec["trace_s"], 1),
        "flops": rec["flops"], "kernel_flops": rec["kernel_flops"],
        "kernels": rec["kernels"],
        "bytes_accessed": rec["bytes_accessed"],
        "collective_bytes": coll["total"],
        "collective_breakdown": coll,
        "memory": rec["memory"],
        "n_params": cfg.n_params(),
        "n_active_params": cfg.n_active_params(),
        "tokens": shape.tokens if kind != "decode" else shape.global_batch,
        "depths": rec["depths"],
        "temp_carried": rec.get("temp_carried"),
    }
    print(f"[dryrun] {arch} x {shape_name} ({'2-pod' if multi_pod else '1-pod'}"
          f", {kind}, {variant}): trace {rec['trace_s']:.1f}s")
    print(f"  memory: {record['memory']}")
    print(f"  flops={record['flops']:.3e} bytes={record['bytes_accessed']:.3e}"
          f" collective_bytes={coll['total']:.3e} " + " ".join(
              f"{k}={v:.3e}" for k, v in coll.items() if k != "total"))
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{arch}__{shape_name}__{'2pod' if multi_pod else '1pod'}"
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(record, f, indent=1)
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all", help="arch name or 'all'")
    ap.add_argument("--shape", default="all",
                    help="input shape name or 'all'")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 (512-rank) mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--device", default="cuda",
                    help="where the fake shards lie: cuda or cpu")
    ap.add_argument("--depths", default="1,2,3",
                    help="pattern repeats to trace, their counts carried to "
                         "each config's depth; 'all': every layer")
    args = ap.parse_args(argv)
    import torch.distributed as dist

    archs = cfgs.names() if args.arch == "all" else [args.arch]
    shapes = list(cfgs.INPUT_SHAPES) if args.shape == "all" \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    depths = None if args.depths == "all" else \
        tuple(int(x) for x in args.depths.split(","))

    failures = []
    for mp in meshes:
        mesh_lib.init_fake_group(mesh_lib.n_chips(mp))
        try:
            for arch in archs:
                for shape in shapes:
                    try:
                        run_one(arch, shape, multi_pod=mp, out_dir=args.out,
                                device=args.device, depths=depths)
                    except Exception as e:  # noqa: BLE001 - report, go on
                        failures.append((arch, shape, mp, repr(e)))
                        print(f"[dryrun] FAIL {arch} x {shape} "
                              f"({'2pod' if mp else '1pod'}): {e}")
                        traceback.print_exc()
        finally:
            dist.destroy_process_group()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        return 1
    print("\nAll dry-runs traced successfully.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
