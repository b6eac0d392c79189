#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one H100.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each kernel against its plain PyTorch version on the card (bitwise)
at the serving shapes and times both, then drives the port's serving path
-- ``PolicyServer`` answering batched AirNav sessions through the ActorQ
int8 / int4 policy -- and checks that every request is answered, that the
hot-swap moves the version, that the served actions equal the plain
version's, and that the path really launched the kernels.  Any failed
check raises.  The last line of standard output is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

and the line before it is a JSON object listing every ported kernel with
its launches on the serving path, its largest difference from the plain
version and its times.  All rows are also written to
``chiprun_out/chip_smoke.json``.  Without CUDA, or outside the repository,
it exits with code 2 and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, int8 ops/s
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

POLICY_II = (256, 256, 256)       # paper Table 5 deployment MLPs
POLICY_III = (4096, 512, 1024)
BUCKETS = (8, 32, 128, 512)
SESSIONS, STEPS, SWAP_AT = 512, 200, 100
# each backend is served twice, in this order and then reversed, so that
# no backend always runs first or last on a host shared with others
SERVE_RUNS = (("int8", 0), ("int4", 64), ("fp32", 0))
SEED = 0


def bound(nbytes: float, ops: float):
    """Least time (ms) the card could take, and what sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def device_ms(torch, fn, reps: int = 25, per_rep: int = 10) -> float:
    """Median device time of one call of ``fn`` (ms), by CUDA events.

    Each rep first parks the stream on a sleep kernel so the host can
    enqueue ``per_rep`` calls back to back; the events then time the
    calls' device work, not the host's launch cost.
    """
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(per_rep):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_rep)
    return statistics.median(times)


def profile_dispatch(torch, server, obs_host, n: int = 20) -> dict:
    """Where one dispatch's time goes, from ``torch.profiler``.

    Runs ``n`` dispatches of ``obs_host`` through the server's act path
    and returns the host wall time per dispatch, the device time per
    dispatch (kernels summed), the device's busy share of the wall time,
    kernels launched per dispatch, and the five kernels that took most
    device time.  Device numbers are ``None`` when the trace holds no
    device events.
    """
    from torch.profiler import ProfilerActivity, profile
    cache = server.current.cache
    server._act(cache, obs_host)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            server._act(cache, obs_host)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / n
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return dict(
        bucket=int(obs_host.shape[0]), host_ms_per_dispatch=wall_ms,
        device_ms_per_dispatch=dev_ms if kernels else None,
        device_busy_share=dev_ms / wall_ms if kernels else None,
        kernels_per_dispatch=sum(e.count for e in kernels) / n,
        top=[[e.key[:60], e.self_device_time_total / 1e3 / n]
             for e in top])


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

    from repro_torch.core import affine, ptq
    from repro_torch.kernels import build, fused_qmlp, int8_matmul
    from repro_torch.rl import actorq, networks
    from repro_torch.rl.env import batched_env
    from repro_torch.rl.envs import make
    from repro_torch.serving import (PolicyServer, greedy_calib_obs,
                                     pad_rows, select_bucket)

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
    b1_shapes = [(512, obs_dim, 256), (512, 256, 256), (512, 256, 256),
                 (512, 256, n_act), (512, 4096, 512), (37, obs_dim, 256)]
    for bits in (8, 4):
        for m, k, n in b1_shapes:
            x = torch.randn((m, k), generator=gen).to(dev) * 1.5
            w = (torch.randn((k, n), generator=gen) / k ** 0.5).to(dev)
            xq, xp = affine.quantize_to_int(x, 8)
            pw = ptq._pack_leaf(w, bits)
            args = (xq, pw.codes, xp.delta, xp.zero_point, pw.col_scale,
                    pw.col_zero)
            got = int8_matmul.int8_matmul_cuda(*args, w_bits=bits)
            want = int8_matmul.int8_matmul_plain(*args, w_bits=bits)
            torch.cuda.synchronize()
            same = torch.equal(got, want)
            err = float((got - want).abs().max())
            check(same, f"int8_matmul bits={bits} {m}x{k}x{n} bitwise "
                        f"(max abs diff {err})")
            lib_ms = None
            if bits == 8 and m > 16 and k % 8 == 0 and n % 8 == 0:
                wq = pw.codes
                lib_ms = device_ms(torch, lambda: torch._int_mm(xq, wq))
            nbytes = m * k + pw.codes.numel() + 8 * n + 8 + 4 * m * n
            b_ms, b_by = bound(nbytes, 2.0 * m * k * n)
            rows.append(dict(
                name="int8_matmul", bits=bits, shape=[m, k, n],
                bitwise=same, max_abs_err=err,
                ms=device_ms(torch, lambda: int8_matmul.int8_matmul_cuda(
                    *args, w_bits=bits)),
                plain_ms=device_ms(torch, lambda: int8_matmul.
                                   int8_matmul_plain(*args, w_bits=bits)),
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
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
                    bitwise=same, max_abs_err=err,
                    ms=device_ms(torch, lambda: fused_qmlp.fused_qmlp_cuda(
                        xq, layers)),
                    plain_ms=device_ms(torch, lambda: fused_qmlp.
                                       fused_qmlp_plain(xq, layers)),
                    bound_ms=b_ms, bound_by=b_by, library_ms=None))
    for r in rows:
        print("kernel " + json.dumps(r))
    print(f"kernel phase: {len(rows)} rows bitwise, "
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

    # ---- report -----------------------------------------------------------
    def head(name, **want):
        """The kernel-phase row that stands for ``name`` in the report."""
        return next(r for r in rows if r["name"] == name and all(
            r.get(k) == v for k, v in want.items()))

    report = []
    for name, src, replaces, pick in (
            ("int8_matmul", "src/repro_torch/kernels/csrc/int8_matmul.cu",
             "src/repro/kernels/int8_matmul.py:76",
             head("int8_matmul", bits=8, shape=[512, 256, 256])),
            ("fused_qmlp", "src/repro_torch/kernels/csrc/fused_qmlp.cu",
             "src/repro/kernels/fused_qmlp.py:115",
             head("fused_qmlp", bits=4, policy="II", shape=[512]))):
        report.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in rows
                            if r["name"] == name),
            ms=pick["ms"], plain_ms=pick["plain_ms"],
            bound_ms=pick["bound_ms"], bound_by=pick["bound_by"],
            library_ms=pick["library_ms"]))
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        dict(card=smi, kernel_rows=rows, serve_rows=serve_rows,
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
