"""Where a port kernel's time goes, by ablation, on one card.

Builds variants of ``csrc/flash_attention.cu`` (B4),
``csrc/fused_qmlp.cu`` (B2) and ``csrc/int8_cache_attention.cu`` (B3),
each with one part of the work taken out (the variants compute wrong
results and are never checked), and times each against the unchanged
kernel, in turns, at the main-path rows: B4 at the danube prefill (8,192
x 8,192, 32 / 8 heads, D 80, window 4,096), B2 on Policy II
(9-256-256-256-25) and the CartPole net (4-64-64-2), int8, M 8, B3 at
``chip_smoke.CACHE_ROWS``' airnav_seq (ragged), long and danube decode
rows.  B3's unchanged kernel is also timed at other key splits than its
plan's (``splits=N`` in the variant's name).  A part whose removal moves
the time is on the critical path.

    python3 tools/kernel_ablation.py [--only int8_cache_attention]

Prints one JSON object a variant and round, and the card's name and
power limit.  Needs ``nvcc`` and a card.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# (kernel, variant): (old, new) substitutions in the kernel's source
VARIANTS = {
    "flash_attention": {
        "unchanged": [],
        "no expf in the softmax": [
            ("const float p = expf(sacc[4 * j + e] - m_use[ri]);",
             "const float p = sacc[4 * j + e] - m_use[ri];"),
            ("alpha[ri] = expf(m[ri] - m_use[ri]);",
             "alpha[ri] = m[ri] - m_use[ri];")],
        "no S products": [
            ("wgmma_ss_n32(st, das, db, kk > 0);", ""),
            ("wgmma_ss_n32(st, dab, ds, 1);", ""),
            ("wgmma_ss_n32(st, dab, db, 1);", "")],
        "no P.V products": [
            ("wgmma_rs<NW>(ot, ps[j], db, j > 0);", ""),
            ("wgmma_rs<NW>(ot, pb[j], ds, 1);", ""),
            ("wgmma_rs<NW>(ot, pb[j], db, 1);", "")],
        "no producer loads": [
            ("if (d < D) x = *reinterpret_cast<const float4*>(src);", ""),
            ("s.v[i][m] = (t < T && d < D) ? vb[t * kv_row + d] : 0.0f;",
             "s.v[i][m] = 0.0f;")],
        "no producer stores": [
            ("      *reinterpret_cast<uint4*>(kbig + o) = big;\n"
             "      *reinterpret_cast<uint4*>(ksml + o) = sml;", ""),
            ("      *reinterpret_cast<uint4*>(vbig + o) = big;\n"
             "      *reinterpret_cast<uint4*>(vsml + o) = sml;", "")],
    },
    "int8_cache_attention": {
        "unchanged": [],
        "no code copies": [
            ("for (int i = tid; i < nt * npc; i += THREADS) {",
             "for (int i = tid; i < 0; i += THREADS) {")],
        "no q.k products": [
            ("for (int w = qj; w < W; w += LANES) {",
             "for (int w = qj; w < 0; w += LANES) {")],
        "no softmax expf": [
            ("const float e = expf(w_s[t * GM + g] - mx);",
             "const float e = w_s[t * GM + g] - mx;")],
        "no p.v products": [
            ("for (int t = sg; t < nt; t += nsub) {",
             "for (int t = sg; t < 0; t += nsub) {")],
        "no merge sums": [
            ("for (int u = j; u < S; u += tpc) {",
             "for (int u = j; u < 0; u += tpc) {")],
        "no scale copies": [
            ("for (int i = tid; i < 2 * nt; i += THREADS) {",
             "for (int i = tid; i < 0; i += THREADS) {")],
        "8 stages": [("constexpr int STAGES = 4;",
                      "constexpr int STAGES = 8;")],
        "64-slot tiles": [("constexpr int TS = 128;",
                           "constexpr int TS = 64;"),
                          ("constexpr int LANES = 2;",
                           "constexpr int LANES = 4;")],
        "mul and add products": [
            ("            dot[g] = __fmaf_rn(qv.x, kf[0], dot[g]);\n"
             "            dot[g] = __fmaf_rn(qv.y, kf[1], dot[g]);\n"
             "            dot[g] = __fmaf_rn(qv.z, kf[2], dot[g]);\n"
             "            dot[g] = __fmaf_rn(qv.w, kf[3], dot[g]);",
             "            float part = mul(qv.x, kf[0]);\n"
             "            part = add(part, mul(qv.y, kf[1]));\n"
             "            part = add(part, mul(qv.z, kf[2]));\n"
             "            part = add(part, mul(qv.w, kf[3]));\n"
             "            dot[g] = add(dot[g], part);"),
            ("              acc[g][e] = __fmaf_rn(wt[g], vf[e], acc[g][e]);",
             "              acc[g][e] = add(acc[g][e], mul(wt[g], vf[e]));")],
        "small path: return at the start": [
            ("  const int r = blockIdx.x, G = a.G, Dh = a.Dh;\n",
             "  const int r = blockIdx.x, G = a.G, Dh = a.Dh;\n"
             "  if (a.vec > 0) return;\n")],
        "return at the start": [
            ("  const int tid = threadIdx.x;\n",
             "  const int tid = threadIdx.x;\n  if (a.vec > 0) return;\n")],
        "index math only": [
            ("for (int i = tid; i < nt * npc; i += THREADS) {",
             "for (int i = tid; i < 0; i += THREADS) {"),
            ("for (int w = qj; w < W; w += LANES) {",
             "for (int w = qj; w < 0; w += LANES) {"),
            ("for (int t = sg; t < nt; t += nsub) {",
             "for (int t = sg; t < 0; t += nsub) {")],
    },
    "fused_qmlp": {
        "unchanged": [],
        "no mma": [("    mma_s8(p.c, a, b0, b1);",
                    "    p.c[0] += b0 ^ a[0];\n    p.c[1] += b1 ^ a[1];")],
        "no requant division": [
            ("rintf(__fdiv_rn(fmaxf(y, 0.0f), nxd))",
             "rintf(__fmul_rn(fmaxf(y, 0.0f), nxd))")],
        "no K-major transpose": [
            ("        km.load(u, r);\n        km.store(u, r);",
             "        (void)r;")],
        "no copies of the codes": [
            ("for (int i = 16 * tid; i < head; i += 16 * THREADS)",
             "for (int i = 16 * tid; i < 0; i += 16 * THREADS)")],
    },
}


def main() -> int:
    """Build, time and print every variant; 2 without a card."""
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=tuple(VARIANTS))
    only = ap.parse_args().only
    import torch
    if not torch.cuda.is_available():
        print("kernel_ablation: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import affine
    from repro_torch.kernels import build, flash_attention, fused_qmlp
    from repro_torch.kernels import int8_cache_attention as ca
    from repro_torch.rl import actorq, networks
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, variants in VARIANTS.items():
        if only not in (None, name):
            continue
        src = (build.CSRC / build.SOURCES[name]).read_text()
        for i, (label, subs) in enumerate(variants.items()):
            text = src
            for old, new in subs:
                if old not in text:
                    raise RuntimeError(f"{name} / {label}: {old[:60]!r} is "
                                       f"not in the source")
                text = text.replace(old, new)
            cu = build.BUILD_DIR / f"ablation_{name}_{i}.cu"
            cu.write_text(text)
            so = cu.with_suffix(".so")
            procs[(name, label)] = (subprocess.Popen(
                [build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                so)
    libs = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{key}: nvcc exited {proc.returncode}\n{log}")
        libs[key] = so

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 31)
    q = torch.randn((1, 8192, 32, 80), generator=gen, device=dev)
    k = torch.randn((1, 8192, 8, 80), generator=gen, device=dev) * 1.5
    v = torch.randn((1, 8192, 8, 80), generator=gen, device=dev)
    nets = []
    for net, k0, widths, n_out in (
            ("II", 9, cs.quarl_atari().DEPLOY_POLICY_II.widths, 25),
            ("cartpole", 4, (64, 64), 2)):
        g = torch.Generator().manual_seed(cs.SEED + 10)
        params = networks.init_mlp(networks.mlp_spec(k0, widths, n_out), g,
                                   dev)
        layers = actorq._fused_layers(actorq.calibrate_actor_cache(
            actorq.pack_actor_params(params, 8),
            (torch.randn(64, k0, generator=g) * 0.5).to(dev)), len(widths))
        xq = affine.quantize_with_params(
            (torch.randn(8, k0, generator=g) * 0.5).to(dev),
            affine.AffineParams(layers[0].x_delta, layers[0].x_zero, 8))
        nets.append((net, layers, xq))

    cache_gen = torch.Generator().manual_seed(cs.SEED + 35)
    cache = [(row, cs.cache_inputs(torch, dev, cache_gen, *row[1:6],
                                   *row[7:]))
             for row in cs.CACHE_ROWS if (row[0], row[7]) in (
                 ("airnav_seq", "ragged"), ("long", "last"),
                 ("danube decode", "last"))]
    plan = ca.plan

    def use(mod, so):
        real = build.load
        mod._lib.cache_clear()
        build.load = lambda _name: ctypes.CDLL(str(so))
        try:
            mod._lib()
        finally:
            build.load = real

    order = list(libs)
    if ("int8_cache_attention", "unchanged") in libs:
        order += [("int8_cache_attention", f"splits={n}")
                  for n in (1, 4, 8, 16, 32)]
    for rnd, keys in enumerate((order, order[::-1])):
        for name, label in keys:
            if name == "int8_cache_attention":
                forced = label.startswith("splits=")
                use(ca, libs[(name, "unchanged" if forced else label)])
                for row, x in cache:
                    label_row, nb, nh, g, t, dh, window = row[:7]
                    r, n_max = nb * nh, min(t, window or t)
                    if forced:
                        n = min(int(label[7:]), -(-n_max // ca.TILE))
                        per = -(-(-(-n_max // n)) // ca.TILE) * ca.TILE
                        p = dict(plan(r, g, t, dh, window),
                                 splits=-(-n_max // per), per=per)
                        p["scratch"] = (4 * r * p["splits"] * g
                                        * (2 + 4 * -(-dh // 4)))
                        ca.plan = lambda *_a, p=p: p
                    try:
                        ms = cs.device_ms(torch, lambda: ca.
                                          int8_cache_attention_cuda(
                                              *x, window))
                    finally:
                        ca.plan = plan
                    print(json.dumps(dict(
                        round=rnd, kernel=name, variant=label,
                        row=label_row, splits=(p if forced else plan(
                            r, g, t, dh, window))["splits"], ms=ms)))
            elif name == "flash_attention":
                use(flash_attention, libs[(name, label)])
                ms = cs.device_ms(torch, lambda: flash_attention.
                                  flash_attention_cuda(q, k, v, window=4096),
                                  reps=5, per_rep=2)
                print(json.dumps(dict(round=rnd, kernel=name, variant=label,
                                      row="danube prefill", ms=ms)))
            else:
                use(fused_qmlp, libs[(name, label)])
                for net, layers, xq in nets:
                    ms = cs.device_ms(torch, lambda: fused_qmlp.
                                      fused_qmlp_cuda(xq, layers))
                    print(json.dumps(dict(round=rnd, kernel=name,
                                          variant=label, net=net, m=8,
                                          ms=ms)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
