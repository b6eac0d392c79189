"""Time kernels B2 (``fused_qmlp``), B3 (``int8_cache_attention``) and B4
(``flash_attention``) of a checkout's PyTorch port on one card, and
profile the LM's decode step at a long context.

Times each kernel by CUDA events (``chip_smoke.device_ms``) at the shapes
``chip_smoke.py`` holds them at: B2 on the calibrated Policy II and III
nets (9 -> 25, seeded random weights) at M 8 and 512 and the CartPole net
4-64-64-2 at M 8, int8 and int4; B3 at ``chip_smoke.CACHE_ROWS`` (the
"lm" rows as strided views of the LM's cache where the checkout's B3
takes them, else as contiguous copies); B4 at ``chip_smoke.FLASH_ROWS``.
Each B2 result is checked bitwise and each B3 and B4 result within 1e-5
against the plain version first.  ``--only decode`` profiles one
full-size h2o-danube-1.8b ``decode_step`` at position 4095 over full
int8 and float32 caches of 4,096 slots (``chip_smoke.long_caches``,
params drawn on the card): host and device ms, kernels a step and B3's
device ms.  The port is imported from ``--src`` (default: this
checkout's ``src``), so two checkouts can be timed in turns, in one run
on the same card:

    python3 tools/kernel_times.py --src /path/to/parent/src --label parent
    python3 tools/kernel_times.py --label change

Prints one JSON object a row, with the SM clock, power draw and
temperature that ``nvidia-smi`` reads just after the row's timing (a card
near its power limit lowers its clock), and the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    """Time the rows; 2 without a card."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--only", choices=("fused_qmlp", "int8_cache_attention",
                                       "flash_attention", "decode"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core import affine
    from repro_torch.kernels import flash_attention, fused_qmlp
    from repro_torch.rl import actorq, networks

    cs = _chip_smoke()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()

    def emit(**row):
        sm = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True).stdout.strip().split(", ")
        print(json.dumps(dict(label=args.label, src=args.src, **row,
                              sm_mhz=sm[0], power_w=sm[1], temp_c=sm[2])))

    if args.only in (None, "fused_qmlp"):
        policies = cs.quarl_atari()
        for name, k0, widths, n_out in (
                ("II", 9, policies.DEPLOY_POLICY_II.widths, 25),
                ("III", 9, policies.DEPLOY_POLICY_III.widths, 25),
                ("cartpole", 4, (64, 64), 2)):
            for bits in (8, 4):
                gen = torch.Generator().manual_seed(cs.SEED + 10)
                params = networks.init_mlp(
                    networks.mlp_spec(k0, widths, n_out), gen, dev)
                calib = (torch.randn(64, k0, generator=gen) * 0.5).to(dev)
                layers = actorq._fused_layers(actorq.calibrate_actor_cache(
                    actorq.pack_actor_params(params, bits), calib),
                    len(widths))
                for m in ((8,) if name == "cartpole" else (8, 512)):
                    obs = (torch.randn(m, k0, generator=gen) * 0.5).to(dev)
                    xq = affine.quantize_with_params(obs, affine.AffineParams(
                        layers[0].x_delta, layers[0].x_zero, 8))
                    got = fused_qmlp.fused_qmlp_cuda(xq, layers)
                    want = fused_qmlp.fused_qmlp_plain(xq, layers)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(f"B2 {name} {bits} M={m}")
                    emit(kernel="fused_qmlp", net=name, bits=bits, m=m,
                         ms=cs.device_ms(torch, lambda: fused_qmlp.
                                         fused_qmlp_cuda(xq, layers)))
    if args.only in (None, "int8_cache_attention"):
        from repro_torch.kernels import int8_cache_attention as ca
        gen = torch.Generator().manual_seed(cs.SEED + 34)
        for label, nb, nh, g, t, dh, window, how, layout in cs.CACHE_ROWS:
            x = cs.cache_inputs(torch, dev, gen, nb, nh, g, t, dh, how,
                                layout)
            if layout == "lm" and not hasattr(ca, "plan"):
                # a B3 that takes contiguous (R, T, Dh) caches only
                x = tuple(a.reshape((nb * nh,) + a.shape[2:]).contiguous()
                          for a in x)
            got = ca.int8_cache_attention_cuda(*x, window)
            want = ca.int8_cache_attention_plain(*x, window)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
                raise AssertionError(f"B3 {label} {how}: {err}")
            emit(kernel="int8_cache_attention", row=label, pos=how,
                 layout=layout, max_abs_err=err,
                 ms=cs.device_ms(torch, lambda: ca.int8_cache_attention_cuda(
                     *x, window)))
            del x, got, want
    if args.only == "decode":
        decode_rows(torch, dev, cs, emit)
    if args.only in (None, "flash_attention"):
        gen = torch.Generator(device=dev).manual_seed(cs.SEED + 31)
        for label, b, h, kv, s, t, d, causal, window, softcap in \
                cs.FLASH_ROWS:
            q = torch.randn((b, s, h, d), generator=gen, device=dev)
            k = torch.randn((b, t, kv, d), generator=gen, device=dev) * 1.5
            v = torch.randn((b, t, kv, d), generator=gen, device=dev)
            kw = dict(causal=causal, window=window, softcap=softcap)
            got = flash_attention.flash_attention_cuda(q, k, v, **kw)
            want = flash_attention.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
                raise AssertionError(f"B4 {label}: {err}")
            del got, want
            reps = dict(reps=5, per_rep=2) if s * t > 2 ** 22 else {}
            emit(kernel="flash_attention", row=label, max_abs_err=err,
                 ms=cs.device_ms(torch, lambda: flash_attention.
                                 flash_attention_cuda(q, k, v, **kw),
                                 **reps))
            del q, k, v
            torch.cuda.empty_cache()
    print(smi)
    return 0


def card_params(torch, spec, gen, dev):
    """Params of a spec tree drawn on the card (``common.init_params``'s
    scales, the card's generator): a timing needs their sizes, not the
    CPU's draws, and drawing 1.8 B normals on the CPU takes seconds."""
    if isinstance(spec, dict):
        return {k: card_params(torch, spec[k], gen, dev) for k in sorted(spec)}
    if spec.init in ("zeros", "ones"):
        return (torch.zeros if spec.init == "zeros" else torch.ones)(
            spec.shape, device=dev)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    scale = 0.02 if spec.init == "embed" else (
        spec.scale if spec.scale is not None else fan_in ** -0.5)
    return torch.randn(spec.shape, generator=gen, device=dev) * scale


def decode_rows(torch, dev, cs, emit) -> None:
    """Profile a full-size danube decode step over full int8 and float32
    caches of ``cs.LM_LONG`` slots."""
    from repro_torch.configs import base as cfgs
    from repro_torch.models import transformer
    cfg = cfgs.get(cs.LM_ARCH)
    params = card_params(torch, transformer.param_specs(cfg),
                         torch.Generator(device=dev).manual_seed(cs.SEED),
                         dev)
    b, size = cs.LM_LONG
    c8, c32 = cs.long_caches(torch, dev, cfg, b, size)
    tok = torch.randint(0, cfg.vocab, (b, 1), generator=torch.Generator(
        ).manual_seed(cs.SEED + 33)).to(dev)
    pos = torch.tensor(size - 1, device=dev)
    for label, caches in (("int8", c8), ("fp32", c32)):
        prof = cs.profile_calls(torch, lambda caches=caches: transformer.
                                decode_step(cfg, params, tok, caches, pos),
                                n=5, match="int8_cache_attention")
        emit(kernel="decode_step", cache=label, batch=b, slots=size,
             host_ms=prof["host_ms_per_call"],
             device_ms=prof["device_ms_per_call"],
             kernels_per_step=prof["kernels_per_call"],
             b3_device_ms=prof["matched_device_ms_per_call"],
             top=prof["top"])


if __name__ == "__main__":
    sys.exit(main())
