"""Serving launcher of the port: the LM mode (batched greedy decoding).

Counterpart of ``repro/launch/serve.py``'s LM mode (``:190-324``), with
its flags: a seeded model of ``--arch`` (``--reduced`` for the smoke-test
variant), optionally PTQ-simulated weights (``--quant ptq_int8``, every
weight through kernel B5 on the card) and an int8 KV cache
(``--int8-cache``, decode attention through kernel B3), then a
teacher-forced pass over a random prompt and greedy decoding, one token
at a time through ``transformer.decode_step``:

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch h2o-danube-1.8b --batch 4 --prompt-len 32 --new-tokens 32 \\
        --quant ptq_int8 --int8-cache

It runs on the card unless ``--device cpu`` is given, and prints the
decode rate with the device's name.  The ``--rl-env`` mode (policy
serving) is not ported yet and raises ``NotImplementedError`` naming
ROADMAP queue A, item 10.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time


def main(argv=None) -> int:
    """Parse ``argv``, decode, and print; 0 on success."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="h2o-danube-1.8b",
                    help="transformer architecture to decode")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="decoding batch size")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--quant", default="none",
                    help="none | ptq_fp16 | ptq_int8 (weights)")
    ap.add_argument("--int8-cache", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rl-env", default=None,
                    help="serve an RL policy instead of an LM (not ported)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.rl_env:
        raise NotImplementedError("--rl-env (policy serving through the "
                                  "launcher) is not ported yet (ROADMAP "
                                  "queue A, item 10)")

    import torch

    from repro_torch.configs import base as cfgs
    from repro_torch.core import ptq
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer

    device = resolve_device(args.device)
    cfg = cfgs.get_reduced(args.arch) if args.reduced else cfgs.get(args.arch)
    quant = QuantConfig.parse(args.quant)
    if args.int8_cache:
        cfg = dataclasses.replace(
            cfg, quant=dataclasses.replace(cfg.quant, int8_kv_cache=True))

    params = transformer.init_params(
        cfg, torch.Generator().manual_seed(args.seed), device)
    fp32_bytes = ptq.tree_nbytes(params)
    if quant.is_ptq:
        params = ptq.ptq_simulate(params, quant)    # simulated int math
    print(f"[serve] {cfg.name} quant={quant.label()} "
          f"int8_cache={cfg.quant.int8_kv_cache} "
          f"params={fp32_bytes / 1e6:.1f}MB fp32"
          + (f" -> {fp32_bytes / 4 / 1e6:.1f}MB int8 packed"
             if quant.mode.value == "ptq_int" else ""))

    total_len = args.prompt_len + args.new_tokens
    caches = transformer.init_caches(cfg, args.batch, total_len,
                                     device=device)
    tokens = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=torch.Generator().manual_seed(
                               args.seed)).to(device)

    # prompt token by token (teacher forcing), then greedy decode; the
    # positions live on the device, so no step waits on a host copy
    positions = torch.arange(total_len, device=device)
    with torch.no_grad():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out_tokens = []
        tok = tokens[:, :1]
        for pos in range(total_len - 1):
            logits, caches = transformer.decode_step(cfg, params, tok,
                                                     caches, positions[pos])
            nxt = torch.argmax(logits[:, -1], -1)
            tok = tokens[:, pos + 1:pos + 2] if pos + 1 < args.prompt_len \
                else nxt[:, None]
            if pos + 1 >= args.prompt_len:
                out_tokens.append(nxt)
        first = [int(t[0]) for t in out_tokens]          # syncs the card
        dt = time.perf_counter() - t0
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    n_gen = args.batch * len(out_tokens)
    print(f"[serve] generated {len(out_tokens)} tokens x {args.batch} seqs "
          f"in {dt:.4f}s ({n_gen / dt:.1f} tok/s on {name})")
    print("        first sequence:", first[:16])
    return 0


if __name__ == "__main__":
    sys.exit(main())
