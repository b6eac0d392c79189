"""Compare the embedding gradient of an index lookup with ``F.embedding``'s.

``models/transformer.py: _embed`` looks up the token embeddings with
``F.embedding`` (one op whose backward DTensor splits by vocab) where it
once indexed the table (``w[tokens]``).  The two backwards sum a
repeated token's rows in different orders, so on the card their
gradients can round differently.  This script draws h2o-danube-1.8b's
table (32,000 x 2,560) and a 2 x 2,048 batch of tokens from a seed, and
prints, for bfloat16 and float32, whether the two gradients are bitwise
equal and their largest difference, then the card's name and power
limit.

    python3 tools/embed_grad_order.py
"""
from __future__ import annotations

import subprocess

import torch
import torch.nn.functional as F


def main() -> int:
    if not torch.cuda.is_available():
        print("embed_grad_order: needs the card")
        return 2
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        w = torch.randn(32000, 2560, device="cuda", generator=gen).to(
            dtype).requires_grad_(True)
        tokens = torch.randint(0, 32000, (2, 2048), device="cuda",
                               generator=gen)
        up = torch.randn(2, 2048, 2560, device="cuda", generator=gen).to(
            dtype)
        by_index, = torch.autograd.grad(w[tokens], w, up)
        by_embedding, = torch.autograd.grad(F.embedding(tokens, w), w, up)
        diff = (by_index.float() - by_embedding.float()).abs().max().item()
        print(f"{dtype}: bitwise {torch.equal(by_index, by_embedding)}, "
              f"max abs diff {diff}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
