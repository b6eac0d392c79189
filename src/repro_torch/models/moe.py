"""Mixture-of-Experts feed-forward (mixtral-8x7b: 8 experts, top-2).

Counterpart of ``repro/models/moe.py``: GShard capacity dispatch, so
every shape is fixed by the token count alone:

  router logits (float32, optionally fake-quantized)
  -> top-k expert choice, the gates renormalised over the chosen experts
  -> each token's position in its expert by a cumsum; tokens past
     ``capacity`` are dropped
  -> dispatch einsum to (experts, capacity, d) slots
  -> each expert's SwiGLU FFN (expert weights stacked on a leading axis)
  -> combine einsum back with the gates.

The load-balance loss ``E * sum_e f_e * p_e`` (``f_e`` the share of
tokens whose first choice is ``e``, ``p_e`` the mean router probability)
is returned beside the output.  Tokens go in groups of ``min(512, B*S)``;
``B*S`` must be a whole number of groups, as the reference asserts (the
port raises, and never pads).  The reference computes all of this
outside any Pallas kernel, so the einsums are plain torch here too.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.models.common import P, dense_spec


def moe_spec(d_model: int, d_ff: int, n_experts: int) -> Dict[str, Any]:
    """The router and the stacked expert weights ``wi``, ``wg``, ``wo``."""
    return {
        "router": dense_spec(d_model, n_experts, "embed", None),
        "wi": {"w": P((n_experts, d_model, d_ff),
                      axes=("expert", "embed", "moe_mlp"))},
        "wg": {"w": P((n_experts, d_model, d_ff),
                      axes=("expert", "embed", "moe_mlp"))},
        "wo": {"w": P((n_experts, d_ff, d_model),
                      axes=("expert", "moe_mlp", "embed"))},
    }


def top_k_experts(probs: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values over the last axis and their indices, in
    descending order, equal values taken lower index first as
    ``jax.lax.top_k`` does (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(ctx, params, x: torch.Tensor, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25, group_size: int = 512,
            activation: str = "silu", quantize_router: bool = False,
            name: str = "moe") -> Tuple[torch.Tensor, torch.Tensor]:
    """``x (B, S, D)`` -> ``(out (B, S, D), aux)``, ``aux`` a float32
    scalar."""
    b, s, d = x.shape
    tokens = b * s
    group_size = min(group_size, tokens)
    if tokens % group_size:
        raise ValueError(f"moe_ffn: {tokens} tokens are not a whole number "
                         f"of groups of {group_size}")
    n_groups = tokens // group_size
    capacity = max(int(capacity_factor * top_k * group_size / n_experts),
                   top_k)
    # on DTensors, the reference's layout (repro/models/moe.py:60-62,
    # 89, 118, 125): groups follow the batch over "data", the experts'
    # hidden dim over "model"
    x = common.with_constraint(x, ("data", None, None))
    xg = common.with_constraint(common.reshape(x, n_groups, group_size, d),
                                ("data", None, None))

    rw = params["router"]["w"]
    if quantize_router:
        rw = ctx.weight(f"{name}/router", rw)
    logits = torch.einsum("gsd,de->gse", xg.to(torch.float32),
                          rw.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)                      # (g, s, e)
    gate_vals, expert_idx = top_k_experts(probs, top_k)        # (g, s, k)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    # one-hot (g, s, k, e); each token's position in its expert's queue
    onehot = F.one_hot(expert_idx, n_experts).to(torch.float32)
    pos_in_expert = torch.cumsum(
        onehot.reshape(n_groups, group_size * top_k, n_experts), dim=1
    ).reshape(n_groups, group_size, top_k, n_experts) - 1.0
    keep = (pos_in_expert < capacity).to(torch.float32) * onehot
    pos = torch.sum(pos_in_expert * keep, dim=-1)              # (g, s, k)
    pos_oh = F.one_hot(pos.to(torch.int64), capacity).to(torch.float32)
    combine = torch.einsum("gsk,gske,gskc->gsec", gate_vals, keep, pos_oh)
    combine = common.with_constraint(combine, ("data", None, None, None))
    dispatch = (combine > 0.0).to(x.dtype)                     # (g,s,e,c)

    # load-balance loss over the first choices
    frac = torch.mean(torch.sum(onehot[:, :, 0, :], dim=1) / group_size,
                      dim=0)
    mean_prob = torch.mean(probs, dim=(0, 1))
    aux = n_experts * torch.sum(frac * mean_prob)

    xe = torch.einsum("gsec,gsd->egcd", dispatch, xg)          # (e,g,c,d)
    wi = ctx.weight(f"{name}/wi", params["wi"]["w"]).to(x.dtype)
    wg = ctx.weight(f"{name}/wg", params["wg"]["w"]).to(x.dtype)
    wo = ctx.weight(f"{name}/wo", params["wo"]["w"]).to(x.dtype)
    h = torch.einsum("egcd,edf->egcf", xe, wi)
    gate = torch.einsum("egcd,edf->egcf", xe, wg)
    act = F.silu(gate) if activation == "silu" \
        else F.gelu(gate, approximate="tanh")
    h = ctx.activation(f"{name}/h", h * act)
    h = common.with_constraint(h, (None, "data", None, "model"))
    ye = torch.einsum("egcf,efd->egcd", h, wo)                 # (e,g,c,d)
    # on DTensors a capacity the mesh does not divide stays whole: the
    # combine's strategy would split it unevenly, which no view takes
    ye = common.even_only(ye, whole=2)
    combine = common.even_only(combine, whole=3)
    y = torch.einsum("gsec,egcd->gsd", combine.to(x.dtype), ye)
    y = common.with_constraint(y, ("data", None, None))
    return common.reshape(y, b, s, d), aux.to(torch.float32)
