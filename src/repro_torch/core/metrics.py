"""Analysis metrics of the paper's studies (the subset the QuaRL
pipelines report).

Counterpart of ``repro/core/metrics.py:22-71``: the width of the weight
distribution and the mean int8 quantization error of the weights (Fig.
3/4: a wider distribution predicts a larger PTQ error), the paper's
relative reward error E_%, the variance of the action distribution
(Fig. 1's exploration proxy) and the EMA that smooths its curves.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core import affine
from repro_torch.core.ptq import tree_tensors


def weight_distribution_stats(params: Any) -> Dict[str, float]:
    """Width statistics of all float weights (2-D and up), concatenated
    in the reference's leaf order, computed on the host in numpy."""
    leaves = [t.detach().cpu().numpy().ravel()
              for _, t in tree_tensors(params)
              if t.dim() >= 2 and t.is_floating_point()]
    if not leaves:
        return {"range": 0.0, "std": 0.0, "min": 0.0, "max": 0.0,
                "p999": 0.0}
    w = np.concatenate(leaves)
    return {
        "range": float(w.max() - w.min()),
        "std": float(w.std()),
        "min": float(w.min()),
        "max": float(w.max()),
        "p999": float(np.quantile(np.abs(w), 0.999)),
    }


def mean_int8_weight_error(params: Any, bits: int = 8) -> float:
    """Mean over the float weights (2-D and up) of each one's mean
    absolute affine-quantization error at ``bits`` (Fig. 3)."""
    errs = [float(torch.mean(torch.abs(t - affine.ptq_tensor(t, bits))))
            for _, t in tree_tensors(params)
            if t.dim() >= 2 and t.is_floating_point()]
    return float(np.mean(errs)) if errs else 0.0


def relative_error(fp32_reward: float, quant_reward: float) -> float:
    """The paper's E_%: positive means the quantized policy is worse."""
    denom = abs(fp32_reward) if fp32_reward != 0 else 1.0
    return 100.0 * (fp32_reward - quant_reward) / denom


def action_distribution_variance(logits: torch.Tensor) -> torch.Tensor:
    """Mean over rows of the variance of ``softmax(logits)`` (Fig. 1: a
    flatter distribution, more exploration, has a lower variance)."""
    return torch.var(torch.softmax(logits, dim=-1), dim=-1,
                     correction=0).mean()


def ema(values, decay: float = 0.95):
    """The running exponential average of ``values`` (the paper smooths
    its action-variance curves with 0.95)."""
    out, acc = [], None
    for v in values:
        acc = v if acc is None else decay * acc + (1 - decay) * v
        out.append(acc)
    return out
