"""Analysis metrics of the paper's studies (the subset the QuaRL
pipelines report).

Counterpart of ``repro/core/metrics.py:22-53``: the width of the weight
distribution (Fig. 3/4: a wider distribution predicts a larger PTQ
error) and the paper's relative reward error E_%.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

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


def relative_error(fp32_reward: float, quant_reward: float) -> float:
    """The paper's E_%: positive means the quantized policy is worse."""
    denom = abs(fp32_reward) if fp32_reward != 0 else 1.0
    return 100.0 * (fp32_reward - quant_reward) / denom

