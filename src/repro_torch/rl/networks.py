"""MLP policy network of the port (the deployment MLPs of paper Table 5).

Counterpart of ``repro/rl/networks.py:74-91``.  Params are nested dicts
in the reference's naming and layout -- ``{"fc0": {"w": (K, N), "b":
(N,)}, ..., "out": {...}}`` with ``y = x @ w + b`` -- so ``core.ptq``
packs them exactly as the reference packs its pytree, and
``params_from_jax`` carries a JAX param tree across unchanged.
``MLP`` is the same forward as an ``nn.Module``.

The fp32 actor runs in full float32: ``full_fp32()`` turns TF32 off for
matmuls and convolutions (JAX on the CPU computes full fp32, and the
port's fp32 path is compared against it).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device

Params = Dict[str, Dict[str, torch.Tensor]]


def full_fp32() -> None:
    """Turn TF32 off for float32 matmuls and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def mlp_spec(obs_dim: int, widths: Sequence[int], out_dim: int,
             out_scale: float = 0.01) -> Dict[str, Tuple[Tuple[int, int],
                                                         float]]:
    """``{layer: ((K, N), init scale)}``: fan-in ``1/sqrt(K)`` for hidden
    layers, ``out_scale`` for the head (the reference's init)."""
    spec, d = {}, obs_dim
    for i, w in enumerate(widths):
        spec[f"fc{i}"] = ((d, w), 1.0 / math.sqrt(d))
        d = w
    spec["out"] = ((d, out_dim), out_scale)
    return spec


def init_mlp(spec: Dict[str, Tuple[Tuple[int, int], float]],
             generator: torch.Generator, device=None) -> Params:
    """Random params from ``spec``: normal weights times the layer's
    scale, zero biases.  Draws on the CPU ``generator`` (so one seed gives
    the same params on every device), then moves to ``device`` (``None``
    is ``cuda``)."""
    device = resolve_device(device)
    params = {}
    for name, ((k, n), scale) in spec.items():
        w = torch.randn((k, n), generator=generator) * scale
        params[name] = {"w": w.to(device),
                        "b": torch.zeros(n, device=device)}
    return params


def n_hidden(params: Any) -> int:
    """Number of hidden layers (``fc*`` entries) of an MLP param tree."""
    return sum(1 for name in params if name.startswith("fc"))


def mlp_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Head outputs of the fp32 MLP; ``x`` has any leading batch dims."""
    for i in range(n_hidden(params)):
        layer = params[f"fc{i}"]
        x = torch.relu(x @ layer["w"] + layer["b"])
    return x @ params["out"]["w"] + params["out"]["b"]


class MLP(nn.Module):
    """The fp32 MLP policy as a module over a param dict (JAX layout)."""

    def __init__(self, params: Params):
        super().__init__()
        full_fp32()
        self.layer_names = [f"fc{i}" for i in range(n_hidden(params))] \
            + ["out"]
        self.weights = nn.ParameterDict()
        for name in self.layer_names:
            self.weights[f"{name}_w"] = nn.Parameter(params[name]["w"])
            self.weights[f"{name}_b"] = nn.Parameter(params[name]["b"])

    def params(self) -> Params:
        """The module's tensors as a param dict (shared storage)."""
        return {name: {"w": self.weights[f"{name}_w"],
                       "b": self.weights[f"{name}_b"]}
                for name in self.layer_names}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Head outputs for observations ``x``."""
        return mlp_apply(self.params(), x)


def params_from_jax(tree: Any, device=None) -> Params:
    """The port's params from a JAX MLP param tree.

    ``tree`` is nested dicts of arrays (numpy, or anything ``np.asarray``
    takes), as ``repro.rl.networks`` lays them out; the result keeps the
    names and the ``(K, N)`` layout, in float32 on ``device`` (``None`` is
    ``cuda``).
    """
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)
