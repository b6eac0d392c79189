"""Policy networks of the port: the paper's Atari conv backbone (3 conv +
FC, Appendix B; Policies A/B/C of Table 10), the deployment MLPs of
Table 5 and the decoder-transformer sequence policy.

Counterpart of ``repro/rl/networks.py``.  Params are nested dicts in the
reference's naming and layout -- ``{"fc0": {"w": (K, N), "b": (N,)}, ...,
"out": {...}}`` with ``y = x @ w + b``, ``{"conv{i}": {"w": (3, 3, C_in,
C_out) HWIO, "b": (C_out,)}, "fc": ..., "out": ...}`` for the conv net,
or the sequence policy's ``embed`` / ``blk{i}`` / ``head`` tree -- so
``core.ptq`` packs them exactly as the reference packs its pytree, and
``params_from_jax`` carries a JAX param tree across unchanged.
``make_network`` picks the network for an observation shape; ``MLP`` and
``SeqPolicy`` are the same forwards as ``nn.Module``s.

Every network is QAT-aware, as the reference's are: every dense layer
(the sequence policy's too, ``models.seq_policy``) sends its weight
through ``ctx.weight("<layer>/w", ...)``, every conv kernel is
fake-quantized per output channel (``core.fake_quant.fake_quant`` over
its own per-channel range, from the delay on), and every layer's output
goes through
``ctx.activation("<layer>/out", ...)`` of a ``core.fake_quant`` context.
Without one (``ctx=None``) it is the ``NullQATContext``, which passes
both through, so the fp32 forward is unchanged.

The conv net takes NHWC observations ``(..., H, W, C)``; each conv is a
stride-1 "SAME" 3x3 convolution (``F.conv2d``, cuDNN on the card, on
channels-last views of the NHWC activations), and the FC input is
flattened in ``(h, w, c)`` order, as the reference's reshape of NHWC.

The fp32 actor runs in full float32: ``full_fp32()`` turns TF32 off for
matmuls and convolutions (JAX on the CPU computes full fp32, and the
port's fp32 path is compared against it) and makes cuDNN pick
deterministic algorithms, so two runs on the card agree bit for bit.
"""
from __future__ import annotations

import math
from typing import (Any, Callable, Dict, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import fake_quant
from repro_torch.core.fake_quant import NullQATContext
from repro_torch.device import resolve_device
from repro_torch.models import common
from repro_torch.models.seq_policy import (SeqPolicyConfig, make_seq_policy,
                                           seq_apply)

Params = Dict[str, Dict[str, torch.Tensor]]


def full_fp32() -> None:
    """Turn TF32 off for float32 matmuls and cuDNN convolutions, and make
    cuDNN deterministic (no autotuning, no atomics in the backward)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


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


def dense(ctx, name: str, params: Dict[str, torch.Tensor], x: torch.Tensor,
          act: Optional[Callable] = None) -> torch.Tensor:
    """``act(x @ w + b)`` with the weight and the output sent through the
    QAT context's sites ``name/w`` and ``name/out``."""
    w = ctx.weight(f"{name}/w", params["w"])
    y = x @ w + params["b"]
    if act is not None:
        y = act(y)
    return ctx.activation(f"{name}/out", y)


def mlp_apply(params: Params, x: torch.Tensor, ctx=None) -> torch.Tensor:
    """Head outputs of the MLP; ``x`` has any leading batch dims.  ``ctx``
    is a ``core.fake_quant`` context (``None``: full precision)."""
    ctx = NullQATContext() if ctx is None else ctx
    for i in range(n_hidden(params)):
        x = dense(ctx, f"fc{i}", params[f"fc{i}"], x, act=torch.relu)
    return dense(ctx, "out", params["out"], x)


# ---------------------------------------------------------------------------
# Conv backbone (the paper's Atari policy: 3 conv + FC)
# ---------------------------------------------------------------------------

def conv2d(ctx, name: str, params: Dict[str, torch.Tensor], x: torch.Tensor,
           act: Optional[Callable] = torch.relu) -> torch.Tensor:
    """``act(conv(x, w) + b)``: a stride-1 "SAME" convolution of NHWC
    ``x`` by HWIO ``w`` (``F.conv2d`` on the channels-last NCHW view of
    ``x``, NHWC back; the reference's ``lax.conv_general_dilated``, whose
    ``stride`` no caller sets).  Under a QAT config the kernel is
    fake-quantized per output channel over its own range (extended to 0)
    where ``ctx.enabled``, as the reference's ``jnp.where(ctx.enabled,
    w_q, w)``; the output goes through the activation site
    ``name/out``."""
    w = params["w"]
    if ctx.config.is_qat:
        wmin = torch.clamp(w.amin(dim=(0, 1, 2)), max=0.0)
        wmax = torch.clamp(w.amax(dim=(0, 1, 2)), min=0.0)
        w_q = fake_quant.fake_quant(w, wmin, wmax, ctx.config.bits)
        w = torch.where(torch.as_tensor(ctx.enabled, device=w.device),
                        w_q, w)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 padding="same").permute(0, 2, 3, 1) + params["b"]
    if act is not None:
        y = act(y)
    return ctx.activation(f"{name}/out", y)


def conv_spec(k: int, c_in: int, c_out: int) -> Dict[str, common.P]:
    """A ``k x k`` conv layer's spec: HWIO kernel at fan-in scale ``1 /
    sqrt(k * k * c_in)``, zero bias."""
    return {"w": common.P((k, k, c_in, c_out),
                          scale=1.0 / math.sqrt(k * k * c_in)),
            "b": common.P((c_out,), init="zeros")}


def cnn_spec(obs_shape: Tuple[int, int, int], filters: Sequence[int],
             fc_width: int, out_dim: int) -> Dict[str, Dict[str, common.P]]:
    """The conv net's spec: ``conv{i}`` 3x3 layers of ``filters``, ``fc``
    of ``fc_width`` over the flattened ``H * W * filters[-1]`` (stride-1
    "SAME" convs keep H and W), and the head ``out`` at scale 0.01."""
    h, w, c_in = obs_shape
    spec = {}
    for i, f in enumerate(filters):
        spec[f"conv{i}"] = conv_spec(3, c_in, f)
        c_in = f
    flat = h * w * c_in
    spec["fc"] = {"w": common.P((flat, fc_width)),
                  "b": common.P((fc_width,), init="zeros")}
    spec["out"] = {"w": common.P((fc_width, out_dim), scale=0.01),
                   "b": common.P((out_dim,), init="zeros")}
    return spec


def n_convs(params: Any) -> int:
    """Number of conv layers (``conv*`` entries) of a param tree."""
    return sum(1 for name in params if name.startswith("conv"))


def cnn_apply(params: Params, x: torch.Tensor, ctx=None) -> torch.Tensor:
    """Head outputs of the conv net; ``x`` is NHWC with any leading batch
    dims.  ``ctx`` is a ``core.fake_quant`` context (``None``: full
    precision)."""
    ctx = NullQATContext() if ctx is None else ctx
    batch_shape = x.shape[:-3]
    x = x.reshape((-1,) + tuple(x.shape[-3:]))
    for i in range(n_convs(params)):
        x = conv2d(ctx, f"conv{i}", params[f"conv{i}"], x)
    x = x.reshape(x.shape[0], -1)
    x = dense(ctx, "fc", params["fc"], x, act=torch.relu)
    y = dense(ctx, "out", params["out"], x)
    return y.reshape(batch_shape + y.shape[-1:])


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


class SeqPolicy(nn.Module):
    """The fp32 sequence policy as a module over a param tree (JAX
    layout); ``forward`` is the windowed ``seq_apply``."""

    def __init__(self, params: Any, cfg: SeqPolicyConfig):
        super().__init__()
        full_fp32()
        self.cfg = cfg
        self.tree = _to_module_dict(params)

    def params(self) -> Any:
        """The module's tensors as a param tree (shared storage)."""
        return _from_module_dict(self.tree)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        """Head outputs on the newest row of ``obs (..., S, F)``."""
        return seq_apply(self.params(), obs, self.cfg)


def _to_module_dict(tree: Any) -> nn.Module:
    if isinstance(tree, dict):
        if all(isinstance(v, torch.Tensor) for v in tree.values()):
            return nn.ParameterDict({k: nn.Parameter(v)
                                     for k, v in tree.items()})
        return nn.ModuleDict({k: _to_module_dict(v)
                              for k, v in tree.items()})
    raise TypeError(f"param trees are nested dicts, got {type(tree)}")


def _from_module_dict(mod: nn.Module) -> Any:
    if isinstance(mod, nn.ParameterDict):
        return {k: mod[k] for k in mod.keys()}
    return {k: _from_module_dict(v) for k, v in mod.items()}


class Network(NamedTuple):
    """A network for one observation shape: ``init(generator)`` draws its
    params from a CPU generator (onto the network's device),
    ``apply(params, obs, ctx=None)`` gives the head outputs, ``ctx`` being
    the QAT context of the forward (``None``: full precision).
    ``seq_cfg`` is the
    ``SeqPolicyConfig`` of a sequence policy (``rl.actorq`` sizes the
    KV-cache actor state from it), else ``None``."""

    init: Callable[[torch.Generator], Any]
    apply: Callable[[Any, torch.Tensor], torch.Tensor]
    out_dim: int
    seq_cfg: Optional[SeqPolicyConfig] = None


def make_network(obs_shape: Tuple[int, ...], out_dim: int, *,
                 hidden: Sequence[int] = (64, 64),
                 conv_filters: Optional[Sequence[int]] = None,
                 fc_width: int = 128,
                 transformer: Optional[Dict[str, Any]] = None,
                 device=None) -> Network:
    """The network for an observation shape, as the reference picks it.

    ``transformer`` (a dict of ``models.seq_policy.make_seq_policy``
    keyword arguments, possibly empty) selects the decoder-transformer
    sequence policy for frame-stacked ``(context, feat)`` observations;
    pixel ``(H, W, C)`` observations get the conv net (``conv_filters``,
    default ``(16, 16, 16)``, then ``fc_width``; building one calls
    ``full_fp32()``, so its convolutions run in float32 and
    deterministically); otherwise the observation is flattened into the
    ``hidden`` MLP.  ``device=None`` is ``cuda``.
    """
    device = resolve_device(device)
    if transformer is not None:
        spec, seq_fn, cfg = make_seq_policy(tuple(obs_shape), out_dim,
                                            **transformer)

        return Network(lambda g: common.init_params(spec, g, device),
                       seq_fn, out_dim, seq_cfg=cfg)
    if len(obs_shape) == 3:
        full_fp32()
        spec = cnn_spec(tuple(obs_shape), tuple(conv_filters or (16, 16, 16)),
                        fc_width, out_dim)
        return Network(lambda g: common.init_params(spec, g, device),
                       cnn_apply, out_dim)
    obs_dim = int(np.prod(obs_shape))
    spec = mlp_spec(obs_dim, hidden, out_dim)
    return Network(lambda g: init_mlp(spec, g, device), mlp_apply, out_dim)


def params_from_jax(tree: Any, device=None) -> Params:
    """The port's params from a JAX param tree.

    ``tree`` is nested dicts of arrays (numpy, or anything ``np.asarray``
    takes), as ``repro.rl.networks`` lays them out (MLP or sequence
    policy); the result keeps the names and the ``(K, N)`` layout, in
    float32 on ``device`` (``None`` is ``cuda``).
    """
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)
