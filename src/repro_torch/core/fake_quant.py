"""The range observers and the sites of quantization-aware training
(QuaRL Sec. 3.2, Algorithm 2).

Counterpart of ``repro/core/fake_quant.py``:

* ``ObserverState`` / ``observe`` -- a tensor's running min/max (an EMA
  of the batch min/max), monitored for the first ``quant_delay`` updates
  and frozen after;
* ``fake_quant`` / ``fake_quant_self_range`` -- the paper's Q_n^train
  with the straight-through estimator over a given range, a scalar or one
  a channel (the conv weight site), or the tensor's own range: plain
  torch, as the reference computes them in jnp outside its kernel;
* ``QATContext`` -- what a layer calls at each quantized site:
  ``weight(name, w)`` and ``activation(name, x)``.  It reads observer
  slots from ``collection`` and records their updates in ``updates``.

Each site is one ``torch.autograd.Function`` over ``ops.qat_weight_site``
/ ``ops.qat_activation_site``: on the card one launch of B5's site
kernel, which reads the device step and takes the delay's gates
(``monitoring = step < quant_delay``, ``enabled = not monitoring``)
itself, so both phases run the same launch and nothing waits on the
host; on the CPU the composition the reference runs (``observe``, the
fake quantizer, ``torch.where``; ``kernels.fake_quant`` holds it).  The
gradient is the reference's straight-through estimator: ``g`` to the
site's input, nothing to the ranges.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.core import affine
from repro_torch.core.qconfig import QuantConfig
from repro_torch.kernels import fake_quant as _fk
from repro_torch.kernels import ops


class ObserverState(NamedTuple):
    """Running range of one tensor: f32 scalars and a bool scalar."""

    vmin: torch.Tensor
    vmax: torch.Tensor
    initialized: torch.Tensor

    @staticmethod
    def init(device=None) -> "ObserverState":
        """A fresh, uninitialized slot on ``device``."""
        return ObserverState(
            vmin=torch.zeros((), dtype=torch.float32, device=device),
            vmax=torch.zeros((), dtype=torch.float32, device=device),
            initialized=torch.zeros((), dtype=torch.bool, device=device))


def observe(state: ObserverState, x: torch.Tensor, ema_decay: float,
            monitoring: torch.Tensor) -> ObserverState:
    """Update the running range with ``x`` while ``monitoring`` is true.

    The batch range is extended to 0; the first batch sets it directly,
    later ones move an EMA with decay ``ema_decay``.  Once monitoring
    ends the state comes back as it was.  ``x`` is read, never
    differentiated.  (The QAT sites run this inside the site kernel on the
    card; ``kernels.fake_quant.observe_plain`` is the composition.)
    """
    return ObserverState(*_fk.observe_plain(
        state.vmin, state.vmax, state.initialized, x, ema_decay, monitoring))


class _STEQuantizeDequantize(torch.autograd.Function):
    """``affine.quantize_dequantize`` forward; the gradient passes to the
    input unchanged and to the params not at all (the paper's STE)."""

    @staticmethod
    def forward(ctx, w, delta, zero_point, bits):
        return affine.quantize_dequantize(
            w, affine.AffineParams(delta, zero_point, bits))

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def fake_quant(w: torch.Tensor, vmin: torch.Tensor, vmax: torch.Tensor,
               bits: int) -> torch.Tensor:
    """The paper's Q_n^train with the straight-through estimator, over the
    range ``(vmin, vmax)`` extended to 0: 0-d tensors, or per-channel ones
    that broadcast against ``w``'s last axis.  Identity gradient to ``w``,
    none to the range."""
    p = affine.affine_params_from_range(vmin.to(torch.float32),
                                        vmax.to(torch.float32), bits)
    return _STEQuantizeDequantize.apply(w.to(torch.float32), p.delta,
                                        p.zero_point, bits).to(w.dtype)


def fake_quant_self_range(w: torch.Tensor, bits: int) -> torch.Tensor:
    """``fake_quant`` over ``w``'s own instantaneous range (min and max of
    the whole tensor)."""
    return fake_quant(w, torch.clamp(w.amin(), max=0.0),
                      torch.clamp(w.amax(), min=0.0), bits)


class _ActivationSite(torch.autograd.Function):
    """One activation site (``ops.qat_activation_site``): the observer
    update and the gated fake quantization forward; the gradient to ``x``
    is ``g`` itself (the straight-through estimator through either branch
    of the gate), and the state and the step get none."""

    @staticmethod
    def forward(ctx, x, vmin, vmax, initialized, step, quant_delay,
                ema_decay, bits):
        out, nmin, nmax, ninit = ops.qat_activation_site(
            x, vmin, vmax, initialized, step, quant_delay, ema_decay, bits)
        ctx.mark_non_differentiable(nmin, nmax, ninit)
        return out, nmin, nmax, ninit

    @staticmethod
    def backward(ctx, g, *_):
        return g, None, None, None, None, None, None, None


class _WeightSite(torch.autograd.Function):
    """One weight site (``ops.qat_weight_site``): the gated fake
    quantization over the weight's own range; identity gradient."""

    @staticmethod
    def forward(ctx, w, step, quant_delay, bits):
        return ops.qat_weight_site(w, step, quant_delay, bits)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


@dataclasses.dataclass
class QATContext:
    """The observer reads and writes of one forward.

    ``step`` is the device step (a 0-d int tensor).  The delay:
    ``step < quant_delay``: monitoring, full precision; ``step >=
    quant_delay``: frozen ranges, fake quantization on.
    """

    config: QuantConfig
    collection: Dict[str, ObserverState]
    step: torch.Tensor
    updates: Dict[str, ObserverState] = dataclasses.field(
        default_factory=dict)

    @functools.cached_property
    def enabled(self) -> torch.Tensor:
        """True once fake quantization is on."""
        return self.step >= self.config.quant_delay

    @property
    def monitoring(self) -> torch.Tensor:
        """True while the observers still move (before the delay)."""
        return self.step < self.config.quant_delay

    def _slot(self, name: str) -> ObserverState:
        if name in self.updates:
            return self.updates[name]
        if name in self.collection:
            return self.collection[name]
        return ObserverState.init(self.step.device)

    def weight(self, name: str, w: torch.Tensor) -> torch.Tensor:
        """Fake-quantize a weight (per tensor, its own range) from the
        delay on: one site-kernel launch on the card."""
        if not self.config.is_qat:
            return w
        out = _WeightSite.apply(w.to(torch.float32), self.step,
                                self.config.quant_delay, self.config.bits)
        return out.to(w.dtype)

    def activation(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Observe, then fake-quantize an activation (monitored range):
        one site-kernel launch on the card."""
        if not (self.config.is_qat and self.config.quantize_activations):
            return x
        st = self._slot(name)
        out, *new = _ActivationSite.apply(
            x.to(torch.float32), st.vmin, st.vmax, st.initialized,
            self.step, self.config.quant_delay, self.config.ema_decay,
            self.config.bits)
        self.updates[name] = ObserverState(*new)
        return out.to(x.dtype)

    def merged_collection(self) -> Dict[str, ObserverState]:
        """The collection with this forward's updates applied."""
        out = dict(self.collection)
        out.update(self.updates)
        return out


class NullQATContext:
    """The context of a network that is not quantization-aware: every
    site passes its tensor through."""

    config = QuantConfig.none()
    enabled = False

    def weight(self, name: str, w: torch.Tensor) -> torch.Tensor:
        """``w`` unchanged."""
        return w

    def activation(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """``x`` unchanged."""
        return x

    def merged_collection(self) -> Dict[str, ObserverState]:
        """No observers."""
        return {}


def make_context(config: QuantConfig,
                 collection: Optional[Dict[str, ObserverState]],
                 step) -> "QATContext | NullQATContext":
    """A ``QATContext`` for a QAT config, else a ``NullQATContext``.
    ``step`` is a tensor (its device is the observers' device) or an
    int (then on the CPU)."""
    if not config.is_qat:
        return NullQATContext()
    return QATContext(config=config, collection=collection or {},
                      step=torch.as_tensor(step))


class NameRecorder:
    """A context that records every activation-site name, and the device
    the sites ran on, and quantizes nothing."""

    enabled = False

    def __init__(self, config: QuantConfig):
        self.config = config
        self.names: set = set()
        self.device = None

    def weight(self, name: str, w: torch.Tensor) -> torch.Tensor:
        """``w`` unchanged."""
        return w

    def activation(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Record ``name``; ``x`` unchanged."""
        self.names.add(name)
        self.device = x.device
        return x

    def merged_collection(self) -> Dict[str, ObserverState]:
        """No observers."""
        return {}

    def collection(self) -> Dict[str, ObserverState]:
        """A fresh slot for every recorded name, in sorted order."""
        return {name: ObserverState.init(self.device)
                for name in sorted(self.names)}


def discover_observers(config: QuantConfig, trace_fn
                       ) -> Dict[str, ObserverState]:
    """Fresh observer slots for every site ``trace_fn(recorder)`` reaches.

    ``trace_fn`` runs one forward (on zeros, say) under ``no_grad``: where
    the reference traces shapes only (``eval_shape``), the port runs the
    forward once.
    """
    rec = NameRecorder(config)
    with torch.no_grad():
        trace_fn(rec)
    return rec.collection()
