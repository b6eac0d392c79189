"""Fake quantization with the straight-through estimator, and the range
observers of quantization-aware training (QuaRL Sec. 3.2, Algorithm 2).

Counterpart of ``repro/core/fake_quant.py``:

* ``fake_quant(w, vmin, vmax, bits)`` -- quantize-dequantize in the
  forward pass (``kernels.ops.fake_quant_with_range``, kernel B5 on the
  card), identity gradient to ``w`` and none to the range in the backward
  pass (``_STE``, the straight-through estimator);
* ``ObserverState`` / ``observe`` -- a tensor's running min/max (an EMA
  of the batch min/max), monitored for the first ``quant_delay`` updates
  and frozen after;
* ``QATContext`` -- what a layer calls at each quantized site:
  ``weight(name, w)`` and ``activation(name, x)``.  It reads observer
  slots from ``collection`` and records their updates in ``updates``.

The delay is a pair of 0-d bool tensors computed from the device step
(``monitoring = step < quant_delay``, ``enabled = not monitoring``), and
every site fake-quantizes and then selects with ``torch.where``, as the
reference does: both phases run the same ops, B5 launches at every site
of every forward, and nothing waits on the host.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.core.qconfig import QuantConfig
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
    differentiated.
    """
    lo, hi = torch.aminmax(x.detach())
    bmin = torch.clamp(lo, max=0.0).to(torch.float32)
    bmax = torch.clamp(hi, min=0.0).to(torch.float32)
    d = ema_decay
    new_min = torch.where(state.initialized,
                          d * state.vmin + (1 - d) * bmin, bmin)
    new_max = torch.where(state.initialized,
                          d * state.vmax + (1 - d) * bmax, bmax)
    return ObserverState(torch.where(monitoring, new_min, state.vmin),
                         torch.where(monitoring, new_max, state.vmax),
                         state.initialized | monitoring)


class _STE(torch.autograd.Function):
    """Quantize-dequantize forward; identity gradient to ``w``, none to
    the range (the reference's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, w, vmin, vmax, bits):
        return ops.fake_quant_with_range(w, vmin, vmax, bits)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def fake_quant(w: torch.Tensor, vmin: torch.Tensor, vmax: torch.Tensor,
               bits: int) -> torch.Tensor:
    """The paper's Q_n^train with the straight-through estimator, over the
    range ``(vmin, vmax)`` (0-d tensors on ``w``'s device)."""
    return _STE.apply(w.to(torch.float32), vmin.detach().to(torch.float32),
                      vmax.detach().to(torch.float32), bits).to(w.dtype)


def fake_quant_self_range(w: torch.Tensor, bits: int) -> torch.Tensor:
    """STE fake quantization over the tensor's own current range (the
    weights' quantizer: their range is read from the live weights)."""
    lo, hi = torch.aminmax(w.detach())
    return fake_quant(w, torch.clamp(lo, max=0.0), torch.clamp(hi, min=0.0),
                      bits)


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
    def monitoring(self) -> torch.Tensor:
        """True while the observers still learn their ranges."""
        return self.step < self.config.quant_delay

    @functools.cached_property
    def enabled(self) -> torch.Tensor:
        """True once fake quantization is on."""
        return self.step >= self.config.quant_delay

    def _slot(self, name: str) -> ObserverState:
        if name in self.updates:
            return self.updates[name]
        if name in self.collection:
            return self.collection[name]
        return ObserverState.init(self.step.device)

    def weight(self, name: str, w: torch.Tensor) -> torch.Tensor:
        """Fake-quantize a weight (per tensor, its own range)."""
        if not self.config.is_qat:
            return w
        fq = fake_quant_self_range(w, self.config.bits)
        return torch.where(self.enabled, fq, w)

    def activation(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Observe, then fake-quantize an activation (monitored range)."""
        if not (self.config.is_qat and self.config.quantize_activations):
            return x
        st = observe(self._slot(name), x, self.config.ema_decay,
                     self.monitoring)
        self.updates[name] = st
        fq = fake_quant(x, st.vmin, st.vmax, self.config.bits)
        return torch.where(self.enabled & st.initialized, fq, x)

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
