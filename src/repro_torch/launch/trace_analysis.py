"""What one rank's step costs, read off a shapes-only trace: operations,
bytes, collective bytes by kind, and memory.

Counterpart of ``repro/launch/hlo_analysis.py``.  There is no HLO: the
step runs once under a ``FakeTensorMode`` on DTensor inputs
(``launch.steps.lower_step``), and ``TraceCounter``, a dispatch mode,
sees every operation DTensor runs on a rank's local shards:

* ``flops``: the matmul-class operations of each local op, by
  ``torch.utils.flop_counter``'s formulas, plus what the hand-written
  kernels report from their shape-only branch (``kernels.ops.trace_sink``:
  ``PERF.md`` §6's bound formulas), kept apart as ``kernel_flops``;
* ``bytes_accessed``: each local op's inputs read and outputs written
  once, views and allocations excluded, the kernels' bytes included.  It
  ignores fusion: a chain of pointwise ops counts every intermediate
  twice, as no fused program would move it;
* collectives: the result bytes of each ``_c10d_functional`` collective
  a redistribution issues, by kind (``collective_stats``).  The port's
  layers run in a Python loop, so every collective is seen as many times
  as it runs.  A loop over time steps (the xLSTM blocks) is traced for
  one step and counted as many times as it runs (``repeated``): the
  reference's analysis weights its scan's body by its trip count the
  same way;
* memory: the local storages alive, arguments apart; ``temp`` is the
  peak of the rest less the outputs left at the end (``summarize_memory``
  gives the reference's fields).

DTensor's sharding propagation runs each op once more on global shapes to
learn its output's metadata; the counter ignores those runs (by their
fake mode where they make one of their own, else by standing in for the
propagator's lock).
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Any, Dict, Iterable, List, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


def _tensors(tree: Any) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Suspend:
    """Stands in for DTensor's sharding-propagation lock: while the
    propagator runs an op on global shapes, the counter looks away."""

    def __init__(self, inner, counter: "TraceCounter"):
        self.inner, self.counter = inner, counter

    def __enter__(self):
        self.counter._suspended += 1
        return self.inner.__enter__()

    def __exit__(self, *exc):
        self.counter._suspended -= 1
        return self.inner.__exit__(*exc)


class TraceCounter(TorchDispatchMode):
    """A dispatch mode that counts a rank's local work (see the module's
    docstring).  Enter it inside the trace's ``FakeTensorMode``; DTensor
    ops pass through it (it declines them), and their local ops come back
    to it.  ``arguments(tree)`` registers the step's inputs before the
    step runs.  ``fake_mode``: the trace's, whose tensors alone are
    counted (None: any fake tensor)."""

    def __init__(self, fake_mode=None):
        super().__init__()
        self.fake_mode = fake_mode
        self.flops = 0.0
        self.kernel_flops = 0.0
        self.bytes = 0.0
        self.kernels: Dict[str, int] = {}
        self.collectives: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
        self.collective_calls = 0
        self.live = 0           # bytes of live non-argument storages
        self.peak = 0
        self._args: Dict[int, int] = {}
        self._seen: Dict[int, Any] = {}
        self._suspended = 0
        self.weight = 1

    # -- memory -----------------------------------------------------------
    def arguments(self, tree: Any) -> int:
        """Register the step's local argument storages; their bytes."""
        for t in _tensors(tree):
            local = getattr(t, "_local_tensor", t)
            st = local.untyped_storage()
            self._args.setdefault(st._cdata, st.nbytes())
        return sum(self._args.values())

    def argument_bytes(self) -> int:
        return sum(self._args.values())

    def _ours(self, t) -> bool:
        return isinstance(t, FakeTensor) and (
            self.fake_mode is None or t.fake_mode is self.fake_mode)

    def _track(self, out: Any) -> None:
        for t in _tensors(out):
            if not self._ours(t):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._args or key in self._seen:
                continue
            n = st.nbytes()
            self._seen[key] = n
            self.live += n
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.live)

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    # -- the kernels' shape-only branch -----------------------------------
    def kernel(self, name: str, ops: float, nbytes: float) -> None:
        if self._suspended:
            return
        w = self.weight
        self.kernels[name] = self.kernels.get(name, 0) + w
        self.flops += w * ops
        self.kernel_flops += w * ops
        self.bytes += w * nbytes

    # -- the dispatch ------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._suspended or not any(
                self._ours(t) for t in _tensors((args, out))):
            return out      # DTensor's bookkeeping, or a small constant
        ns = func.namespace
        if ns == "_c10d_functional":
            kind = _KINDS.get(func._opname)
            if kind is not None:
                b = float(sum(_nbytes(t) for t in _tensors(out)))
                self.collectives[kind] += self.weight * b
                self.collective_calls += self.weight
        elif ns == "aten":
            packet = func._overloadpacket
            if packet in flop_registry:
                self.flops += self.weight * flop_registry[packet](
                    *args, **kwargs, out_val=out)
            ins = list(_tensors((args, kwargs)))
            if ins and not func.is_view:
                self.bytes += self.weight * (
                    sum(_nbytes(t) for t in ins)
                    + sum(_nbytes(t) for t in _tensors(out)))
        self._track(out)
        return out

    @contextlib.contextmanager
    def counting(self):
        """Enter the mode with the kernels' sink and the propagator's lock
        pointed at this counter."""
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        from repro_torch.kernels import ops
        lock = getattr(ShardingPropagator, "_fake_mode_lock", None)
        sink = ops.trace_sink
        if lock is not None:
            ShardingPropagator._fake_mode_lock = _Suspend(lock, self)
        ops.trace_sink = self.kernel
        _active.append(self)
        try:
            with self:
                yield self
        finally:
            _active.remove(self)
            if lock is not None:
                ShardingPropagator._fake_mode_lock = lock
            ops.trace_sink = sink


_active: List[TraceCounter] = []


@contextlib.contextmanager
def repeated(n: int):
    """Within, the counting trace (if any) counts every operation, byte,
    collective and kernel ``n`` times (0: not at all); memory is tracked
    as it is.  For a loop body traced once for ``n`` steps."""
    if not _active:
        yield
        return
    counter = _active[-1]
    before = counter.weight
    counter.weight = before * n
    try:
        yield
    finally:
        counter.weight = before


def collective_stats(counter: TraceCounter) -> Dict[str, float]:
    """Collective bytes a rank receives as results, by kind and in
    total (the reference's keys)."""
    out = {k: float(counter.collectives.get(k, 0.0)) for k in COLLECTIVES}
    out["total"] = float(sum(out.values()))
    return out


def summarize_memory(memory: Dict[str, Optional[float]]) -> Dict[str, float]:
    """The reference's fields (``*_size_in_bytes``) out of a memory
    record, and ``total_nonalias_bytes = argument + output + temp -
    alias``."""
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes",
              "alias_size_in_bytes")
    out = {f: float(memory[f]) for f in fields
           if memory.get(f) is not None}
    if out.get("argument_size_in_bytes") is not None:
        out["total_nonalias_bytes"] = (
            out.get("argument_size_in_bytes", 0.0)
            + out.get("output_size_in_bytes", 0.0)
            + out.get("temp_size_in_bytes", 0.0)
            - out.get("alias_size_in_bytes", 0.0))
    return out


def memory_record(counter: TraceCounter, outputs: Any) -> Dict[str, float]:
    """Argument, output, alias and temp bytes of a finished trace:
    ``alias`` the outputs whose storage is an argument's (the in-place
    update), ``temp`` the peak of the other storages less the non-alias
    outputs, which are still alive."""
    seen: List[int] = []
    out_bytes = alias = 0
    for t in _tensors(outputs):
        local = getattr(t, "_local_tensor", t)
        st = local.untyped_storage()
        if st._cdata in seen:
            continue
        seen.append(st._cdata)
        n = st.nbytes()
        out_bytes += n
        if st._cdata in counter._args:
            alias += n
    return {"argument_size_in_bytes": float(counter.argument_bytes()),
            "output_size_in_bytes": float(out_bytes),
            "temp_size_in_bytes": float(max(
                counter.peak - (out_bytes - alias), 0)),
            "alias_size_in_bytes": float(alias)}
