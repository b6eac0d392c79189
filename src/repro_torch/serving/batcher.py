"""Shape-bucketed continuous batching: admission queue, padding, unpadding.

Adapted from ``repro/serving/batcher.py`` (plain Python and numpy),
without its load-shedding bound and request deadlines: nothing on the
port's serving path sets them yet, and they come back with the port of
``resilience/faults.py``, which drives them.  The
server runs its kernels at one fixed batch shape per *bucket* instead of
one per live batch size.  Incoming requests queue on the host; the
dispatcher admits up to ``max_batch`` of them (waiting at most
``max_wait_us`` after the oldest queued request for stragglers — the tail-
latency knob), pads the stacked observations up to the smallest bucket that
fits, runs the policy once, and slices the padding back off
(``remove_padding``, the saxml ``servable_model`` idiom).

Padding fill is **repeat-last-row**, not zeros: a duplicated row never
changes a per-tensor min/max reduction, so the dynamically-quantized
(``calib_batch=0``) actor path sees the same activation ranges padded as
unpadded at every layer — padding is range-neutral by construction (the
``test_dynamic_path_padding_neutral`` property of the reference).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import List, Optional, Sequence

import numpy as np


def select_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that fits ``n`` rows.

    ``buckets`` must be sorted ascending; selection is a pure function of
    ``(n, buckets)`` — deterministic, no load feedback — so a replayed
    request stream pads identically (the ``test_bucket_selection_*``
    properties).  Raises ``ValueError`` for ``n < 1`` or ``n`` above the
    largest bucket (the admission loop never admits more than
    ``buckets[-1]``).
    """
    if n < 1:
        raise ValueError(f"need at least one row, got n={n}")
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} exceeds largest bucket {buckets[-1]}")


def pad_rows(x: np.ndarray, bucket: int) -> np.ndarray:
    """Pad ``x`` (n, ...) up to (bucket, ...) by repeating the last row.

    Repeat-padding keeps every per-tensor range reduction over the batch
    unchanged (duplicates never move a min/max), which is what makes
    padding invisible to the dynamically-quantized actor path; see the
    module docstring.  No-op when ``n == bucket``.
    """
    n = x.shape[0]
    if n == bucket:
        return x
    if n > bucket:
        raise ValueError(f"{n} rows do not fit bucket {bucket}")
    reps = np.repeat(x[-1:], bucket - n, axis=0)
    return np.concatenate([x, reps], axis=0)


def remove_padding(y, n: int):
    """Slice the first ``n`` rows back out of a padded result.

    Accepts torch or numpy arrays of shape (bucket, ...) and returns the
    (n, ...) prefix — the inverse of ``pad_rows`` on the result side.
    """
    if y.shape[0] == n:
        return y
    return y[:n]


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """One answered request: ``action`` (host numpy), ``version`` (the
    cache version that computed it), ``latency_s`` (enqueue -> completion
    wall time), ``step`` (global dispatch-step ticket of the batch)."""

    action: np.ndarray
    version: int
    latency_s: float
    step: int


class Request:
    """A queued obs -> action query for one session.

    Created by ``PolicyServer.submit``; the dispatcher fills it in and sets
    the event.  ``result()`` blocks the submitting thread until then.
    """

    __slots__ = ("sid", "obs", "t_enqueue", "_event", "_result",
                 "_error")

    def __init__(self, sid: int, obs: np.ndarray):
        """Bind a single observation (no batch axis) to session ``sid``."""
        self.sid = sid
        self.obs = obs
        self.t_enqueue = time.perf_counter()
        self._event = threading.Event()
        self._result: Optional[ServeResult] = None
        self._error: Optional[BaseException] = None

    def complete(self, action: np.ndarray, version: int, step: int,
                 t_done: float) -> None:
        """Fill in the answer and release ``result()`` (dispatcher side)."""
        self._result = ServeResult(action=action, version=version,
                                   latency_s=t_done - self.t_enqueue,
                                   step=step)
        self._event.set()

    def fail(self, err: BaseException) -> None:
        """Propagate a dispatch error to the waiting submitter."""
        self._error = err
        self._event.set()

    def result(self, timeout: Optional[float] = None) -> ServeResult:
        """Block until served and return the ``ServeResult``.

        Raises ``TimeoutError`` after ``timeout`` seconds, or re-raises the
        dispatcher-side exception if the batch failed / the server shut
        down with this request still queued.
        """
        if not self._event.wait(timeout):
            raise TimeoutError(f"request for session {self.sid} not served "
                               f"within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result


class Batcher:
    """Host-side admission queue turning single requests into batches.

    Admission policy (the two tail-latency knobs):

    * ``max_batch``  — largest admitted batch == the largest bucket;
      a full queue dispatches immediately.
    * ``max_wait_us`` — after the *oldest* queued request has waited this
      long, dispatch whatever is queued (0 = never wait for stragglers).

    ``put`` is called from submitter threads, ``get_batch`` from the
    dispatcher; both are condition-variable synchronized.
    """

    def __init__(self, max_batch: int, max_wait_us: int = 2000):
        """See class docstring for the two knobs."""
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = int(max_batch)
        self.max_wait_s = max(int(max_wait_us), 0) * 1e-6
        self._q: deque = deque()
        self._cond = threading.Condition()
        self._closed = False

    def put(self, req: Request) -> None:
        """Enqueue one request; raises ``RuntimeError`` after ``close``."""
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._q.append(req)
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        """True once ``close`` ran; a closed batcher never reopens."""
        with self._cond:
            return self._closed

    def get_batch(self, timeout: Optional[float] = None
                  ) -> Optional[List[Request]]:
        """Admit the next batch (FIFO prefix of the queue), or ``None``.

        Blocks up to ``timeout`` seconds for a first request; once one is
        queued, waits at most ``max_wait_us`` past *its* enqueue time for
        more, then returns up to ``max_batch`` requests.  Returns ``None``
        on timeout with an empty queue, or when closed and drained.
        """
        with self._cond:
            deadline = (time.perf_counter() + timeout
                        if timeout is not None else None)
            while not self._q:
                if self._closed:
                    return None
                remaining = (None if deadline is None
                             else deadline - time.perf_counter())
                if remaining is not None and remaining <= 0:
                    return None
                self._cond.wait(remaining)
            admit_by = self._q[0].t_enqueue + self.max_wait_s
            while (len(self._q) < self.max_batch and not self._closed):
                remaining = admit_by - time.perf_counter()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            n = min(len(self._q), self.max_batch)
            return [self._q.popleft() for _ in range(n)]

    def close(self) -> List[Request]:
        """Refuse new work, wake the dispatcher, return still-queued
        requests (the server fails them so no submitter blocks forever)."""
        with self._cond:
            self._closed = True
            drained = list(self._q)
            self._q.clear()
            self._cond.notify_all()
            return drained
