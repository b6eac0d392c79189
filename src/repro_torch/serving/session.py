"""Session lifecycle + thread-safe counters for the policy server.

A copy of ``repro/serving/session.py`` (plain Python).

A *session* is one concurrent consumer of the served policy — an env
instance, a user connection, an edge device.  The server holds only
accounting state per session (the policy itself is stateless obs -> action;
env state stays client-side), so thousands of sessions are cheap: the cost
of a session is one small dataclass and a dict slot.

Lifecycle::

    sid = server.open_session()       # open     (registered, steppable)
    server.submit(sid, obs).result()  # stepping (any number of times)
    server.close_session(sid)         # closed   (further submits raise)

``StepCounter`` is the saxml ``servable_model`` idiom: a mutex-guarded
monotone counter handing out dispatch/step tickets from host threads.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict


class StepCounter:
    """A thread-safe counter that hands out consecutive step numbers.

    ``next()`` returns the current value and increments — safe to call from
    any number of submitter/dispatcher threads.
    """

    def __init__(self, start: int = 0):
        """Start counting from ``start`` (default 0)."""
        self._mu = threading.Lock()
        self._value = int(start)

    def next(self) -> int:
        """Return the current ticket and advance the counter by one."""
        with self._mu:
            result = self._value
            self._value += 1
            return result

    @property
    def value(self) -> int:
        """Current counter value (the next ticket ``next()`` would return)."""
        with self._mu:
            return self._value


@dataclasses.dataclass
class Session:
    """Accounting record for one open serving session.

    Fields: ``sid`` (server-unique id), ``opened_at_step`` (global dispatch
    step at open time), ``steps`` (actions served to this session),
    ``last_version`` (cache version that answered the latest step; -1
    before the first), ``closed`` (terminal flag — closed sessions reject
    further submits).
    """

    sid: int
    opened_at_step: int
    steps: int = 0
    last_version: int = -1
    closed: bool = False


class SessionTable:
    """Thread-safe registry of open sessions.

    ``open()`` mints monotonically increasing session ids; ``close()`` is
    terminal (the record is dropped, the id is never reused).  ``checkout``
    validates a session id on the submit path and raises ``KeyError`` for
    unknown/closed sessions — a protocol error, not a server fault.
    """

    def __init__(self):
        """Create an empty table."""
        self._mu = threading.Lock()
        self._next_sid = 0
        self._sessions: Dict[int, Session] = {}
        self._opened = 0
        self._closed = 0

    def open(self, at_step: int = 0) -> int:
        """Open a new session and return its id.

        ``at_step`` stamps the global dispatch step at open time (for
        session-age accounting in ``stats``).
        """
        with self._mu:
            sid = self._next_sid
            self._next_sid += 1
            self._sessions[sid] = Session(sid=sid, opened_at_step=at_step)
            self._opened += 1
            return sid

    def checkout(self, sid: int) -> Session:
        """Return the live ``Session`` for ``sid`` or raise ``KeyError``."""
        with self._mu:
            try:
                return self._sessions[sid]
            except KeyError:
                raise KeyError(f"unknown or closed session {sid}") from None

    def on_step(self, sid: int, version: int) -> None:
        """Record one served action for ``sid`` answered by cache
        ``version`` (missing sids are ignored: the session may close
        between submit and dispatch, which is a legal race)."""
        with self._mu:
            s = self._sessions.get(sid)
            if s is not None:
                s.steps += 1
                s.last_version = version

    def close(self, sid: int) -> Session:
        """Close ``sid`` and return its final record; ``KeyError`` if it
        is not open."""
        with self._mu:
            try:
                s = self._sessions.pop(sid)
            except KeyError:
                raise KeyError(f"unknown or closed session {sid}") from None
            s.closed = True
            self._closed += 1
            return s

    def __len__(self) -> int:
        """Number of currently open sessions."""
        with self._mu:
            return len(self._sessions)

    def stats(self) -> Dict[str, int]:
        """Counters: ``open`` (now), ``opened``/``closed`` (lifetime)."""
        with self._mu:
            return {"open": len(self._sessions), "opened": self._opened,
                    "closed": self._closed}
