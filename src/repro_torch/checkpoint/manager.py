"""The directory-per-step checkpoint manager and its background writer.

Counterpart of ``repro/checkpoint/manager.py``.  Layout::

    <dir>/ckpt_00000040/leaves.bin      the leaves' raw bytes, in order
    <dir>/ckpt_00000040/manifest.json   format tag, step, leaf count, each
                                        leaf's shape, dtype and byte
                                        offset, the data's crc32, and the
                                        caller's "extra"

A commit stages both files into ``ckpt_N.tmp-<uuid>/``, fsyncs them and
the staging directory, ``os.replace``s it onto ``ckpt_N`` (the commit
point) and fsyncs the parent.  A crash at any earlier instant leaves the
committed steps as they were and at worst staging debris, which the next
commit's ``sweep_orphans`` removes.  A restore holds every leaf against
the manifest and the caller's template, and the data against its crc32,
before it builds a tensor.

``AsyncCheckpointer`` commits on one writer thread, so a training loop
waits only for the device-to-host copy, which runs on the caller's
thread (the next chunk may overwrite what is being saved).  Commits land
in the order of their saves; a writer's failure is raised again on the
next ``save_async`` or ``wait``.  One writer owns a directory at a time.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import uuid
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint import ckpt as ckpt_lib

FORMAT = ckpt_lib.FORMAT
DATA_FILE = ckpt_lib.DATA_FILE
MANIFEST_FILE = ckpt_lib.MANIFEST_FILE


class CheckpointManager:
    """Synchronous durable checkpoints: manifest, retention, validation.

    After each commit all but the newest ``keep`` steps are deleted
    (``keep <= 0`` keeps every step)."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = int(keep)
        os.makedirs(directory, exist_ok=True)

    def step_path(self, step: int) -> str:
        """The directory of ``step``."""
        return os.path.join(self.directory, f"ckpt_{int(step):08d}")

    def steps(self) -> List[int]:
        """Committed steps (a manifest present), ascending."""
        out = []
        for name in os.listdir(self.directory):
            m = ckpt_lib._DIR_RE.match(name)
            if m and os.path.isfile(os.path.join(self.directory, name,
                                                 MANIFEST_FILE)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        """The newest committed step that is valid (``step_valid``), or
        None: a torn or corrupted step is skipped."""
        for s in reversed(self.steps()):
            if self.step_valid(s):
                return s
        return None

    def step_valid(self, step: int) -> bool:
        """Whether ``step`` passes ``ckpt.step_dir_valid`` (crc32 and all)."""
        return ckpt_lib.step_dir_valid(self.step_path(step))

    def save(self, step: int, tree: Any,
             extra: Optional[Dict[str, Any]] = None) -> str:
        """Copy ``tree``'s leaves to the host and commit them; returns the
        step's directory."""
        return self.commit_hosted(step, ckpt_lib.host_leaves(tree),
                                  extra=extra)

    def commit_hosted(self, step: int, host_leaves: List[torch.Tensor],
                      extra: Optional[Dict[str, Any]] = None) -> str:
        """Commit leaves already on the host (the writer thread's path).

        A failed commit is cleaned up by nobody: it looks like a crash,
        and the next commit's sweep removes its debris."""
        data, leaves = ckpt_lib.encode(host_leaves)
        manifest = {
            "format": FORMAT,
            "step": int(step),
            "leaf_count": len(leaves),
            "leaves": leaves,
            "crc32": ckpt_lib.crc32(data),
            "extra": {} if extra is None else extra,
        }
        tmp = self.step_path(step) + ".tmp-" + uuid.uuid4().hex[:8]
        os.makedirs(tmp)
        for name, payload in ((DATA_FILE, data),
                              (MANIFEST_FILE, json.dumps(
                                  manifest, sort_keys=True).encode())):
            with open(os.path.join(tmp, name), "wb") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
        ckpt_lib.fsync_dir(tmp)
        final = self.step_path(step)
        if os.path.isdir(final):        # saving a step again
            shutil.rmtree(final)
        os.replace(tmp, final)          # the commit point
        ckpt_lib.fsync_dir(self.directory)
        self._gc()
        self.sweep_orphans()
        return final

    def manifest(self, step: int) -> Dict[str, Any]:
        """The parsed manifest of ``step``; ``ValueError`` for another
        format."""
        path = os.path.join(self.step_path(step), MANIFEST_FILE)
        with open(path, "r", encoding="utf-8") as f:
            m = json.load(f)
        if m.get("format") != FORMAT:
            raise ValueError(f"{path}: unknown checkpoint format "
                             f"{m.get('format')!r} (want {FORMAT!r})")
        return m

    def restore(self, step: int, template: Any
                ) -> Tuple[Any, Dict[str, Any]]:
        """``(tree, extra)`` of ``step`` in ``template``'s structure.

        The manifest's leaves are held against the template first, then
        the data against its crc32: either mismatch raises ``ValueError``
        with the detail, before a tensor is built."""
        m = self.manifest(step)
        source = self.step_path(step)
        ckpt_lib.validate_leaves(
            [(tuple(s["shape"]), s["dtype"]) for s in m["leaves"]],
            template, source=source)
        with open(os.path.join(source, DATA_FILE), "rb") as f:
            data = f.read()
        got = ckpt_lib.crc32(data)
        if got != int(m["crc32"]):
            raise ValueError(
                f"{source}/{DATA_FILE}: checksum mismatch -- manifest "
                f"crc32={int(m['crc32']):#010x}, file={got:#010x} (torn or "
                f"corrupted checkpoint; refusing to read it)")
        leaves = ckpt_lib.decode(data, m["leaves"], source)
        return ckpt_lib.restore_leaves(leaves, template), m.get("extra", {})

    def sweep_orphans(self) -> List[str]:
        """``ckpt.sweep_orphans`` of this directory."""
        return ckpt_lib.sweep_orphans(self.directory)

    def _gc(self) -> None:
        if self.keep <= 0:
            return
        stale = self.steps()[:-self.keep]
        for s in stale:
            shutil.rmtree(self.step_path(s), ignore_errors=True)
        if stale:
            ckpt_lib.fsync_dir(self.directory)


class AsyncCheckpointer:
    """Commits on a background writer thread.

    ``save_async`` copies the tree's leaves to the host on the caller's
    thread, queues the commit and returns; ``wait()`` drains the queue.
    A commit's end is its rename, seen by ``last_committed_step()``."""

    def __init__(self, directory: str, *, keep: int = 3,
                 manager: Optional[CheckpointManager] = None):
        self.manager = manager if manager is not None else \
            CheckpointManager(directory, keep=keep)
        # the debris a crashed predecessor left here
        self.manager.sweep_orphans()
        self._q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._error: Optional[BaseException] = None
        self._last_committed = self.manager.latest_step()
        self._closed = False
        self._thread = threading.Thread(target=self._worker,
                                        name="ckpt-writer", daemon=True)
        self._thread.start()

    def save_async(self, step: int, tree: Any,
                   extra: Optional[Dict[str, Any]] = None) -> None:
        """Copy ``tree`` to the host and queue its commit.

        ``extra`` must be JSON-serializable; it is copied here, so the
        caller may go on changing it (appending to a live list of
        rewards) while the writer works."""
        self._reraise()
        if self._closed:
            raise RuntimeError("AsyncCheckpointer is closed")
        host = ckpt_lib.host_leaves(tree)
        extra = None if extra is None else json.loads(json.dumps(extra))
        self._q.put((int(step), host, extra))

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                step, host, extra = item
                try:
                    self.manager.commit_hosted(step, host, extra=extra)
                    with self._lock:
                        self._last_committed = step
                except Exception as e:  # stored, raised to the caller
                    with self._lock:
                        self._error = e
            finally:
                self._q.task_done()

    def wait(self) -> Optional[int]:
        """Block until every queued save committed, raise a writer's
        failure, and return ``last_committed_step()``."""
        self._q.join()
        self._reraise()
        return self.last_committed_step()

    def last_committed_step(self) -> Optional[int]:
        """The step of the newest commit, or None."""
        with self._lock:
            return self._last_committed

    def latest_step(self) -> Optional[int]:
        """``CheckpointManager.latest_step`` of the directory."""
        return self.manager.latest_step()

    def restore(self, step: int, template: Any
                ) -> Tuple[Any, Dict[str, Any]]:
        """Drain the queued saves, then ``CheckpointManager.restore``."""
        self.wait()
        return self.manager.restore(step, template)

    def close(self) -> None:
        """Drain the queue and stop the writer thread (idempotent)."""
        if not self._closed:
            self._closed = True
            self._q.put(None)
        self._thread.join()

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _reraise(self) -> None:
        with self._lock:
            e, self._error = self._error, None
        if e is not None:
            raise RuntimeError("async checkpoint write failed") from e
