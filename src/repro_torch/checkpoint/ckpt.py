"""Checkpoints of the port's state trees: one file, or the manager's
directory per step.

Counterpart of ``repro/checkpoint/ckpt.py``.  A tree (dicts, lists,
tuples, ``NamedTuple``s such as ``TrainState`` or ``ReplayState``, packed
int8/int4 caches) is flattened by ``core.ptq.tree_flatten`` and its
leaves -- tensors on any device, and Python numbers -- are written as raw
little-endian bytes, one after another; a JSON header (or the manager's
``manifest.json``) records each leaf's shape, dtype and byte offset.  A
load takes a template tree of the same structure (a fresh state of the
same config), validates every leaf's shape and dtype against it before
any data is read, and puts each leaf where the template's lies: on its
device, or back into a Python number.  No pickle: a checkpoint holds
only numbers.

Durability: a save stages into a ``ckpt-tmp-*`` file in the target
directory, fsyncs it, ``os.replace``s it onto its name (the commit
point) and fsyncs the directory, so a crash at any earlier instant
leaves the committed checkpoints as they were and at worst staging
debris, which ``sweep_orphans`` removes.  Mismatches raise
``ValueError`` with one line a leaf.

The format tag is the port's own (``FORMAT``): the reference's
``repro-ckpt-v1`` holds msgpack, which the port does not read.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import struct
import sys
import tempfile
import zlib
from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.ptq import tree_flatten, tree_unflatten

Tree = Any
Spec = Tuple[Tuple[int, ...], str]

FORMAT = "repro-torch-ckpt-v1"

# staging patterns of this package: sweep_orphans removes them, readers
# skip them
TMP_PREFIX = "ckpt-tmp-"                       # file saves (this module)
_FILE_RE = re.compile(r"^ckpt_(\d+)\.bin$")
_DIR_RE = re.compile(r"^ckpt_(\d+)$")
_TMP_DIR_RE = re.compile(r"^ckpt_\d+\.tmp-")   # manager staging dirs
DATA_FILE = "leaves.bin"                        # a step directory's data
MANIFEST_FILE = "manifest.json"

# numpy's spellings, so a manifest reads as the reference's does
_DTYPES = {torch.float64: "<f8", torch.float32: "<f4", torch.float16: "<f2",
           torch.bfloat16: "bfloat16", torch.int64: "<i8",
           torch.int32: "<i4", torch.int16: "<i2", torch.int8: "|i1",
           torch.uint8: "|u1", torch.bool: "|b1"}
_TORCH = {v: k for k, v in _DTYPES.items()}
# Python numbers are stored as 0-d leaves of these types
_SCALARS = ((bool, torch.bool), (int, torch.int64), (float, torch.float64))

if sys.byteorder != "little":      # the raw bytes are the host's own
    raise ImportError("repro_torch.checkpoint writes little-endian bytes")


def leaf_spec(x) -> Spec:
    """``(shape, dtype)`` of a leaf: a tensor's, or ``((), ...)`` of a
    Python number (bool, int as int64, float as float64)."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), _DTYPES[x.dtype]
    for kind, dtype in _SCALARS:
        if isinstance(x, kind):
            return (), _DTYPES[dtype]
    raise TypeError(f"a checkpoint leaf is a tensor or a Python number, "
                    f"got {type(x).__name__}")


def host_leaves(tree: Tree) -> List[torch.Tensor]:
    """A forced CPU copy of every leaf, Python numbers as 0-d tensors.

    A CUDA tensor's copy waits for the current stream: work of another
    stream that writes it must be joined to the current one first."""
    out = []
    for x in tree_flatten(tree)[1]:
        leaf_spec(x)
        if isinstance(x, torch.Tensor):
            out.append(x.detach().to("cpu", copy=True))
        else:
            dtype = next(d for kind, d in _SCALARS if isinstance(x, kind))
            out.append(torch.tensor(x, dtype=dtype))
    return out


def encode(host: Sequence[torch.Tensor]) -> Tuple[bytes, List[dict]]:
    """``(data, leaves)``: the leaves' bytes one after another, and each
    leaf's ``shape``, ``dtype``, byte ``offset`` and ``nbytes``."""
    chunks, specs, offset = [], [], 0
    for t in host:
        raw = t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
        shape, dtype = leaf_spec(t)
        specs.append(dict(shape=list(shape), dtype=dtype, offset=offset,
                          nbytes=len(raw)))
        chunks.append(raw)
        offset += len(raw)
    return b"".join(chunks), specs


def decode(data: bytes, specs: Sequence[dict], source: str
           ) -> List[torch.Tensor]:
    """The CPU tensors of ``encode``'s ``data``; writable copies."""
    out = []
    for s in specs:
        dtype = _TORCH[s["dtype"]]
        n = int(s["nbytes"])
        if s["offset"] + n > len(data):
            raise ValueError(f"{source}: the data ends before a leaf of "
                             f"{n} bytes at {s['offset']} (torn checkpoint)")
        if n:
            t = torch.frombuffer(bytearray(data[s["offset"]:s["offset"] + n]),
                                 dtype=dtype)
        else:
            t = torch.empty(0, dtype=dtype)
        out.append(t.reshape(tuple(s["shape"])))
    return out


def validate_leaves(specs: Sequence[Spec], template: Tree, *,
                    source: str) -> None:
    """Hold ``(shape, dtype)`` specs against ``template``'s leaves.

    Raises ``ValueError`` naming every leaf that differs by its path: a
    check of the count alone would let a template of the same count and
    another shape read garbage."""
    paths, leaves = tree_flatten(template)
    if len(specs) != len(leaves):
        raise ValueError(
            f"{source}: leaf count mismatch -- checkpoint has {len(specs)} "
            f"leaves, template has {len(leaves)}")
    bad = []
    for path, t, (shape, dtype) in zip(paths, leaves, specs):
        want_shape, want_dtype = leaf_spec(t)
        if tuple(shape) != want_shape or dtype != want_dtype:
            bad.append(f"  {path}: checkpoint {tuple(shape)}/{dtype} vs "
                       f"template {want_shape}/{want_dtype}")
    if bad:
        raise ValueError(
            f"{source}: {len(bad)} leaf mismatch(es) against the template "
            f"(another net_kwargs or algorithm config?):\n" + "\n".join(bad))


def restore_leaves(host: Sequence[torch.Tensor], template: Tree) -> Tree:
    """``template``'s structure over ``host`` leaves: each on its template
    leaf's device, or a Python number of the template's type."""
    out = []
    for x, t in zip(host, tree_flatten(template)[1]):
        out.append(x.to(t.device) if isinstance(t, torch.Tensor)
                   else type(t)(x.item()))
    return tree_unflatten(template, out)


def crc32(data: bytes) -> int:
    """Whole-file checksum recorded in a manifest."""
    return zlib.crc32(data) & 0xFFFFFFFF


def fsync_dir(path: str) -> None:
    """fsync a directory, so renames inside it survive a power loss."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _file_path(path: str, step: Optional[int]) -> str:
    return path if step is None else os.path.join(path,
                                                  f"ckpt_{step:08d}.bin")


def save_checkpoint(path: str, tree: Tree, step: Optional[int] = None
                    ) -> str:
    """Save ``tree``'s leaves durably to one file; returns its path.

    With ``step`` the file is ``<path>/ckpt_{step:08d}.bin`` and a commit
    also sweeps staging debris of earlier crashed saves there.  The file
    is an 8-byte little-endian header length, a JSON header (``format``,
    the leaves' specs and offsets, the data's ``crc32``) and the data.
    """
    path = _file_path(path, step)
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    data, specs = encode(host_leaves(tree))
    header = json.dumps(dict(format=FORMAT, leaves=specs,
                             crc32=crc32(data))).encode()
    fd, tmp = tempfile.mkstemp(dir=d, prefix=TMP_PREFIX)
    with os.fdopen(fd, "wb") as f:
        f.write(struct.pack("<Q", len(header)) + header + data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(d)
    if step is not None:
        sweep_orphans(d)
    return path


def load_checkpoint(path: str, template: Tree, step: Optional[int] = None
                    ) -> Tree:
    """Load a ``save_checkpoint`` file into ``template``'s structure.

    Every leaf's shape and dtype is held against the template before the
    data is read, and the data against its checksum; any mismatch raises
    ``ValueError``."""
    path = _file_path(path, step)
    with open(path, "rb") as f:
        raw = f.read()
    try:
        (n,) = struct.unpack("<Q", raw[:8])
        header = json.loads(raw[8:8 + n])
    except (struct.error, ValueError) as e:
        raise ValueError(f"{path}: not a checkpoint file ({e})") from None
    if header.get("format") != FORMAT:
        raise ValueError(f"{path}: unknown checkpoint format "
                         f"{header.get('format')!r} (want {FORMAT!r})")
    specs = header["leaves"]
    validate_leaves([(tuple(s["shape"]), s["dtype"]) for s in specs],
                    template, source=path)
    data = raw[8 + n:]
    if crc32(data) != header["crc32"]:
        raise ValueError(f"{path}: checksum mismatch (torn or corrupted "
                         f"checkpoint; refusing to read it)")
    return restore_leaves(decode(data, specs, path), template)


def step_dir_valid(path: str) -> bool:
    """Is a manager step directory loadable?  Its manifest parses and has
    the port's format tag, its data file exists and matches the
    manifest's ``crc32``.  A torn or corrupted step gives False, never an
    error, so a resume can fall back to the newest valid one."""
    try:
        with open(os.path.join(path, MANIFEST_FILE), "r",
                  encoding="utf-8") as f:
            m = json.load(f)
        if m.get("format") != FORMAT:
            return False
        with open(os.path.join(path, DATA_FILE), "rb") as f:
            return crc32(f.read()) == int(m["crc32"])
    except (OSError, ValueError, KeyError, TypeError):
        return False


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest committed, valid step in ``ckpt_dir``, or None.

    Both layouts count: ``ckpt_N.bin`` files and the manager's ``ckpt_N/``
    directories that pass ``step_dir_valid``.  Other ``ckpt_*`` entries
    are skipped, never fatal."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        full = os.path.join(ckpt_dir, name)
        m = _FILE_RE.match(name)
        if m and os.path.isfile(full):
            steps.append(int(m.group(1)))
            continue
        m = _DIR_RE.match(name)
        if m and step_dir_valid(full):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def sweep_orphans(ckpt_dir: str) -> List[str]:
    """Remove the staging debris of crashed or failed saves (``ckpt-tmp-*``
    files, ``ckpt_N.tmp-*`` directories) and return their names.  Under
    one writer a directory's, a sweep after that writer's own commit sees
    only dead debris."""
    removed: List[str] = []
    if not os.path.isdir(ckpt_dir):
        return removed
    for name in os.listdir(ckpt_dir):
        full = os.path.join(ckpt_dir, name)
        if name.startswith(TMP_PREFIX) and os.path.isfile(full):
            os.unlink(full)
            removed.append(name)
        elif _TMP_DIR_RE.match(name) and os.path.isdir(full):
            shutil.rmtree(full)
            removed.append(name)
    return removed
