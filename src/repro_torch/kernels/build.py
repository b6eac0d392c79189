"""Build the port's CUDA kernels with ``nvcc`` at first use; bind with ctypes.

Each source in ``csrc/`` is compiled on its own into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \\
         -shared -Xcompiler -fPIC -o build/repro_torch/lib<name>-<hash>.so \\
         csrc/<name>.cu

``-fmad=false`` keeps nvcc from contracting ``a * b + c`` into an FMA, which
the bitwise contract with the plain versions forbids.  The library name
carries a hash of the source and flags, so an edited source builds anew and
an unchanged one is loaded from ``build/`` (listed in ``.gitignore``).
``build`` starts one ``nvcc`` per missing library, all at once.

Only sources of this directory go into a build.  Nothing here is imported
or compiled when the package is imported: the first launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"int8_matmul": "int8_matmul.cu", "fused_qmlp": "fused_qmlp.cu",
           "int8_cache_attention": "int8_cache_attention.cu",
           "fake_quant": "fake_quant.cu",
           "flash_attention": "flash_attention.cu"}
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
ptxas_log: Dict[str, str] = {}     # per kernel: what ``-Xptxas -v`` printed


class LaunchCounter:
    """Thread-safe count of one kernel's launches.

    A kernel's wrapper calls ``add`` where it launches the kernel and
    nowhere else, so a run can show that its main path went through it.
    """

    def __init__(self, name: str):
        """Start at 0."""
        self.name = name
        self._mu = threading.Lock()
        self._n = 0

    def add(self, n: int = 1) -> None:
        """Count ``n`` launches (one call that launches ``n`` kernels)."""
        with self._mu:
            self._n += n

    def reset(self) -> None:
        """Set the count back to 0."""
        with self._mu:
            self._n = 0

    @property
    def value(self) -> int:
        """Launches since the last ``reset``."""
        with self._mu:
            return self._n


class on_device:
    """``with on_device(dev) as stream``: inside, ``dev`` is the current
    device (a kernel launches on the current device) and ``stream`` is the
    raw handle of its current stream, the one PyTorch's own work on
    ``dev`` is queued on.  It switches devices only when ``dev`` is not
    current already and builds no ``torch.cuda.Stream`` object, host work
    that ``torch.cuda.device`` plus ``torch.cuda.current_stream`` pay at
    each of the thousands of launches an iteration makes.
    """

    __slots__ = ("_idx", "_prev")

    def __init__(self, dev: torch.device):
        self._idx = (dev.index if dev.index is not None
                     else torch.cuda.current_device())

    def __enter__(self) -> int:
        self._prev = torch.cuda.current_device()
        if self._prev != self._idx:
            torch.cuda.set_device(self._idx)
        return torch._C._cuda_getCurrentRawStream(self._idx)

    def __exit__(self, *exc) -> bool:
        if self._prev != self._idx:
            torch.cuda.set_device(self._prev)
        return False


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``PATH``, then the default."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with the CUDA toolkit on the machine with the card")


def _lib_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet.

    Starts one ``nvcc`` per source, all together, and waits for them.
    Returns the seconds each compile took (0.0 when already built).
    Raises ``RuntimeError`` with the compiler's output if one fails.
    """
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, took = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            took[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        ptxas_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The built library of kernel ``name``, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib
