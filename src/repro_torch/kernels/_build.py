"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles, for ``sm_90a``, into its own shared
library with a plain C interface: under ``build/repro_torch/`` at the root
of a source checkout, or, for an installed package, under the user's cache
directory (``$XDG_CACHE_HOME/repro_torch``, by default
``~/.cache/repro_torch``).  The file name carries a hash of every source
and header plus the flags, so an edited source rebuilds and an unchanged
one is loaded as it is.  ``build_all`` starts one nvcc per source at once.
A missing nvcc, a failed build or a failed load raises.

Every wrapper counts its launches through ``bump``, so that the counts
stay exact when several worker threads launch at once.

Lock order (ranked in repro_torch.analysis.locks): ``_LOCK`` and
``_COUNT_LOCK`` are rank-70 leaves.  ``_LOCK`` is taken at a kernel's first
use, possibly under the service lock (rank 20); ``_COUNT_LOCK`` only
around one counter update.  No other lock is ever acquired while either
is held.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List


def build_dir(module: Path) -> Path:
    """Where the libraries of the package holding ``module`` (this file's
    path) go: the checkout's ``build/`` when the package sits in the
    ``src/`` of a checkout, else the user's cache directory."""
    pkg_parent = module.parents[2]
    root = module.parents[3]
    if pkg_parent.name == "src" and (root / "pyproject.toml").is_file():
        return root / "build" / "repro_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return Path(cache) / "repro_torch"


CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = build_dir(Path(__file__).resolve())
SOURCES = ("poseidon2", "ntt", "sumcheck_round", "modmatmul", "sumcheck_fold")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def bump(counts, key, n: int = 1) -> None:
    """``counts[key] += n`` under one lock: a wrapper's launch counter (its
    module's ``globals()``) or shape histogram (a ``Counter``)."""
    with _COUNT_LOCK:
        counts[key] += n


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def _start(name: str):
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names: List[str] = SOURCES) -> None:
    """Compile every named source, all nvcc processes running at once."""
    with _LOCK:
        jobs = [(n, _start(n)) for n in names]
        errors = []
        for n, job in jobs:
            try:
                _finish(n, job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launcher."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")


def stream_ptr(t) -> int:
    """The handle of the current stream on ``t``'s device, read without
    building a ``torch.cuda.Stream`` (a few microseconds a launch)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require_cuda_int64(*tensors) -> None:
    """The launchers take contiguous int64 tensors on one CUDA device."""
    import torch
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"kernel operands must share one CUDA device, got {t.device}")
        if t.dtype != torch.int64:
            raise TypeError(f"kernel operands must be int64, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
