"""Builds the hand-written CUDA kernels under ``csrc/`` and loads them.

Each ``csrc/<name>.cu`` exposes a plain C interface (data pointers, ints and
the stream; returns ``cudaGetLastError()``), so it compiles in seconds with
``nvcc`` alone, without PyTorch's headers, and is bound with ``ctypes``.
Builds go to ``_build/`` inside the package (listed in ``.gitignore``) under
a name that carries the hash of the source, the shared ``*.cuh`` headers and
the flags, so an edited source is
rebuilt at its next use and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from gnn_pressure_estimation_tpu_torch.utils import tracing

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
KERNELS = ("band_attention", "band_spmm", "band_attention_bwd", "band_spmm_bwd",
           "fused_attention", "fused_attention_bwd", "fused_factored", "fused_factored_bwd",
           "band_attention_flash", "band_attention_flash_bwd",
           "band_attention_window", "band_attention_window_bwd", "band_attention_acc_bwd",
           "window_gather")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    # the shared headers count for every source: few and small, and an edit
    # to one must rebuild whatever includes it
    src = b"".join(p.read_bytes() for p in (CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names=KERNELS) -> dict[str, str]:
    """Compile every kernel whose build is missing, one ``nvcc`` per source,
    all started together. Returns each kernel's compiler output (``-Xptxas
    -v``: registers, shared memory, spills), empty for a kernel that was
    already built. Raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        so = _target(name)
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (so, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    logs = {name: "" for name in names}
    failed = []
    for name, (so, tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, so)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{logs[name]}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed. Opening a library
    is the span ``kernels.open`` (attributes ``kernel`` and ``built``, 1
    where ``nvcc`` ran); a library already open is returned as it is."""
    with _lock:
        if name not in _libs:
            with tracing.setup_span("kernels.open", kernel=name, built=0) as sp:
                so = _target(name)
                if not so.exists():
                    build_all((name,))
                    sp.set(built=1)
                _libs[name] = ctypes.CDLL(str(so))
        return _libs[name]
