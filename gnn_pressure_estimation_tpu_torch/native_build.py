"""Host C++ libraries of the package, built with their own Makefiles.

The hydraulic solver (``simgen/solver/``) and the zarr codecs
(``data/native/``) are plain C ABIs loaded with ``ctypes``. Each is built at
first use into the package's ``_build/`` (listed in ``.gitignore``), never
beside its source, under a name that carries the hash of its sources, its
Makefile and the host's CPU: the Makefiles build with ``-march=native``, so a
build made on one host is never loaded on another, and an edited source is
rebuilt at its next use.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent / "_build"
MAKE = "make"


def host_cpu() -> bytes:
    """The CPU model and flags a ``-march=native`` build is made for."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = [ln for ln in f.read().split(b"\n\n")[0].splitlines()
                     if ln.startswith((b"model name", b"flags"))]
        return b"\n".join(lines)
    except OSError:
        return platform.processor().encode()


def library_path(src_dir: Path, stem: str, files: tuple[str, ...]) -> Path:
    """``_build/<stem>-<digest>.so``: the digest of ``files`` (under
    ``src_dir``) and of the host's CPU."""
    src = b"".join((src_dir / f).read_bytes() for f in files)
    digest = hashlib.sha256(src + host_cpu()).hexdigest()[:16]
    return BUILD_DIR / f"{stem}-{digest}.so"


def build(src_dir: Path, stem: str, files: tuple[str, ...]) -> Path:
    """Build the library if these sources have no build for this host yet;
    raises ``RuntimeError`` with make's output if ``make`` fails. Returns
    its path. Parallel builders each write a file of their own and rename
    it into place."""
    so = library_path(src_dir, stem, files)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    # TARGET on the command line overrides the Makefile's own (beside the source)
    try:
        proc = subprocess.run([MAKE, "-C", str(src_dir), "-s", "-B", f"TARGET={tmp}"],
                              capture_output=True, text=True, timeout=180)
        code, said = proc.returncode, proc.stdout + proc.stderr
    except (OSError, subprocess.SubprocessError) as e:
        code, said = None, str(e)
    if code != 0 or not tmp.exists():
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{stem} build failed (make exit {code}):\n{said}")
    os.replace(tmp, so)
    return so
