"""First-use build and ctypes binding of the hand-written CUDA kernels.

``load()`` compiles ``csrc/flat_scan.cu`` with ``nvcc`` for ``sm_90a`` into
``_build/<source hash>/libvettore_flat.so`` beside this file (git-ignored),
once per source version, and returns the loaded library with its argument
types set. Nothing here runs at import time: the build happens only when a
CUDA tensor first reaches a kernel wrapper, so the package imports on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "flat_scan.cu"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
LIB_NAME = "libvettore_flat.so"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")
    return found


def build_dir() -> Path:
    """Build directory keyed by a hash of the kernel source."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_ROOT / digest


def build() -> Path:
    """Compiles the kernel library unless this source version is built;
    returns its path. ``build.log`` beside it keeps nvcc's output (ptxas
    register and shared-memory usage). Raises with nvcc's stderr on
    failure."""
    out_dir = build_dir()
    lib_path = out_dir / LIB_NAME
    if lib_path.is_file():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}) building {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, lib_path)  # atomic: a concurrent loader never sees half a file
    return lib_path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vt_gmin_scan.argtypes = [p, i, p, p, p, p, p, i, i, i, i, p]
    lib.vt_gmin_scan.restype = i
    lib.vt_rescore.argtypes = [p, i, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.vt_rescore.restype = i
    lib.vt_error_string.argtypes = [i]
    lib.vt_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


def check(code: int, what: str) -> None:
    """Raises if a kernel entry point returned a CUDA error."""
    if code != 0:
        msg = load().vt_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
