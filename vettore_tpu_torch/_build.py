"""First-use build and ctypes binding of the hand-written CUDA kernels.

``load()`` compiles every ``csrc/*.cu`` with ``nvcc`` for ``sm_90a``, one
``nvcc`` per source started together, and links the objects into
``_build/<sources hash>/libvettore_kernels.so`` beside this file
(git-ignored), once per version of the sources, then returns the loaded
library with its argument types set. The hash covers the name and bytes of
every source and every header they share (``csrc/*.cuh``) and the compiler
flags, so editing any kernel source or header rebuilds. The library links
nothing beyond the CUDA runtime: the TMA tensor maps' encoder, a driver-API
function, is looked up through the runtime's driver entry point.
Nothing here runs at import time: the build happens only when a CUDA tensor
first reaches a kernel wrapper, so the package imports on a machine without
``nvcc``.

``launch`` is the one place where a kernel launch meets a device: every
wrapper launches its kernel through it, with that device made current.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from collections import Counter
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
LIB_NAME = "libvettore_kernels.so"

#: the kernels' compile-time limits, given to nvcc as macros; the wrappers
#: plan their launches within them (the group-major rescore of
#: ``csrc/group_rescore.cuh``: pairs per work item, bytes of one shared-
#: memory ring stage)
LIMITS = {"VT_RESCORE_MAX_WINDOW": 64, "VT_RESCORE_STAGE_BYTES": 32768}

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                 *(f"-D{name}={value}" for name, value in LIMITS.items()))

_lock = threading.Lock()
_lib = None

#: launches per (kernel name, CUDA device index), counted by ``launch``
CARD_LAUNCHES = Counter()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")
    return found


def sources(csrc: Path = CSRC) -> list:
    """The kernel sources (one object each), in a fixed order."""
    return sorted(csrc.glob("*.cu"))


def headers(csrc: Path = CSRC) -> list:
    """The headers the kernel sources share, in a fixed order."""
    return sorted(csrc.glob("*.cuh"))


def build_dir(csrc: Path = CSRC) -> Path:
    """Build directory keyed by a hash of every kernel source and header and
    the flags."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in sources(csrc) + headers(csrc):
        h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    return BUILD_ROOT / h.hexdigest()[:16]


def _run(cmd: list) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True, check=False)


def build() -> Path:
    """Compiles the kernel library unless this version of the sources is
    built; returns its path. ``build.log`` beside it keeps nvcc's output
    (ptxas register and shared-memory usage). Raises with nvcc's stderr on
    failure."""
    out_dir = build_dir()
    lib_path = out_dir / LIB_NAME
    if lib_path.is_file():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag, srcs = _nvcc(), f"{os.getpid()}.tmp", sources()
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in srcs]
    tmp = out_dir / f".{LIB_NAME}.{tag}"
    # one nvcc per source, all at once: the build takes as long as its
    # slowest source however many kernels are added
    with ThreadPoolExecutor(len(srcs)) as pool:
        steps = list(pool.map(_run, ([nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
                                     for src, obj in zip(srcs, objs))))
    if not any(p.returncode for p in steps):
        steps.append(_run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]))
    for obj in objs:
        obj.unlink(missing_ok=True)
    (out_dir / "build.log").write_text(
        "\n".join(" ".join(p.args) + "\n" + p.stdout + p.stderr for p in steps))
    failed = [p for p in steps if p.returncode]
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{' '.join(p.args)} (exit {p.returncode}):\n{p.stderr}" for p in failed))
    os.replace(tmp, lib_path)  # atomic: a concurrent loader never sees half a file
    return lib_path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    signatures = {
        "vt_gmin_scan": [p, i, i, p, p, p, p, i, p, p, i, i, i, i, p],
        "vt_rescore": [p, i, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p],
        "vt_int8_gmin_scan": [p, i, p, p, p, p, i, p, p, p, i, i, i, i, p],
        "vt_int8_rescore": [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p],
        "vt_maxsim_rank_scan": [p, i, i, p, p, p, p, p, i, p, p, i, i, i, i, i, i, i, p],
        "vt_stage_gmin_scan": [p, i, i, p, p, p, p, i, p, p, p, i, i, i, i, p],
        "vt_sign_scan": [p, i, p, p, i, p, p, i, i, i, p],
        "vt_extract_group_rows": [p, p, p, i, i, i, i, p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i
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


def launch(name: str, device: torch.device, *args) -> None:
    """Launches ``vt_<name>`` on ``device`` (a CUDA device with its index)
    and raises with ``name`` if it returned a CUDA error. ``args`` are the
    entry point's arguments before its stream: tensors (passed as their
    data pointers, each on ``device``, else ``ValueError``), integers and
    None. The launch runs with ``device`` current, on its current stream,
    and the caller's current device is restored after it: the C side
    launches, sets kernel attributes and reads the SM count on whatever
    device is current, and CUDA refuses a stream of another device."""
    ptrs = []
    for arg in args:
        if isinstance(arg, torch.Tensor):
            if arg.device != device:
                raise ValueError(f"{name}: operands on {arg.device} and {device}")
            arg = arg.data_ptr()
        ptrs.append(arg)
    entry = getattr(load(), f"vt_{name}")
    with torch.cuda.device(device):
        code = entry(*ptrs, torch.cuda.current_stream(device).cuda_stream)
    check(code, name)
    CARD_LAUNCHES[name, device.index] += 1
