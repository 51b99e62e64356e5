"""Build and load the port's CUDA kernels.

Every ``*.cu`` file under ``gym_formation_tpu_torch/csrc/`` is compiled by
``nvcc`` for Hopper (``sm_90a``) into one shared library with a plain C
interface, which is loaded with ``ctypes``.  No PyTorch header is included,
so a build takes seconds.  The library lands in ``build/kernels/<hash>/`` at
the repository root, keyed by a hash of the sources and flags, and is built
at first use: a fresh checkout needs nothing but ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every launcher in csrc/: pointers and the stream as void*,
# so ctypes passes 64-bit values.  Each returns cudaGetLastError().
SIGNATURES = {
    # pos, force, B, E, k, invk, cf, dmin, stream
    "pairforce_sym_launch": (_P, _P, _I, _I, _F, _F, _F, _F, _P),
    # apos, ishape, haus, ncoll, B, N, thresh2, stream
    "reward_sym_launch": (_P, _P, _P, _P, _I, _I, _F, _P),
}

_lib = None
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for f in _sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "libgft_kernels.so"


def build() -> Path:
    """Compile the sources unless a library for them already exists.
    Raises ``RuntimeError`` with nvcc's output if the build fails."""
    out = library_path()
    if out.exists():
        build_info.setdefault("cached", True)
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cu = [str(f) for f in sorted(CSRC.glob("*.cu"))]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *cu]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    (out.parent / "ptxas.log").write_text(proc.stderr)
    build_info.update(
        cached=False, seconds=time.perf_counter() - t0, ptxas=proc.stderr
    )
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        dll = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(dll, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = dll
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {rc}")
