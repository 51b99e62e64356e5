"""Build and load the port's CUDA kernels.

Every ``*.cu`` file under ``gym_formation_tpu_torch/csrc/`` is compiled by
``nvcc`` for Hopper (``sm_90a``), one ``nvcc`` process per file, all started
together, and the objects are linked into one shared library with a plain C
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
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
# C signature of every launcher in csrc/: pointers and the stream as void*,
# so ctypes passes 64-bit values.  Each launcher returns cudaGetLastError().
SIGNATURES = {
    # pos, force, B, E, k, invk, cf, dmin, stream
    "pairforce_sym_launch": (_P, _P, _I, _I, _F, _F, _F, _F, _P),
    # pos, ent, force, B, E, k, cf, stream
    "pairforce_launch": (_P, _P, _P, _I, _I, _F, _F, _P),
    # pos, ent, force, pairs, B, E, k, cf, cell width, stream
    "pairforce_cull_launch": (_P, _P, _P, _P, _I, _I, _F, _F, _F, _P),
    # apos, ishape, mask, haus_fb, ncoll_fb, haus, ncoll, B, N, R, smem,
    # thresh2, stream
    "reward_sym_launch": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    # apos, ishape, haus, ncoll, B, N, R, smem, thresh2, stream
    "reward_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    # apos, avel, aforce, ishape, ivel, npos, nvel, haus, ncoll, B, N,
    # pos_bstride, vel_bstride, L, post, k, invk, cf, dmin, thresh2, keep,
    # fscale, dt, max_speed, act_scale, stream
    "fused_step_launch": (_P,) * 9 + (_I,) * 6 + (_F,) * 10 + (_P,),
    # ap, av, ishape, ivel, t (in), ap, av, ishape, ivel, t, reward (out), B,
    # n, T, ep_len, G, threads, grid, seed, sens, dmin, thresh2, cf, margin,
    # invk, keep, dt, stream
    "fused_rollout_launch": (_P,) * 11 + (_I,) * 7 + (_U,) + (_F,) * 8 + (_P,),
    # n, G, threads -> K4's blocks an SM
    "fused_rollout_plan": (_I, _I, _I),
    # mode, first index, count, out [2] (mismatches, operands in range), stream
    "rn_fast_check_launch": (_I, ctypes.c_ulonglong, ctypes.c_ulonglong, _P, _P),
    # ap, av, ishape, ivel, t (in), 7 actor + 6 critic operands, ap, av,
    # ishape, ivel, t (out), obs, act, logp, value, reward, done, B, n, T,
    # ep_len, E, G, smem, seed, sens, dmin, thresh2, cf, margin, invk, keep,
    # dt, stream
    "fused_collect_launch": (_P,) * 29 + (_I,) * 7 + (_U,) + (_F,) * 8 + (_P,),
    # n, E, smem -> K5's blocks an SM
    "fused_collect_plan": (_I, _I, _I),
    # obs, act, lpo, adv, vold, tgt, 7 actor + 6 critic operands, part_a,
    # part_c, Ma, M, DO, DC, A, Ga, Gc, Sa, Sc, clip_eps, huber_delta,
    # value_coef, inv_ma, inv_mc, stream
    "fused_ppo_grad_launch": (_P,) * 21 + (_I,) * 9 + (_F,) * 5 + (_P,),
    # K (a role's input width), actor, out: stages -> K9's blocks an SM
    "fused_ppo_grad_plan": (_I, _I, ctypes.POINTER(_I)),
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
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    tmp = out.with_suffix(f".{tag}")
    jobs = []
    try:
        for src in sorted(CSRC.glob("*.cu")):
            obj = out.parent / f"{src.stem}.{tag}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            jobs.append((cmd, obj, proc))
        logs, failed = [], []
        for cmd, _, proc in jobs:  # wait for every compile, failed or not
            _, err = proc.communicate()
            logs.append(err)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    finally:  # a failed build leaves no objects and no half-linked library
        for _, obj, proc in jobs:
            proc.kill()  # a no-op once it has exited
            proc.wait()
            obj.unlink(missing_ok=True)
        tmp.unlink(missing_ok=True)
    ptxas = "".join(logs)
    (out.parent / "ptxas.log").write_text(ptxas)
    build_info.update(cached=False, seconds=time.perf_counter() - t0, ptxas=ptxas)
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
