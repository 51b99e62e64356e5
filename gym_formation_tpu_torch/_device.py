"""Device and dtype policy, and the one kernel-dispatch rule of the port.

Every hand-written kernel wrapper asks :func:`use_kernel` which way to go:

- a CUDA tensor launches the kernel (or the wrapper raises);
- a CPU tensor takes the kernel's plain PyTorch version;
- any other device raises.

There is no ``try``/``except`` that falls back from a kernel to its plain
version: a card either runs the kernel or the call fails loudly.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

# State and action tensors default to float32, the working type of the
# kernels.  The plain paths follow the dtype of their inputs, so the tests
# can run them in float64 against the JAX package.
DTYPE = torch.float32


def resolve(device) -> torch.device:
    """The device an entry point runs on.  Entry points default to the card
    (``"cuda"``) and never move to the CPU on their own: without a CUDA
    device this raises, naming ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: pass device="cpu" to run on the CPU')
    return dev


def use_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (take the kernel), False for a CPU tensor
    (take the plain version); raises for any other device."""
    kind = t.device.type
    if kind == "cuda":
        return True
    if kind == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {t.device}")


class _ConstCache:
    """Bounded, content-keyed cache of small constant tensors.

    Per-entity constants of a :class:`WorldCfg` (masses, sizes, masks) are
    numpy arrays.  Copying one to the card on every step would make the
    host wait for the stream each time, so each distinct array is copied
    once per (device, dtype).  The key is the array's bytes, so an array
    edited in place after its first use gets a fresh entry rather than a
    stale one."""

    def __init__(self, maxsize: int = 256):
        self.maxsize = maxsize
        self._d: OrderedDict = OrderedDict()

    def get(self, a: np.ndarray, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
        a = np.ascontiguousarray(a)
        key = (a.tobytes(), a.shape, a.dtype.str, str(device), dtype)
        hit = self._d.get(key)
        if hit is not None:
            self._d.move_to_end(key)
            return hit
        t = torch.as_tensor(a, dtype=dtype).to(device)
        self._d[key] = t
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)
        return t


_consts = _ConstCache()


def const(a, like: torch.Tensor, dtype: torch.dtype = None) -> torch.Tensor:
    """``a`` (numpy) as a tensor on ``like``'s device, in ``dtype`` (default
    ``like.dtype``), copied to the device once and then reused."""
    return _consts.get(np.asarray(a), like.device, like.dtype if dtype is None else dtype)
