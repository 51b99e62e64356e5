"""Lightweight gym-compatible space descriptors (numpy only, no gym).

They carry the shape and bounds that trainers read; ``sample`` draws from a
``numpy.random.Generator``.
"""

from __future__ import annotations

from typing import Sequence, Tuple as TTuple

import numpy as np


class Space:
    shape: TTuple[int, ...] = ()
    dtype = np.float32

    def sample(self, rng: np.random.Generator):
        raise NotImplementedError

    def contains(self, x) -> bool:
        raise NotImplementedError


class Box(Space):
    def __init__(self, low, high, shape=None, dtype=np.float32):
        if shape is None:
            shape = np.broadcast(np.asarray(low), np.asarray(high)).shape
        self.shape = tuple(shape)
        self.low = np.broadcast_to(np.asarray(low, dtype), self.shape)
        self.high = np.broadcast_to(np.asarray(high, dtype), self.shape)
        self.dtype = dtype

    def sample(self, rng: np.random.Generator):
        lo = np.where(np.isfinite(self.low), self.low, -1.0)
        hi = np.where(np.isfinite(self.high), self.high, 1.0)
        return rng.uniform(lo, hi, self.shape).astype(np.float32)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return x.shape == self.shape and bool(
            np.all(x >= self.low - 1e-6) and np.all(x <= self.high + 1e-6)
        )

    def __repr__(self):
        return f"Box{self.shape}"


class Discrete(Space):
    def __init__(self, n: int):
        self.n = int(n)
        self.shape = ()
        self.dtype = np.int64

    def sample(self, rng: np.random.Generator):
        return int(rng.integers(0, self.n))

    def contains(self, x) -> bool:
        return 0 <= int(x) < self.n

    def __repr__(self):
        return f"Discrete({self.n})"


class Tuple(Space):
    def __init__(self, spaces: Sequence[Space]):
        self.spaces = tuple(spaces)

    def sample(self, rng: np.random.Generator):
        return tuple(s.sample(rng) for s in self.spaces)

    def contains(self, x) -> bool:
        return len(x) == len(self.spaces) and all(
            s.contains(v) for s, v in zip(self.spaces, x)
        )

    def __repr__(self):
        return f"Tuple({list(self.spaces)})"


class MultiDiscrete(Space):
    """[min, max] integer-pair space of the old gym's MultiDiscrete."""

    def __init__(self, array_of_param_array):
        arr = np.asarray(array_of_param_array)
        self.low = arr[:, 0].astype(np.int64)
        self.high = arr[:, 1].astype(np.int64)
        self.num_discrete_space = self.low.shape[0]
        self.shape = (self.num_discrete_space,)
        self.dtype = np.int64

    @property
    def n(self) -> int:
        return int(np.sum(self.high - self.low + 1))

    def sample(self, rng: np.random.Generator):
        return rng.integers(self.low, self.high + 1)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return (
            x.shape == self.shape
            and bool(np.all(x >= self.low))
            and bool(np.all(x <= self.high))
        )

    def __repr__(self):
        return f"MultiDiscrete({self.num_discrete_space})"
