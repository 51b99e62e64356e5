"""What every driver makes from the seed: the networks' weights and the
first episodes, on the device, and the device's description."""

from __future__ import annotations

import math
from typing import Dict

import torch

from perfbench.reference import formation as F

# the init's scale of each layer kind: He for the ReLU trunk, a small actor
# head (the policy starts near its mean), a unit critic head
GAIN = {"actor.head": 0.01, "critic.head": 1.0}


def networks_meta(n: int, hidden):
    """The program's actor and critic modules, shapes only."""
    from gym_formation_tpu_torch.models.networks import GaussianActor, ValueCritic

    with torch.device("meta"):
        return GaussianActor(6 * n, 2, tuple(hidden)), ValueCritic(6 * n * n, tuple(hidden))


def make_weights(n: int, hidden, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Every parameter of the actor and the critic, named as the program
    names them, drawn in one call on the generator's device (float32)."""
    actor, critic = networks_meta(n, hidden)
    shapes = {f"actor.{k}": v.shape for k, v in actor.named_parameters()}
    shapes.update({f"critic.{k}": v.shape for k, v in critic.named_parameters()})
    total = sum(math.prod(s) for s in shapes.values())
    z = torch.randn(total, generator=generator, device=generator.device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes.items():
        k = math.prod(shape)
        x = z[at: at + k].reshape(shape)
        at += k
        if name.endswith("log_std"):
            x = 0.1 * x
        elif len(shape) == 2:
            layer = name.rsplit(".", 1)[0]
            x = x * (GAIN.get(layer, math.sqrt(2.0)) / math.sqrt(shape[1]))
        else:
            x = 0.01 * x
        out[name] = x.contiguous()
    return out


def program_networks(weights: Dict[str, torch.Tensor], n: int, hidden, device):
    """The program's modules holding ``weights``."""
    actor, critic = networks_meta(n, hidden)
    actor, critic = actor.to_empty(device=device), critic.to_empty(device=device)
    for prefix, mod in (("actor.", actor), ("critic.", critic)):
        mod.load_state_dict({k[len(prefix):]: v for k, v in weights.items() if k.startswith(prefix)})
    return actor, critic


def first_episodes(n: int, B: int, t0: int, generator: torch.Generator):
    """The first episodes of B envs, U(−1, 1) positions, landmarks and
    ideal velocity, every env at step ``t0`` of its episode.  Returns the
    program's EnvState and the reference's State."""
    from gym_formation_tpu_torch.core.types import EnvState

    dev = generator.device
    u = torch.rand((B, 4 * n + 2), generator=generator, device=dev, dtype=torch.float32) * 2.0 - 1.0
    apos, lpos, ivel = u[:, : 2 * n].reshape(B, n, 2), u[:, 2 * n: 4 * n].reshape(B, n, 2), u[:, 4 * n:]
    ishape = lpos - lpos.mean(1, keepdim=True)
    landmarks = ishape + apos.mean(1, keepdim=True)
    t = torch.full((B,), int(t0), dtype=torch.int32, device=dev)
    es = EnvState(pos=torch.cat([apos, landmarks], 1).contiguous(),
                  vel=torch.zeros((B, 2 * n, 2), device=dev), c=torch.zeros((B, n, 2), device=dev),
                  ideal_shape=ishape.contiguous(), ideal_vel=ivel.contiguous(), t=t)
    ref = F.State(apos.clone(), torch.zeros_like(apos), ishape.clone(), ivel.clone(), t.to(torch.int64))
    return es, ref


def device_info(device, peak_bytes: int, count: int = 1) -> dict:
    if device.type == "cpu":
        return dict(platform="cpu", kind="cpu", count=count, memory_peak_bytes=int(peak_bytes))
    return dict(platform="gpu", kind=torch.cuda.get_device_name(device), count=count,
                memory_peak_bytes=int(peak_bytes))


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Clock:
    """Timestamps in ms: CUDA events on the stream on a card, the host's
    clock after a sync on the CPU (the tests' path)."""

    def __init__(self, device):
        self.device = device

    def stamp(self):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        import time

        return time.perf_counter() * 1e3

    def elapsed(self, a, b) -> float:
        return a.elapsed_time(b) if self.device.type == "cuda" else b - a


def report_setup(marks):
    """The set-up's phases on standard error: (name, clock) from the start."""
    import sys

    parts = [f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(marks[:-1], marks[1:])]
    print("setup: " + ", ".join(parts), file=sys.stderr, flush=True)
