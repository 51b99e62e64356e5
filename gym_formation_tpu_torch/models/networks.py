"""The MAPPO networks in PyTorch.

Counterpart of ``gym_formation_tpu/models/networks.py`` (the parts MAPPO
uses): a ReLU MLP trunk with orthogonal init, the diagonal-Gaussian actor
with a state-independent, soft-bounded log-std, and the centralized value
critic.  Layer names follow flax's (``MLP_0/Dense_k``, ``Dense_0`` for the
head, ``log_std``), so that :func:`actor_from_flax` / :func:`critic_from_flax`
and their inverses carry weights across the two packages.  flax stores a
Dense kernel as ``[in, out]``; ``nn.Linear.weight`` is ``[out, in]``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

_LOG_2PI = math.log(2.0 * math.pi)


def soft_bound(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Smoothly bound ``x`` to (lo, hi) with a nonzero gradient everywhere."""
    sp = torch.nn.functional.softplus
    return hi - sp(hi - (lo + sp(x - lo)))


def _linear(fan_in: int, fan_out: int, gain: float, generator: Optional[torch.Generator]) -> nn.Linear:
    """Dense layer with orthogonal weights of the given gain and zero bias
    (flax ``nn.initializers.orthogonal`` and the default zero bias)."""
    lin = nn.Linear(fan_in, fan_out)
    with torch.no_grad():
        nn.init.orthogonal_(lin.weight, gain=gain, generator=generator)
        lin.bias.zero_()
    return lin


class MLP(nn.Module):
    """ReLU trunk: ``Dense → relu`` per hidden width."""

    def __init__(self, in_dim: int, features: Sequence[int], generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = [in_dim, *features]
        self.layers = nn.ModuleList(
            _linear(a, b, math.sqrt(2.0), generator) for a, b in zip(dims[:-1], dims[1:])
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for lin in self.layers:
            x = torch.relu(lin(x))
        return x


class GaussianActor(nn.Module):
    """Diagonal Gaussian policy: ``obs → (mean, log_std)``, the log-std a
    learned, state-independent parameter soft-bounded to (-5, 2)."""

    def __init__(self, obs_dim: int, act_dim: int, hidden: Sequence[int] = (64, 64),
                 generator: Optional[torch.Generator] = None, log_std_init: float = 0.0):
        super().__init__()
        self.mlp = MLP(obs_dim, hidden, generator)
        self.head = _linear(hidden[-1], act_dim, 0.01, generator)
        self.log_std = nn.Parameter(torch.full((act_dim,), float(log_std_init)))

    def bounded_log_std(self) -> torch.Tensor:
        return soft_bound(self.log_std, -5.0, 2.0)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mean = self.head(self.mlp(obs))
        return mean, self.bounded_log_std().expand_as(mean)


class ValueCritic(nn.Module):
    """Centralized value head: ``share_obs [..., N·do] → value [...]``."""

    def __init__(self, in_dim: int, hidden: Sequence[int] = (64, 64),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mlp = MLP(in_dim, hidden, generator)
        self.head = _linear(hidden[-1], 1, 1.0, generator)

    def forward(self, share_obs: torch.Tensor) -> torch.Tensor:
        return self.head(self.mlp(share_obs)).squeeze(-1)


def gaussian_logp(mean: torch.Tensor, log_std: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """Diagonal-Gaussian log density, summed over the action dims."""
    var = torch.exp(2 * log_std)
    return (-0.5 * ((action - mean) ** 2 / var) - log_std - 0.5 * _LOG_2PI).sum(-1)


def gaussian_entropy(log_std: torch.Tensor) -> torch.Tensor:
    return (log_std + 0.5 * math.log(2 * math.pi * math.e)).sum(-1)


def gaussian_sample(generator: torch.Generator, mean: torch.Tensor, log_std: torch.Tensor) -> torch.Tensor:
    noise = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
    return mean + torch.exp(log_std) * noise


# -- weight carry-over with the flax param trees -----------------------------

def _mlp_from_flax(mlp: MLP, tree: Dict) -> None:
    for k, lin in enumerate(mlp.layers):
        d = tree[f"Dense_{k}"]
        lin.weight.copy_(torch.as_tensor(np.array(d["kernel"]).T))
        lin.bias.copy_(torch.as_tensor(np.array(d["bias"])))


def flax_path(name: str) -> Tuple[str, ...]:
    """The flax param path of a parameter of :class:`GaussianActor` /
    :class:`ValueCritic`: ``mlp.layers.1.weight`` → ``(MLP_0, Dense_1,
    kernel)``, ``head.bias`` → ``(Dense_0, bias)``, ``log_std``."""
    parts = name.split(".")
    leaf = {"weight": "kernel", "bias": "bias"}
    if parts[0] == "mlp":
        return ("MLP_0", f"Dense_{parts[2]}", leaf[parts[3]])
    if parts[0] == "head":
        return ("Dense_0", leaf[parts[1]])
    return (name,)


def to_flax_tree(named: Dict[str, torch.Tensor]) -> Dict:
    """Tensors keyed by parameter name (the parameters themselves, or their
    gradients) → the flax param tree, numpy leaves, Dense kernels
    transposed to ``[in, out]``."""
    tree: Dict = {}
    for name, t in named.items():
        path = flax_path(name)
        a = t.detach().cpu().numpy()
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = (a.T if path[-1] == "kernel" else a).copy()
    return {"params": tree}


def _dense_shapes(tree: Dict):
    p = tree["params"]
    mlp = p["MLP_0"]
    kernels = [np.asarray(mlp[f"Dense_{k}"]["kernel"]) for k in range(len(mlp))]
    return kernels[0].shape[0], tuple(k.shape[1] for k in kernels), np.asarray(p["Dense_0"]["kernel"]).shape[1]


def actor_from_flax(tree: Dict, dtype: torch.dtype = torch.float32, device=None) -> GaussianActor:
    """A :class:`GaussianActor` holding the weights of a flax
    ``GaussianActor`` param tree (nested dicts of arrays)."""
    in_dim, hidden, act_dim = _dense_shapes(tree)
    actor = GaussianActor(in_dim, act_dim, hidden).to(dtype)
    p = tree["params"]
    with torch.no_grad():
        _mlp_from_flax(actor.mlp, p["MLP_0"])
        actor.head.weight.copy_(torch.as_tensor(np.array(p["Dense_0"]["kernel"]).T))
        actor.head.bias.copy_(torch.as_tensor(np.array(p["Dense_0"]["bias"])))
        actor.log_std.copy_(torch.as_tensor(np.array(p["log_std"])))
    return actor.to(device)


def critic_from_flax(tree: Dict, dtype: torch.dtype = torch.float32, device=None) -> ValueCritic:
    """A :class:`ValueCritic` holding the weights of a flax ``ValueCritic``
    param tree."""
    in_dim, hidden, _ = _dense_shapes(tree)
    critic = ValueCritic(in_dim, hidden).to(dtype)
    p = tree["params"]
    with torch.no_grad():
        _mlp_from_flax(critic.mlp, p["MLP_0"])
        critic.head.weight.copy_(torch.as_tensor(np.array(p["Dense_0"]["kernel"]).T))
        critic.head.bias.copy_(torch.as_tensor(np.array(p["Dense_0"]["bias"])))
    return critic.to(device)


def actor_to_flax(actor: GaussianActor) -> Dict:
    """The flax param tree of ``actor`` (numpy leaves)."""
    return to_flax_tree(dict(actor.named_parameters()))


def critic_to_flax(critic: ValueCritic) -> Dict:
    """The flax param tree of ``critic`` (numpy leaves)."""
    return to_flax_tree(dict(critic.named_parameters()))
