"""The learners' networks in PyTorch.

Counterpart of ``gym_formation_tpu/models/networks.py`` and of the networks
the off-policy learners define (``algos/matd3.py: TwinQCritic``,
``algos/masac.py: SquashedGaussianActor``, ``algos/qmix.py: AgentQNet,
QMixer``): a ReLU MLP trunk with orthogonal init, the diagonal-Gaussian
actor with a state-independent, soft-bounded log-std, the logits actor of
the categorical head, the centralized value critic, their per-agent stacked
forms (``share_policy=False``), the GRU actor and critic, and the per-agent
(stacked) networks of the off-policy zoo, which the JAX package builds with
``vmap(init)``: the deterministic actor, the Q critic and its twin, the
tanh-Gaussian actor, and the recurrent zoo's GRU actors (RMADDPG's
:class:`StackedGRUPolicy`, RMASAC's :class:`StackedRecurrentSquashedActor`,
both on :class:`StackedGRUCell`); QMix's agent network is
:class:`LogitsActor` over ``obs ⊕ one-hot id``, RQMix's is
:class:`GRUPolicy` with its logits head, and their mixer :class:`QMixer`.
Parameter names map onto flax's paths (``MLP_0/Dense_k``, ``Dense_0`` for
the head, ``log_std``, ``GRUCell_0``, ``Dense_2`` for the recurrent SAC
actor's log-std head, ``CentralizedQCritic_k`` for a twin head), so that
the ``*_from_flax`` functions and :func:`to_flax` carry weights across the
two packages.  flax stores a Dense kernel as ``[in, out]``;
``nn.Linear.weight`` is ``[out, in]``, and a stacked layer's ``kernel`` is
flax's ``[N, in, out]`` as it is.  A GRU weight holds its three gates along
one axis (axis 1 behind a stacked cell's agent axis), flax one kernel a
gate.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..parallel.mesh import draw_rows

_LOG_2PI = math.log(2.0 * math.pi)


def soft_bound(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Smoothly bound ``x`` to (lo, hi) with a nonzero gradient everywhere."""
    sp = torch.nn.functional.softplus
    return hi - sp(hi - (lo + sp(x - lo)))


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> None:
    """flax's default kernel init: lecun-normal, truncated at two standard
    deviations and rescaled to keep the variance ``1 / fan_in``."""
    std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


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


class LogitsActor(nn.Module):
    """Categorical policy: ``obs → logits`` over ``n_actions``."""

    def __init__(self, obs_dim: int, n_actions: int, hidden: Sequence[int] = (64, 64),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mlp = MLP(obs_dim, hidden, generator)
        self.head = _linear(hidden[-1], n_actions, 0.01, generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.head(self.mlp(obs))


class ValueCritic(nn.Module):
    """Centralized value head: ``share_obs [..., N·do] → value [...]``."""

    def __init__(self, in_dim: int, hidden: Sequence[int] = (64, 64),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mlp = MLP(in_dim, hidden, generator)
        self.head = _linear(hidden[-1], 1, 1.0, generator)

    def forward(self, share_obs: torch.Tensor) -> torch.Tensor:
        return self.head(self.mlp(share_obs)).squeeze(-1)


class StackedDense(nn.Module):
    """N dense layers, one an agent, in one batched product: ``kernel``
    [N, in, out] (flax's layout), ``bias`` [N, out].  The input is
    [..., N, in], or [..., in] shared by every agent (``shared_input``);
    the output [..., N, out]."""

    def __init__(self, n: int, fan_in: int, fan_out: int, gain: float,
                 generator: Optional[torch.Generator] = None, shared_input: bool = False):
        super().__init__()
        self.shared_input = shared_input
        self.kernel = nn.Parameter(torch.empty(n, fan_in, fan_out))
        self.bias = nn.Parameter(torch.zeros(n, fan_out))
        with torch.no_grad():
            for k in self.kernel:
                w = torch.empty(fan_out, fan_in)
                nn.init.orthogonal_(w, gain=gain, generator=generator)
                k.copy_(w.T)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        eq = "...i,nio->...no" if self.shared_input else "...ni,nio->...no"
        return torch.einsum(eq, x, self.kernel) + self.bias


class StackedMLP(nn.Module):
    """:class:`MLP` with one set of weights an agent."""

    def __init__(self, n: int, in_dim: int, features: Sequence[int],
                 generator: Optional[torch.Generator] = None, shared_input: bool = False):
        super().__init__()
        dims = [in_dim, *features]
        self.layers = nn.ModuleList(
            StackedDense(n, a, b, math.sqrt(2.0), generator, shared_input and k == 0)
            for k, (a, b) in enumerate(zip(dims[:-1], dims[1:]))
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for lin in self.layers:
            x = torch.relu(lin(x))
        return x


class StackedActor(nn.Module):
    """Per-agent actors (``share_policy=False``): ``obs [..., N, do]`` →
    ``(mean, log_std)`` [..., N, da], or logits when ``discrete``."""

    def __init__(self, n: int, obs_dim: int, act_dim: int, hidden: Sequence[int] = (64, 64),
                 discrete: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.discrete = discrete
        self.mlp = StackedMLP(n, obs_dim, hidden, generator)
        self.head = StackedDense(n, hidden[-1], act_dim, 0.01, generator)
        if not discrete:
            self.log_std = nn.Parameter(torch.zeros(n, act_dim))

    def forward(self, obs: torch.Tensor):
        out = self.head(self.mlp(obs))
        if self.discrete:
            return out
        return out, soft_bound(self.log_std, -5.0, 2.0).expand_as(out)


class StackedValueCritic(nn.Module):
    """Per-agent critics of the shared observation: ``share_obs [..., N·do]``
    → ``value [..., N]``."""

    def __init__(self, n: int, in_dim: int, hidden: Sequence[int] = (64, 64),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mlp = StackedMLP(n, in_dim, hidden, generator, shared_input=True)
        self.head = StackedDense(n, hidden[-1], 1, 1.0, generator)

    def forward(self, share_obs: torch.Tensor) -> torch.Tensor:
        return self.head(self.mlp(share_obs)).squeeze(-1)


class StackedDeterministicActor(nn.Module):
    """Per-agent DDPG actors: ``obs [..., N, do] → max_action ·
    tanh(head(MLP(obs)))`` [..., N, da]."""

    def __init__(self, n: int, obs_dim: int, act_dim: int, max_action: float = 1.0,
                 hidden: Sequence[int] = (64, 64, 64), generator: Optional[torch.Generator] = None):
        super().__init__()
        self.max_action = max_action
        self.mlp = StackedMLP(n, obs_dim, hidden, generator)
        self.head = StackedDense(n, hidden[-1], act_dim, 0.01, generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.max_action * torch.tanh(self.head(self.mlp(obs)))


class StackedQCritic(nn.Module):
    """Per-agent Q critics: agent i's ``Q_i(obs [..., N, do_in], act [...,
    N, da_in])`` [..., N], the actions scaled by ``1 / max_action`` before
    the concatenation.  A centralized critic takes every agent's
    observations and actions in each row; a local one (DDPG) its own."""

    def __init__(self, n: int, in_dim: int, max_action: float = 1.0, hidden: Sequence[int] = (64, 64, 64),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.max_action = max_action
        self.mlp = StackedMLP(n, in_dim, hidden, generator)
        self.head = StackedDense(n, hidden[-1], 1, 1.0, generator)

    def forward(self, obs: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
        x = torch.cat([obs, act / self.max_action], -1)
        return self.head(self.mlp(x)).squeeze(-1)


class StackedTwinQCritic(nn.Module):
    """Two independent :class:`StackedQCritic` heads on the same input:
    returns ``(q1, q2)``."""

    def __init__(self, n: int, in_dim: int, max_action: float = 1.0, hidden: Sequence[int] = (64, 64, 64),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.q1 = StackedQCritic(n, in_dim, max_action, hidden, generator)
        self.q2 = StackedQCritic(n, in_dim, max_action, hidden, generator)

    def forward(self, obs: torch.Tensor, act: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.q1(obs, act), self.q2(obs, act)


LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


class StackedSquashedGaussianActor(nn.Module):
    """Per-agent SAC actors: ``obs [..., N, do] → (mean, log_std)``, both
    heads on the MLP, the log-std clipped to [LOG_STD_MIN, LOG_STD_MAX]."""

    def __init__(self, n: int, obs_dim: int, act_dim: int, hidden: Sequence[int] = (64, 64, 64),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mlp = StackedMLP(n, obs_dim, hidden, generator)
        self.head = StackedDense(n, hidden[-1], act_dim, 0.01, generator)
        self.log_std_head = StackedDense(n, hidden[-1], act_dim, 0.01, generator)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.mlp(obs)
        return self.head(h), torch.clamp(self.log_std_head(h), LOG_STD_MIN, LOG_STD_MAX)


class QMixer(nn.Module):
    """QMIX's monotonic mixing hypernetwork: the chosen Q's [M, N] mixed
    with weights made positive (``abs``) from the state [M, ds].  The
    hypernet layers keep flax's default init (lecun-normal, zero bias),
    the output layer of ``b2`` orthogonal with gain 1."""

    def __init__(self, n_agents: int, state_dim: int, embed: int = 32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_agents, self.embed = n_agents, embed

        def lecun(fan_out):
            lin = nn.Linear(state_dim, fan_out)
            with torch.no_grad():
                _lecun_normal_(lin.weight, state_dim, generator)
                lin.bias.zero_()
            return lin

        # flax names a layer when it is constructed: in
        # ``Dense(1)(relu(Dense(embed)(state)))`` the output layer of b2 is
        # built first (Dense_3), its inner layer second (Dense_4)
        self.hyper_w1 = lecun(n_agents * embed)
        self.hyper_b1 = lecun(embed)
        self.hyper_w2 = lecun(embed)
        self.hyper_b2_hidden = lecun(embed)
        self.hyper_b2 = _linear(embed, 1, 1.0, generator)

    def forward(self, q_chosen: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
        w1 = self.hyper_w1(state).abs().reshape(-1, self.n_agents, self.embed)
        hidden = torch.nn.functional.elu(torch.einsum("mn,mne->me", q_chosen, w1) + self.hyper_b1(state))
        w2 = self.hyper_w2(state).abs()
        b2 = self.hyper_b2(torch.relu(self.hyper_b2_hidden(state)))
        return (hidden * w2).sum(-1) + b2.squeeze(-1)


class GRUCell(nn.Module):
    """flax's ``GRUCell`` in ``torch.nn.GRUCell``'s layout: ``weight_ih``
    [3H, in] and ``weight_hh`` [3H, H] with the gate rows in (r, z, n)
    order, ``bias_ih`` [3H].  flax has no hidden-side bias on r and z, so
    of ``torch.nn.GRUCell``'s ``bias_hh`` only the n third is a parameter
    (``bias_hn``); the r and z thirds are zero and stay zero:

        r = σ(x W_ir + b_ir + h W_hr),  z = σ(x W_iz + b_iz + h W_hz)
        n = tanh(x W_in + b_in + r · (h W_hn + b_hn)),  h' = (1 − z) n + z h

    Init as flax's: the input kernels lecun-normal (truncated), the hidden
    kernels orthogonal, the biases zero."""

    def __init__(self, in_dim: int, hidden: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        H = hidden
        self.weight_ih = nn.Parameter(torch.empty(3 * H, in_dim))
        self.weight_hh = nn.Parameter(torch.empty(3 * H, H))
        self.bias_ih = nn.Parameter(torch.zeros(3 * H))
        self.bias_hn = nn.Parameter(torch.zeros(H))
        with torch.no_grad():
            _lecun_normal_(self.weight_ih, in_dim, generator)
            for g in range(3):
                w = torch.empty(H, H)
                nn.init.orthogonal_(w, generator=generator)
                self.weight_hh[g * H:(g + 1) * H] = w.T

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        gi = torch.nn.functional.linear(x, self.weight_ih, self.bias_ih)
        gh = torch.nn.functional.linear(h, self.weight_hh)
        ir, iz, in_ = gi.chunk(3, -1)
        hr, hz, hn = gh.chunk(3, -1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = torch.tanh(in_ + r * (hn + self.bias_hn))
        return (1.0 - z) * n + z * h


def _reset_carry(carry: torch.Tensor, reset: Optional[torch.Tensor]) -> torch.Tensor:
    """The carry zeroed where ``reset`` [...] is set (``carry`` [..., H])."""
    return carry if reset is None else torch.where(reset[..., None], 0.0, carry)


class StackedGRUCell(nn.Module):
    """:class:`GRUCell` with one set of weights an agent: ``weight_ih`` [N,
    3H, in], ``weight_hh`` [N, 3H, H], ``bias_ih`` [N, 3H], ``bias_hn`` [N,
    H], the gates in (r, z, n) order; one ``einsum`` a gate matrix over
    ``h`` [..., N, H] and ``x`` [..., N, in].  Each agent's slice is
    initialised as :class:`GRUCell` is."""

    def __init__(self, n: int, in_dim: int, hidden: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        cells = [GRUCell(in_dim, hidden, generator) for _ in range(n)]
        for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hn"):
            self.register_parameter(name, nn.Parameter(torch.stack([getattr(c, name).detach() for c in cells])))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        gi = torch.einsum("...ni,ngi->...ng", x, self.weight_ih) + self.bias_ih
        gh = torch.einsum("...nh,ngh->...ng", h, self.weight_hh)
        ir, iz, in_ = gi.chunk(3, -1)
        hr, hz, hn = gh.chunk(3, -1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = torch.tanh(in_ + r * (hn + self.bias_hn))
        return (1.0 - z) * n + z * h


class _StackedGRUTrunk(nn.Module):
    """``Dense → relu`` embedding, the carry zeroed where ``reset`` is set,
    the GRU cell, and the ``out`` head (flax's ``Dense_0``, ``GRUCell_0``,
    ``Dense_1``), one set of weights an agent."""

    def __init__(self, n: int, obs_dim: int, act_dim: int, hidden: int, generator: Optional[torch.Generator]):
        super().__init__()
        self.hidden = hidden
        self.embed = StackedDense(n, obs_dim, hidden, math.sqrt(2.0), generator)
        self.gru = StackedGRUCell(n, hidden, hidden, generator)
        self.out = StackedDense(n, hidden, act_dim, 0.01, generator)

    def _cell(self, carry: torch.Tensor, obs: torch.Tensor, reset: Optional[torch.Tensor]) -> torch.Tensor:
        return self.gru(_reset_carry(carry, reset), torch.relu(self.embed(obs)))


class StackedGRUPolicy(_StackedGRUTrunk):
    """Per-agent recurrent actors (RMADDPG's, the JAX package's ``GRUPolicy``
    initialised by ``vmap`` over the agents): ``obs [..., N, do]``, the
    carry [..., N, H] and ``reset`` [..., N] (or None) → ``(carry, (mean,
    log_std))`` [..., N, da].  The log-std is soft-bounded to (−5, 2), kept
    so that the tree round-trips (RMADDPG takes only the mean)."""

    def __init__(self, n: int, obs_dim: int, act_dim: int, hidden: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__(n, obs_dim, act_dim, hidden, generator)
        self.log_std = nn.Parameter(torch.zeros(n, act_dim))

    def forward(self, carry: torch.Tensor, obs: torch.Tensor, reset: Optional[torch.Tensor] = None):
        carry = self._cell(carry, obs, reset)
        mean = self.out(carry)
        return carry, (mean, soft_bound(self.log_std, -5.0, 2.0).expand_as(mean))


class StackedRecurrentSquashedActor(_StackedGRUTrunk):
    """Per-agent recurrent SAC actors (the JAX package's
    ``RecurrentSquashedActor`` stacked over the agents): the mean head and
    the log-std head (flax's ``Dense_1`` and ``Dense_2``) on the GRU, the
    log-std clipped to [LOG_STD_MIN, LOG_STD_MAX]."""

    def __init__(self, n: int, obs_dim: int, act_dim: int, hidden: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__(n, obs_dim, act_dim, hidden, generator)
        self.log_std_out = StackedDense(n, hidden, act_dim, 0.01, generator)

    def forward(self, carry: torch.Tensor, obs: torch.Tensor, reset: Optional[torch.Tensor] = None):
        carry = self._cell(carry, obs, reset)
        return carry, (self.out(carry), torch.clamp(self.log_std_out(carry), LOG_STD_MIN, LOG_STD_MAX))


class GRUPolicy(nn.Module):
    """Recurrent actor: ``Dense → relu`` embedding, the carry zeroed where
    ``reset`` is set (before the cell), the GRU cell, then a Gaussian head
    (``(mean, log_std)``, log-std soft-bounded to (−5, 2)) or, when
    ``discrete``, logits."""

    def __init__(self, obs_dim: int, act_dim: int, hidden: int = 64, discrete: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden, self.discrete = hidden, discrete
        self.embed = _linear(obs_dim, hidden, math.sqrt(2.0), generator)
        self.gru = GRUCell(hidden, hidden, generator)
        self.out = _linear(hidden, act_dim, 0.01, generator)
        if not discrete:
            self.log_std = nn.Parameter(torch.zeros(act_dim))

    def forward(self, carry: torch.Tensor, obs: torch.Tensor, reset: Optional[torch.Tensor] = None):
        """One step: carry [..., H], obs [..., do], reset [...] bool (None:
        no env starts an episode).  Returns ``(new carry, dist)``."""
        x = torch.relu(self.embed(obs))
        carry = self.gru(_reset_carry(carry, reset), x)
        out = self.out(carry)
        if self.discrete:
            return carry, out
        return carry, (out, soft_bound(self.log_std, -5.0, 2.0).expand_as(out))


class GRUCritic(nn.Module):
    """Recurrent centralized value: ``share_obs → Dense+relu → GRU → V``."""

    def __init__(self, in_dim: int, hidden: int = 64, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden = hidden
        self.embed = _linear(in_dim, hidden, math.sqrt(2.0), generator)
        self.gru = GRUCell(hidden, hidden, generator)
        self.out = _linear(hidden, 1, 1.0, generator)

    def forward(self, carry: torch.Tensor, share_obs: torch.Tensor, reset: torch.Tensor):
        x = torch.relu(self.embed(share_obs))
        carry = self.gru(torch.where(reset[..., None], 0.0, carry), x)
        return carry, self.out(carry).squeeze(-1)


def onehot_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """Greedy one-hot over the last axis."""
    return torch.nn.functional.one_hot(logits.argmax(-1), logits.shape[-1]).to(logits.dtype)


def gumbel(generator: torch.Generator, shape, dtype: torch.dtype, device, mesh=None) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, ``u`` uniform on [tiny, 1)
    (``jax.random.gumbel``'s range); under a data-parallel ``mesh`` drawn at
    the global batch's shape and cut to the rank's rows."""
    u = draw_rows(lambda s: torch.rand(s, generator=generator, dtype=dtype, device=device), shape, mesh)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(dtype).tiny)))


def gumbel_softmax_st(noise: torch.Tensor, logits: torch.Tensor, tau: float = 1.0) -> torch.Tensor:
    """Straight-through Gumbel-softmax on the Gumbel ``noise``: the hard
    one-hot of ``softmax((logits + noise) / tau)`` forward, the softmax's
    gradient backward."""
    y = torch.softmax((logits + noise) / tau, -1)
    return onehot_from_logits(y) + y - y.detach()


def categorical_logp(logits: torch.Tensor, action_onehot: torch.Tensor) -> torch.Tensor:
    """log π(a|s) of a one-hot action over the last axis."""
    return (torch.log_softmax(logits, -1) * action_onehot).sum(-1)


def categorical_entropy(logits: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, -1)
    return -(torch.exp(logp) * logp).sum(-1)


def categorical_sample(generator: torch.Generator, logits: torch.Tensor, mesh=None) -> torch.Tensor:
    """A one-hot sample over the last axis (Gumbel-max, as
    ``jax.random.categorical`` draws); the draws at the global batch's
    shape under a data-parallel ``mesh``."""
    u = draw_rows(lambda s: torch.rand(s, generator=generator, device=logits.device, dtype=logits.dtype),
                  logits.shape, mesh)
    gumbel = -torch.log(-torch.log(u))
    return onehot_from_logits(logits + gumbel)


def gaussian_logp(mean: torch.Tensor, log_std: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """Diagonal-Gaussian log density, summed over the action dims."""
    var = torch.exp(2 * log_std)
    return (-0.5 * ((action - mean) ** 2 / var) - log_std - 0.5 * _LOG_2PI).sum(-1)


def gaussian_entropy(log_std: torch.Tensor) -> torch.Tensor:
    return (log_std + 0.5 * math.log(2 * math.pi * math.e)).sum(-1)


def gaussian_sample(generator: torch.Generator, mean: torch.Tensor, log_std: torch.Tensor,
                    mesh=None) -> torch.Tensor:
    """``mean + σ·ε``; the normals at the global batch's shape under a
    data-parallel ``mesh``."""
    noise = draw_rows(lambda s: torch.randn(s, generator=generator, device=mean.device, dtype=mean.dtype),
                      mean.shape, mesh)
    return mean + torch.exp(log_std) * noise


# -- weight carry-over with the flax param trees -----------------------------

# the flax module of each top-level submodule name
_FLAX_MODULE = {"mlp": "MLP_0", "head": "Dense_0", "embed": "Dense_0", "out": "Dense_1",
                "gru": "GRUCell_0", "log_std_head": "Dense_1", "log_std_out": "Dense_2",
                "hyper_w1": "Dense_0", "hyper_b1": "Dense_1", "hyper_w2": "Dense_2",
                "hyper_b2": "Dense_3", "hyper_b2_hidden": "Dense_4"}
# submodules that hold a whole flax module of their own (a twin critic's heads)
_FLAX_SCOPE = {"q1": "CentralizedQCritic_0", "q2": "CentralizedQCritic_1"}
# flax's GRUCell gates in torch's row order (r, z, n), input side and hidden side
_GATES = {"weight_ih": ("ir", "iz", "in"), "bias_ih": ("ir", "iz", "in"), "weight_hh": ("hr", "hz", "hn")}


def _flax_leaves(name: str, a: np.ndarray):
    """The (flax path, leaf) pairs of the parameter ``name`` holding ``a``:
    ``mlp.layers.1.weight`` → ``(MLP_0, Dense_1, kernel)`` transposed,
    ``head.bias`` → ``(Dense_0, bias)``, a stacked ``kernel`` as it is,
    ``log_std``; a GRU weight splits into its three gates;
    ``q1.head.bias`` → ``(CentralizedQCritic_0, Dense_0, bias)``."""
    scope, _, rest = name.partition(".")
    if scope in _FLAX_SCOPE:
        return [((_FLAX_SCOPE[scope],) + path, x) for path, x in _flax_leaves(rest, a)]
    parts = name.split(".")
    top = _FLAX_MODULE.get(parts[0])
    if top is None:
        return [((name,), a)]
    if parts[0] == "gru":
        leaf = parts[1]
        if leaf == "bias_hn":
            return [((top, "hn", "bias"), a)]
        kind = "bias" if leaf == "bias_ih" else "kernel"
        # the gate axis: 0, or 1 behind a stacked cell's agent axis
        axis = a.ndim - (1 if kind == "bias" else 2)
        gates = np.split(a, 3, axis)
        return [((top, g, kind), np.swapaxes(x, -1, -2) if kind == "kernel" else x)
                for x, g in zip(gates, _GATES[leaf])]
    mod = (top, f"Dense_{parts[2]}") if parts[0] == "mlp" else (top,)
    leaf = parts[-1]
    if leaf == "weight":  # nn.Linear [out, in] → flax [in, out]
        return [(mod + ("kernel",), a.T)]
    return [(mod + (leaf,), a)]


def _from_flax_leaf(name: str, p: Dict) -> np.ndarray:
    """Inverse of :func:`_flax_leaves`: parameter ``name`` in the port's
    layout, read from the flax ``params`` dict ``p``."""
    scope, _, rest = name.partition(".")
    if scope in _FLAX_SCOPE:
        return _from_flax_leaf(rest, p[_FLAX_SCOPE[scope]])
    get = lambda path: np.array(functools.reduce(lambda t, k: t[k], path, p))
    parts = name.split(".")
    top = _FLAX_MODULE.get(parts[0])
    if top is None:
        return get((name,))
    if parts[0] == "gru":
        leaf = parts[1]
        if leaf == "bias_hn":
            return get((top, "hn", "bias"))
        kind = "bias" if leaf == "bias_ih" else "kernel"
        xs = [get((top, g, kind)) for g in _GATES[leaf]]
        if kind == "kernel":
            xs = [np.swapaxes(x, -1, -2) for x in xs]
        return np.concatenate(xs, xs[0].ndim - (1 if kind == "bias" else 2))
    mod = (top, f"Dense_{parts[2]}") if parts[0] == "mlp" else (top,)
    leaf = parts[-1]
    if leaf == "weight":
        return get(mod + ("kernel",)).T
    return get(mod + (leaf,))


def to_flax_tree(named: Dict[str, torch.Tensor]) -> Dict:
    """Tensors keyed by parameter name (the parameters themselves, or their
    gradients) → the flax param tree with numpy leaves."""
    tree: Dict = {}
    for name, t in named.items():
        for path, a in _flax_leaves(name, t.detach().cpu().numpy()):
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = a.copy()
    return {"params": tree}


def to_flax(module: nn.Module) -> Dict:
    """The flax param tree of any network of this module (numpy leaves)."""
    return to_flax_tree(dict(module.named_parameters()))



def _load_flax(module: nn.Module, tree: Dict, dtype: torch.dtype, device) -> nn.Module:
    module = module.to(dtype)
    with torch.no_grad():
        for name, param in module.named_parameters():
            param.copy_(torch.as_tensor(_from_flax_leaf(name, tree["params"])))
    return module.to(device)


def _kernel(p: Dict, *path) -> np.ndarray:
    return np.asarray(functools.reduce(lambda t, k: t[k], path + ("kernel",), p))


def _mlp_dims(p: Dict) -> Tuple[int, Tuple[int, ...], int]:
    """(input width, hidden widths, head width) of an MLP_0 + Dense_0 tree
    (the last two axes of each kernel, so stacked trees too)."""
    mlp = p["MLP_0"]
    kernels = [_kernel(mlp, f"Dense_{k}") for k in range(len(mlp))]
    return kernels[0].shape[-2], tuple(k.shape[-1] for k in kernels), _kernel(p, "Dense_0").shape[-1]


def actor_from_flax(tree: Dict, dtype: torch.dtype = torch.float32, device=None) -> GaussianActor:
    """A :class:`GaussianActor` holding a flax ``GaussianActor`` tree."""
    in_dim, hidden, act_dim = _mlp_dims(tree["params"])
    return _load_flax(GaussianActor(in_dim, act_dim, hidden), tree, dtype, device)


def logits_actor_from_flax(tree: Dict, dtype: torch.dtype = torch.float32, device=None) -> LogitsActor:
    """A :class:`LogitsActor` holding a flax ``LogitsActor`` tree."""
    in_dim, hidden, n_actions = _mlp_dims(tree["params"])
    return _load_flax(LogitsActor(in_dim, n_actions, hidden), tree, dtype, device)


def critic_from_flax(tree: Dict, dtype: torch.dtype = torch.float32, device=None) -> ValueCritic:
    """A :class:`ValueCritic` holding a flax ``ValueCritic`` tree."""
    in_dim, hidden, _ = _mlp_dims(tree["params"])
    return _load_flax(ValueCritic(in_dim, hidden), tree, dtype, device)


def stacked_actor_from_flax(tree: Dict, dtype: torch.dtype = torch.float32, device=None) -> StackedActor:
    """A :class:`StackedActor` holding the per-agent actors of the JAX
    package's ``share_policy=False`` (a vmapped init: every leaf has a
    leading agent axis); the head is Gaussian where the tree has a
    ``log_std``, else logits."""
    p = tree["params"]
    in_dim, hidden, act_dim = _mlp_dims(p)
    n = _kernel(p, "Dense_0").shape[0]
    return _load_flax(StackedActor(n, in_dim, act_dim, hidden, discrete="log_std" not in p),
                      tree, dtype, device)


def stacked_critic_from_flax(tree: Dict, dtype: torch.dtype = torch.float32, device=None) -> StackedValueCritic:
    """A :class:`StackedValueCritic` holding the per-agent critics."""
    p = tree["params"]
    in_dim, hidden, _ = _mlp_dims(p)
    return _load_flax(StackedValueCritic(_kernel(p, "Dense_0").shape[0], in_dim, hidden),
                      tree, dtype, device)


def gru_policy_from_flax(tree: Dict, dtype: torch.dtype = torch.float32, device=None) -> GRUPolicy:
    """A :class:`GRUPolicy` holding a flax ``GRUPolicy`` tree (the logits
    head where the tree has no ``log_std``)."""
    p = tree["params"]
    obs_dim, hidden = _kernel(p, "Dense_0").shape
    act_dim = _kernel(p, "Dense_1").shape[1]
    return _load_flax(GRUPolicy(obs_dim, act_dim, hidden, discrete="log_std" not in p), tree, dtype, device)


def stacked_gru_policy_from_flax(tree: Dict, dtype: torch.dtype = torch.float32,
                                 device=None) -> StackedGRUPolicy:
    """A :class:`StackedGRUPolicy` holding RMADDPG's per-agent ``GRUPolicy``
    tree (leaves [N, ...])."""
    n, obs_dim, hidden = _kernel(tree["params"], "Dense_0").shape
    act_dim = _kernel(tree["params"], "Dense_1").shape[-1]
    return _load_flax(StackedGRUPolicy(n, obs_dim, act_dim, hidden), tree, dtype, device)


def recurrent_squashed_actor_from_flax(tree: Dict, dtype: torch.dtype = torch.float32,
                                       device=None) -> StackedRecurrentSquashedActor:
    """A :class:`StackedRecurrentSquashedActor` holding RMASAC's per-agent
    ``RecurrentSquashedActor`` tree."""
    n, obs_dim, hidden = _kernel(tree["params"], "Dense_0").shape
    act_dim = _kernel(tree["params"], "Dense_1").shape[-1]
    return _load_flax(StackedRecurrentSquashedActor(n, obs_dim, act_dim, hidden), tree, dtype, device)


def gru_critic_from_flax(tree: Dict, dtype: torch.dtype = torch.float32, device=None) -> GRUCritic:
    """A :class:`GRUCritic` holding a flax ``GRUCritic`` tree."""
    in_dim, hidden = _kernel(tree["params"], "Dense_0").shape
    return _load_flax(GRUCritic(in_dim, hidden), tree, dtype, device)


def deterministic_actor_from_flax(tree: Dict, max_action: float = 1.0, dtype: torch.dtype = torch.float32,
                                  device=None) -> StackedDeterministicActor:
    """A :class:`StackedDeterministicActor` holding the JAX package's
    per-agent ``DeterministicActor`` tree (leaves [N, ...])."""
    p = tree["params"]
    in_dim, hidden, act_dim = _mlp_dims(p)
    n = _kernel(p, "Dense_0").shape[0]
    return _load_flax(StackedDeterministicActor(n, in_dim, act_dim, max_action, hidden), tree, dtype, device)


def q_critic_from_flax(tree: Dict, max_action: float = 1.0, dtype: torch.dtype = torch.float32,
                       device=None) -> StackedQCritic:
    """A :class:`StackedQCritic` holding the per-agent
    ``CentralizedQCritic`` tree (centralized or local widths)."""
    p = tree["params"]
    in_dim, hidden, _ = _mlp_dims(p)
    n = _kernel(p, "Dense_0").shape[0]
    return _load_flax(StackedQCritic(n, in_dim, max_action, hidden), tree, dtype, device)


def twin_q_critic_from_flax(tree: Dict, max_action: float = 1.0, dtype: torch.dtype = torch.float32,
                            device=None) -> StackedTwinQCritic:
    """A :class:`StackedTwinQCritic` holding the per-agent ``TwinQCritic``
    tree of MATD3 and MASAC."""
    p = tree["params"]["CentralizedQCritic_0"]
    in_dim, hidden, _ = _mlp_dims(p)
    n = _kernel(p, "Dense_0").shape[0]
    return _load_flax(StackedTwinQCritic(n, in_dim, max_action, hidden), tree, dtype, device)


def squashed_actor_from_flax(tree: Dict, dtype: torch.dtype = torch.float32,
                             device=None) -> StackedSquashedGaussianActor:
    """A :class:`StackedSquashedGaussianActor` holding the per-agent
    ``SquashedGaussianActor`` tree of MASAC."""
    p = tree["params"]
    in_dim, hidden, act_dim = _mlp_dims(p)
    n = _kernel(p, "Dense_0").shape[0]
    return _load_flax(StackedSquashedGaussianActor(n, in_dim, act_dim, hidden), tree, dtype, device)


def qmixer_from_flax(tree: Dict, dtype: torch.dtype = torch.float32, device=None) -> QMixer:
    """A :class:`QMixer` holding the JAX package's ``QMixer`` tree."""
    p = tree["params"]
    state_dim, embed = _kernel(p, "Dense_1").shape
    n_agents = _kernel(p, "Dense_0").shape[1] // embed
    return _load_flax(QMixer(n_agents, state_dim, embed), tree, dtype, device)
