"""formation_hd_env in plain torch: the reference's physics, reward,
auto-reset draws and the arity-3 BFS + ezpolicy controller.

Written from the environment's published equations (MPE point masses with
soft contacts, the Hausdorff shape reward of gym-formation's
formation_hd_env), batch first: positions and velocities [B, N, 2].  Every
function computes in the dtype of its inputs, so one code serves the
float64 reference and its lower-precision control.  Pair terms run over
blocks of envs so that the [b, N, N] planes fit beside the rest.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class World:
    """formation_hd_env's constants: agent size 0.03 (contact distance
    0.06, collision threshold 0.03), contact force 100 with margin 1e-3,
    damping 0.25, dt 0.1, unit mass, control sensitivity 5."""

    n: int
    episode_length: int = 100
    size: float = 0.03
    contact_force: float = 100.0
    margin: float = 1e-3
    damping: float = 0.25
    dt: float = 0.1
    sensitivity: float = 5.0

    @property
    def dmin(self) -> float:
        return 2.0 * self.size

    @property
    def thresh(self) -> float:
        return self.size  # (s1 + s2) / 2


@dataclasses.dataclass
class State:
    apos: torch.Tensor  # [B, N, 2]
    avel: torch.Tensor  # [B, N, 2]
    ishape: torch.Tensor  # [B, N, 2], centred
    ivel: torch.Tensor  # [B, 2]
    t: torch.Tensor  # [B] int64

    def to(self, dtype) -> "State":
        return State(self.apos.to(dtype), self.avel.to(dtype), self.ishape.to(dtype), self.ivel.to(dtype), self.t)

    def rows(self, idx) -> "State":
        return State(self.apos[idx], self.avel[idx], self.ishape[idx], self.ivel[idx], self.t[idx])


def blocks(B: int, n: int, budget: int = 1 << 26):
    """Env slices whose [b, n, n] planes hold about ``budget`` entries."""
    b = max(1, budget // (n * n))
    return [slice(i, min(B, i + b)) for i in range(0, B, b)]


def _contact_block(p: torch.Tensor, w: World) -> torch.Tensor:
    d = p[:, :, None, :] - p[:, None, :, :]  # [b, i, j, 2] = p_i - p_j
    dist = torch.linalg.vector_norm(d, dim=-1)
    pen = torch.nn.functional.softplus((w.dmin - dist) / w.margin) * w.margin
    coef = w.contact_force * pen / dist.clamp_min(1e-12)
    coef = coef * (1.0 - torch.eye(p.shape[1], dtype=p.dtype, device=p.device))
    return (coef[..., None] * d).sum(2)


def contact_forces(p: torch.Tensor, w: World) -> torch.Tensor:
    """Soft contact forces between every pair of agents [B, N, 2]."""
    return torch.cat([_contact_block(p[s], w) for s in blocks(p.shape[0], p.shape[1])])


def integrate(apos, avel, force, w: World):
    """Damped semi-implicit Euler at unit mass."""
    nvel = avel * (1.0 - w.damping) + force * w.dt
    return apos + nvel * w.dt, nvel


def _stats_block(apos, ishape, w: World):
    c = apos - apos.mean(1, keepdim=True)
    dv = torch.linalg.vector_norm(c[:, :, None, :] - ishape[:, None, :, :], dim=-1)  # [b, agent, vertex]
    haus = torch.maximum(dv.amin(2).amax(1), dv.amin(1).amax(1))
    dd = torch.linalg.vector_norm(apos[:, :, None, :] - apos[:, None, :, :], dim=-1)
    eye = torch.eye(apos.shape[1], dtype=torch.bool, device=apos.device)
    ncoll = ((dd < w.thresh) & ~eye).sum((1, 2)).to(apos.dtype)
    return haus, ncoll


def env_reward(apos, avel, ishape, ivel, w: World) -> torch.Tensor:
    """The env's shared reward summed over agents, [B]: n·(−haus − ‖ideal
    velocity − mean velocity‖) − Σ_i collisions_i."""
    parts = [_stats_block(apos[s], ishape[s], w) for s in blocks(apos.shape[0], apos.shape[1])]
    haus = torch.cat([p[0] for p in parts])
    ncoll = torch.cat([p[1] for p in parts])
    velterm = torch.linalg.vector_norm(ivel - avel.mean(1), dim=-1)
    return w.n * (-haus - velterm) - ncoll


def draw_reset(generator: torch.Generator, B: int, n: int, dtype=torch.float32):
    """A fresh batch of episodes from ``generator``: agent positions, then
    landmark positions (the ideal shape before centring), then the ideal
    velocity, each U(−1, 1) in float32.  Returns (apos, ishape, ivel)."""
    dev = generator.device
    u = lambda s: torch.rand(s, generator=generator, device=dev, dtype=dtype) * 2.0 - 1.0
    apos, lpos, ivel = u((B, n, 2)), u((B, n, 2)), u((B, 2))
    return apos, lpos - lpos.mean(1, keepdim=True), ivel


def select(done: torch.Tensor, fresh: State, old: State) -> State:
    """Per env: ``fresh`` where ``done`` [B], else ``old``."""
    pick = lambda a, b: torch.where(done.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
    return State(*(pick(getattr(fresh, f.name), getattr(old, f.name)) for f in dataclasses.fields(State)))


# -- the arity-3 BFS + ezpolicy -------------------------------------------------

def _mean3(x: torch.Tensor) -> torch.Tensor:
    """[B, 3G] → [B, G]: the mean of each consecutive triple."""
    v = x.reshape(x.shape[0], -1, 3)
    return (v[..., 0] + v[..., 1] + v[..., 2]) / 3.0


def bfs_ez_actions(apos: torch.Tensor, ishape: torch.Tensor, ivel: torch.Tensor, L: int) -> torch.Tensor:
    """The hierarchical controller's actions [B, N, 2] for N = 3^L agents.

    Groups of three at each level act as meta-agents at their centroids:
    each member claims the vertex of its group's target triangle that it
    is strictly closest to among the three members, else its farthest
    vertex, and takes the nearest claimed one (lowest index on ties); its
    action is ``clip(0.5·(vertex − member), ±1)`` plus the group's
    commanded velocity, scaled 1.0 when the group is settled (squared error
    under 1e-4) and 0.3 otherwise.  Level l scales its actions by L − l,
    and its actions are the next level's commanded velocities."""
    B, N, _ = apos.shape
    P = {L: apos}
    S = {L: ishape}
    for k in range(L - 1, -1, -1):
        P[k] = torch.stack([_mean3(P[k + 1][..., 0]), _mean3(P[k + 1][..., 1])], -1)
        S[k] = torch.stack([_mean3(S[k + 1][..., 0]), _mean3(S[k + 1][..., 1])], -1)
    pv = ivel[:, None, :]  # [B, G, 2]
    sq = lambda a: (a * a).sum(-1)
    settled_perm = ((1, 2, 0), (0, 2, 1), (0, 1, 2))
    for l in range(L):
        G = 3 ** l
        A = P[l + 1].reshape(B, G, 3, 2) - P[l][:, :, None]  # members about their group's centroid
        T = S[l + 1].reshape(B, G, 3, 2) - S[l][:, :, None]
        D = sq(A[:, :, :, None, :] - T[:, :, None, :, :])  # [B, G, member, vertex]
        outs = []
        for i in range(3):
            j, k = [a for a in range(3) if a != i]
            d = D[:, :, i]
            ok = (d < D[:, :, j]) & (d < D[:, :, k])
            far2 = (d[..., 2] >= d[..., 0]) & (d[..., 2] >= d[..., 1])
            far1 = ~far2 & (d[..., 1] >= d[..., 0])
            far = torch.stack([~far2 & ~far1, far1, far2], -1)
            m = torch.where(ok | far, d, torch.inf)
            p0 = (m[..., 0] <= m[..., 1]) & (m[..., 0] <= m[..., 2])
            p1 = ~p0 & (m[..., 1] <= m[..., 2])
            pick = torch.where(p0, 0, torch.where(p1, 1, 2))
            vert = torch.gather(T, 2, pick[..., None, None].expand(B, G, 1, 2))[:, :, 0]
            perm = settled_perm[i]
            err = sum(sq(T[:, :, v] - A[:, :, perm[v]]) for v in range(3))
            scale = torch.where(err < 1e-4, 1.0, 0.3).to(apos.dtype)
            act = torch.clamp(0.5 * (vert - A[:, :, i]), -1.0, 1.0) + pv * scale[..., None]
            outs.append(act * float(L - l))
        pv = torch.stack(outs, 2).reshape(B, 3 * G, 2)
    return pv


def bfs_step(st: State, w: World, L: int):
    """One step of the hierarchical controller's rollout: the actions, the
    contacts, the integration and the reward the rollout reports, the
    shared reward broadcast to every agent and summed (n times the env's
    reward).  Returns (apos, avel, reward [B]) after the step."""
    act = bfs_ez_actions(st.apos, st.ishape, st.ivel, L)
    force = contact_forces(st.apos, w) + w.sensitivity * act
    npos, nvel = integrate(st.apos, st.avel, force, w)
    return npos, nvel, w.n * env_reward(npos, nvel, st.ishape, st.ivel, w)
