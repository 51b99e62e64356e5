"""Arity-3 hierarchical BFS + ezpolicy on ``[N, B]`` planes.

PyTorch counterpart of ``gym_formation_tpu/models/bfs_planes.py``, and the
plain version of the policy that the fused step kernel K3
(``csrc/fused_step.cu``) runs in-kernel.  It gives the actions of
:func:`~.bfs.bfs_actions_from_state` driven by
:func:`~.scripted.ezpolicy_batched` for ``3**L`` agents, to float32
rounding.

The JAX version writes every gather as a selection matmul built from iota,
to keep the TPU's lanes full; here they are reshapes and indexing.  The
arithmetic follows the JAX function operation for operation, because its
``<``/``<=`` comparisons flip one agent's action wholesale:

- block centroids are hierarchical means of child means,
  ``((a + b) + c) / 3.0``;
- every comparison is on squared distances;
- the settled test pairs vertex v with agent ``_SETTLED_PERM[i][v]`` in
  member i's frame and compares ``err < 1e-4``;
- a member claims a vertex it is strictly closest to, else its farthest
  vertex (highest index among ties), and the pick takes the first index
  among ties;
- level l scales its actions by ``L - l``.

The kernel runs the same operations in the same order, each rounded on its
own, so on the card the two agree bit for bit.  The divisions by 3 divide by
a tensor: PyTorch on a GPU turns division by a Python scalar into a
multiplication by its reciprocal, which rounds differently.
"""

from __future__ import annotations

import torch

# Member i of a group pairs vertex v with agent _SETTLED_PERM[i][v] in the
# settled test: the reference orders its current shape as [others, self].
_SETTLED_PERM = ((1, 2, 0), (0, 2, 1), (0, 1, 2))
_BIG = 3.4e38


def _mean3(x: torch.Tensor, three: torch.Tensor) -> torch.Tensor:
    """[3G, B] → [G, B]: the mean of each consecutive row triple."""
    v = x.reshape(-1, 3, x.shape[-1])
    return (v[:, 0] + v[:, 1] + v[:, 2]) / three


def bfs_ez_planes(px, py, sx, sy, rvx, rvy, L: int):
    """Arity-3 BFS expansion of ezpolicy on ``[N, B]`` planes, N = 3**L.

    Args:
      px, py: agent positions [N, B], in any common frame (only centroid
        differences are used).
      sx, sy: the centred ideal shape [N, B].
      rvx, rvy: the root commanded velocity, [B] or [1, B].
      L: number of levels.

    Returns ``(ax, ay)`` [N, B], row i the action of agent i, in the dtype
    and on the device of ``px``.
    """
    N = 3**L
    if px.shape[0] != N:
        raise ValueError(f"bfs_ez_planes with L={L} takes {N} rows, got {px.shape[0]}")
    B = px.shape[-1]
    three = torch.full((), 3.0, dtype=px.dtype, device=px.device)
    # centroid pyramids: level k has 3**k rows, level L is the agents
    Px, Py, Sx, Sy = {L: px}, {L: py}, {L: sx}, {L: sy}
    for k in range(L - 1, -1, -1):
        Px[k] = _mean3(Px[k + 1], three)
        Py[k] = _mean3(Py[k + 1], three)
        Sx[k] = _mean3(Sx[k + 1], three)
        Sy[k] = _mean3(Sy[k + 1], three)

    pvx = rvx.reshape(1, B).to(px.dtype)  # [G, B]: each group's commanded velocity
    pvy = rvy.reshape(1, B).to(px.dtype)
    for l in range(L):
        G = 3**l
        # members of each group (level l+1) centred on their group's mean
        # (level l): [G, 3, B] → one [G, B] plane per member
        members = lambda P: (P[l + 1].reshape(G, 3, B) - P[l][:, None]).unbind(1)
        Ax, Ay, Tx, Ty = members(Px), members(Py), members(Sx), members(Sy)
        D = [[_sq2(Ax[a] - Tx[v], Ay[a] - Ty[v]) for v in range(3)] for a in range(3)]
        outs_x, outs_y = [], []
        for i in range(3):
            j, kk = [a for a in range(3) if a != i]
            d = D[i]
            ok = [(d[v] < D[j][v]) & (d[v] < D[kk][v]) for v in range(3)]
            far2 = (d[2] >= d[0]) & (d[2] >= d[1])
            far1 = ~far2 & (d[1] >= d[0])
            far0 = ~far2 & ~far1
            ok = [ok[0] | far0, ok[1] | far1, ok[2] | far2]
            m = [torch.where(ok[v], d[v], _BIG) for v in range(3)]
            p0 = (m[0] <= m[1]) & (m[0] <= m[2])
            p1 = ~p0 & (m[1] <= m[2])
            vx = torch.where(p0, Tx[0], torch.where(p1, Tx[1], Tx[2]))
            vy = torch.where(p0, Ty[0], torch.where(p1, Ty[1], Ty[2]))
            perm = _SETTLED_PERM[i]
            e = [_sq2(Tx[v] - Ax[perm[v]], Ty[v] - Ay[perm[v]]) for v in range(3)]
            err = e[0] + e[1] + e[2]
            scale = torch.full_like(err, 0.3).masked_fill(err < 1e-4, 1.0)
            ax = torch.clamp(0.5 * (vx - Ax[i]), -1.0, 1.0) + pvx * scale
            ay = torch.clamp(0.5 * (vy - Ay[i]), -1.0, 1.0) + pvy * scale
            outs_x.append(ax * float(L - l))
            outs_y.append(ay * float(L - l))
        # row 3g + i of the next level = member i of group g
        pvx = torch.stack(outs_x, 1).reshape(3 * G, B)
        pvy = torch.stack(outs_y, 1).reshape(3 * G, B)
    return pvx, pvy


def _sq2(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    return dx * dx + dy * dy
