"""K9: one PPO epoch's actor + critic gradient with a hand-derived backward.

The CUDA kernels of ``csrc/fused_ppo_grad.cu`` replace the TPU kernel
``gym_formation_tpu/ops/pallas/fused_ppo_grad.py:fused_ppo_grads``.  Its
source note says what bounds it on the H100 and how it is laid out.

Gradient-matched to autograd of ``MAPPO._loss`` on the shared continuous
policy: the actor on every (sample, agent) row, the clipped-ratio policy loss
with the ±20 log-ratio clamp, the critic on every sample row with the clipped
Huber value loss.  The log-std gradient excludes the entropy term: the caller
adds ``-entropy_coef`` per dim and chains ``soft_bound``.

:func:`fused_ppo_grads` is the wrapper: a CUDA tensor launches the kernels,
a CPU tensor takes :func:`fused_ppo_grads_plain`, the same backward in
PyTorch operations.  ``launches`` counts kernel launches (one per call: the
actor's and the critic's gradient kernels, each with its fixed-order sum
over blocks).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch

from ... import _device
from .. import _build

launches = 0

HIDDEN = 64
_LOG_2PI = math.log(2.0 * math.pi)
_ROWS = 64  # rows per chunk of the kernel


@functools.lru_cache(maxsize=None)
def _plan(K: int, actor: bool, device: int) -> Tuple[int, int]:
    """(resident blocks an SM, stages of the input copies) of one role's
    kernel at rows K floats wide on card ``device``, from the launcher
    (``fused_ppo_grad_plan``: the occupancy the compiled kernel gets at its
    shared memory).  0 blocks: the rows do not fit the card's shared memory."""
    stages = ctypes.c_int(0)
    with torch.cuda.device(device):
        per_sm = _build.lib().fused_ppo_grad_plan(K, int(actor), ctypes.byref(stages))
    if per_sm < 0:
        raise RuntimeError("fused_ppo_grad_plan: a CUDA error while sizing K9's launch")
    return per_sm, stages.value


def _grid(rows: int, per_sm: int, sms: int) -> int:
    """Blocks of one role's launch: one persistent wave (``per_sm`` blocks
    on each of ``sms`` SMs), and no block without a chunk."""
    return max(1, min(-(-rows // _ROWS), sms * per_sm))


def chunk_rows_plain(rows: int, G: int):
    """The kernel's chunk-to-block assignment, in numpy: [rows] int64, the
    block that takes each row (block b takes the 64-row chunks b, b + G,
    ...).  Returns (owner, visits), visits counting how often a row is
    taken."""
    owner = np.full(rows, -1, np.int64)
    visits = np.zeros(rows, np.int64)
    for b in range(G):
        c = b
        while c * _ROWS < rows:
            r = np.arange(c * _ROWS, min(rows, (c + 1) * _ROWS))
            owner[r] = b
            visits[r] += 1
            c += G
    return owner, visits


def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _rows(data: Dict[str, torch.Tensor], n_agents: int, act_dim: int):
    """The flat rows of the batch: actor rows [M·N, ...], critic rows [M, ...]."""
    obs = data["obs"]
    M, N, do = obs.shape
    if N != n_agents:
        raise ValueError(f"obs has {N} agents, n_agents={n_agents}")
    adv = data["adv"]
    if adv.dim() == 1:
        adv = adv[:, None].expand(M, N)
    return dict(
        xa=obs.reshape(M * N, do), xc=obs.reshape(M, N * do),
        act=data["action"].reshape(M * N, act_dim), lpo=data["logp"].reshape(M * N),
        adv=adv.reshape(M * N), vold=data["value"].reshape(M), tgt=data["target"].reshape(M),
    )


def _backward(x, w1, b1, w2, b2, w3, g_out, h1, h2):
    """Weight gradients of the 2-hidden-layer relu MLP given dL/d(output)."""
    dw3, db3 = h2.T @ g_out, g_out.sum(0)
    g2 = (g_out @ w3.T) * (h2 > 0)
    dw2, db2 = h1.T @ g2, g2.sum(0)
    g1 = (g2 @ w2.T) * (h1 > 0)
    return x.T @ g1, g1.sum(0), dw2, db2, dw3, db3


def fused_ppo_grads_plain(
    data: Dict[str, torch.Tensor],
    actor_ops: Tuple[torch.Tensor, ...],
    critic_ops: Tuple[torch.Tensor, ...],
    *,
    n_agents: int,
    act_dim: int,
    clip_eps: float,
    huber_delta: float,
    value_coef: float,
):
    """Plain PyTorch version of K9 (float32); arguments and results as
    :func:`fused_ppo_grads`."""
    f = lambda t: t.to(torch.float32)
    r = {k: f(v) for k, v in _rows(data, n_agents, act_dim).items()}
    aw1, ab1, aw2, ab2, aw3, ab3, als = (f(t) for t in actor_ops)
    cw1, cb1, cw2, cb2, cw3, cb3 = (f(t) for t in critic_ops)
    Ma, M = r["xa"].shape[0], r["xc"].shape[0]

    # actor
    h1 = torch.relu(r["xa"] @ aw1 + ab1)
    h2 = torch.relu(h1 @ aw2 + ab2)
    mu = h2 @ aw3 + ab3
    inv_std = torch.exp(-als)
    z = (r["act"] - mu) * inv_std
    logp = -0.5 * (z * z).sum(1) - als.sum() - 0.5 * act_dim * _LOG_2PI
    delta = logp - r["lpo"]
    ratio = torch.exp(delta.clamp(-20.0, 20.0))
    adv = r["adv"]
    t1 = ratio * adv
    t2 = ratio.clamp(1.0 - clip_eps, 1.0 + clip_eps) * adv
    # min's gradient to t1 where t1 < t2, else to t2 (zero outside the clip)
    through = (t1 < t2) | ((ratio > 1.0 - clip_eps) & (ratio < 1.0 + clip_eps))
    dratio = torch.where(through, -adv * (1.0 / Ma), torch.zeros_like(adv))
    dlogp = torch.where(delta.abs() < 20.0, dratio * ratio, torch.zeros_like(ratio))
    g_mu = dlogp[:, None] * (z * inv_std)
    dals = (dlogp[:, None] * (z * z - 1.0)).sum(0)
    ga = _backward(r["xa"], aw1, ab1, aw2, ab2, aw3, g_mu, h1, h2) + (dals,)

    # critic
    k1 = torch.relu(r["xc"] @ cw1 + cb1)
    k2 = torch.relu(k1 @ cw2 + cb2)
    v = (k2 @ cw3 + cb3)[:, 0]
    vold, tgt = r["vold"], r["tgt"]
    dv_raw = v - vold
    vclip = vold + dv_raw.clamp(-clip_eps, clip_eps)
    e1, e2 = v - tgt, vclip - tgt

    def huber(e):
        a = e.abs()
        return torch.where(a <= huber_delta, 0.5 * e * e, huber_delta * (a - 0.5 * huber_delta))

    l1, l2 = huber(e1), huber(e2)
    # max's gradient to l1 where l1 > l2, else to l2 (zero outside the clip)
    d2 = torch.where(dv_raw.abs() < clip_eps, e2.clamp(-huber_delta, huber_delta), torch.zeros_like(e2))
    dv = torch.where(l1 > l2, e1.clamp(-huber_delta, huber_delta), d2) * (value_coef * (1.0 / M))
    gc = _backward(r["xc"], cw1, cb1, cw2, cb2, cw3, dv[:, None], k1, k2)

    met = torch.stack([-torch.minimum(t1, t2).sum(), torch.maximum(l1, l2).sum(), (r["lpo"] - logp).sum()])
    return ga, gc, met


def fused_ppo_grads(
    data: Dict[str, torch.Tensor],
    actor_ops: Tuple[torch.Tensor, ...],
    critic_ops: Tuple[torch.Tensor, ...],
    *,
    n_agents: int,
    act_dim: int,
    clip_eps: float,
    huber_delta: float,
    value_coef: float,
):
    """One epoch's PPO gradients.

    ``data``: the flat batch ``{"obs" [M, N, do], "action" [M, N, A],
    "logp" [M, N], "adv" [M] or [M, N], "value" [M], "target" [M]}``.
    ``actor_ops``: ``(w1 [do, 64], b1 [64], w2 [64, 64], b2, w3 [64, A],
    b3 [A], bounded log_std [A])``; ``critic_ops``: ``(w1 [N·do, 64], b1, w2,
    b2, w3 [64, 1], b3 [1])``: weights ``[in, out]``.

    Returns ``(actor grads, critic grads, metric sums [3])``, the gradients
    in the operands' shapes (the log-std's without the entropy term) and the
    sums of ``-min(t1, t2)``, ``max(l1, l2)`` and ``logp_old - logp``.  On the
    card the operands are contiguous float32 and ``A`` is 1 or 2."""
    kw = dict(n_agents=n_agents, act_dim=act_dim, clip_eps=clip_eps, huber_delta=huber_delta,
              value_coef=value_coef)
    obs = data["obs"]
    if not _device.use_kernel(obs):
        return fused_ppo_grads_plain(data, actor_ops, critic_ops, **kw)
    r = _rows(data, n_agents, act_dim)
    r["adv"] = r["adv"].contiguous()
    dev = obs.device
    M, N, do = obs.shape
    Ma, dc, A, H = M * N, N * do, act_dim, HIDDEN
    if not 1 <= A <= 2:
        raise ValueError(f"K9 is built for act_dim 1 or 2, got {A}")
    shapes = [(do, H), (H,), (H, H), (H,), (H, A), (A,), (A,),
              (dc, H), (H,), (H, H), (H,), (H, 1), (1,)]
    named = [(k, r[k], None) for k in ("xa", "act", "lpo", "adv", "vold", "tgt")]
    named += [(f"weight operand {i}", w, s) for i, (w, s) in enumerate(zip(list(actor_ops) + list(critic_ops), shapes))]
    for name, x, shape in named:
        if x.dtype != torch.float32 or not x.is_contiguous() or x.device != dev or (
                shape is not None and tuple(x.shape) != shape):
            raise ValueError(f"K9 takes a contiguous float32 {name}" + (f" of shape {shape}" if shape else "")
                             + f" on {dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if actor_ops[0].data_ptr() % 16 or critic_ops[0].data_ptr() % 16:
        raise ValueError("K9 reads W1 in 16-byte loads: it takes W1 aligned to 16 bytes")
    (pa, Sa), (pc, Sc) = _plan(do, True, dev.index), _plan(dc, False, dev.index)
    if not (pa and pc):
        raise ValueError(f"K9's blocks for rows of {do} (actor) and {dc} (critic) floats at n={N} do not "
                         f"fit the card's shared memory")
    Pa = do * H + H + H * H + H + H * A + A + A + 2
    Pc = dc * H + H + H * H + H + H + 1 + 1
    sms = _sm_count(dev)
    Ga, Gc = _grid(Ma, pa, sms), _grid(M, pc, sms)
    # each block's slice, then their sum in the last row
    part_a = torch.empty((Ga + 1, Pa), dtype=torch.float32, device=dev)
    part_c = torch.empty((Gc + 1, Pc), dtype=torch.float32, device=dev)
    out_a, out_c = part_a[Ga], part_c[Gc]
    rc = _build.lib().fused_ppo_grad_launch(
        *(r[k].data_ptr() for k in ("xa", "act", "lpo", "adv", "vold", "tgt")),
        *(w.data_ptr() for w in actor_ops), *(w.data_ptr() for w in critic_ops),
        part_a.data_ptr(), part_c.data_ptr(),
        Ma, M, do, dc, A, Ga, Gc, Sa, Sc, float(clip_eps), float(huber_delta), float(value_coef),
        1.0 / Ma, 1.0 / M, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "fused_ppo_grad")
    global launches
    launches += 1

    def split(flat, shapes_):
        out, o = [], 0
        for s in shapes_:
            k = math.prod(s)
            out.append(flat[o : o + k].view(s))
            o += k
        return out, flat[o:]

    ga, tail_a = split(out_a, shapes[:7])
    gc, tail_c = split(out_c, shapes[7:])
    met = torch.stack([tail_a[0], tail_c[0], tail_a[1]])
    return tuple(ga), tuple(gc), met
