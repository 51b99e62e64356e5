"""The runs that ``tests/test_torch_tensor_parallel.py`` compares: each
learner family once in this process without a mesh (W=1), once in a world
of TP=2 ranks and once in a world of DP=2 × TP=2 ranks on the CPU (``gloo``),
from the same seeds, in float64; plus, in the TP=2 world, the model axis's
building blocks against their whole counterparts.

    python tests/_torch_tp_worker.py OUT_DIR w1|tp2|dp2tp2

writes ``OUT_DIR/w1.pt``, ``OUT_DIR/tp2_rank{0,1}.pt`` or
``OUT_DIR/dp2tp2_rank{0..3}.pt``: for each family the metrics of every
iteration, the parameters at the end gathered whole, the rank's own
parameters and which of them are cut.  Imports no JAX.
"""

from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import gym_formation_tpu_torch as gt  # noqa: E402
from gym_formation_tpu_torch import parallel  # noqa: E402
from gym_formation_tpu_torch.algos import make_algo  # noqa: E402
from gym_formation_tpu_torch.algos.mappo import MAPPO, MAPPOConfig  # noqa: E402
from gym_formation_tpu_torch.algos.optim import ClipAdam  # noqa: E402
from gym_formation_tpu_torch.algos.rmappo import RMAPPO, RMAPPOConfig  # noqa: E402
from gym_formation_tpu_torch.models import networks as nets  # noqa: E402
from gym_formation_tpu_torch.parallel import mesh as dp  # noqa: E402
from gym_formation_tpu_torch.parallel import tensor  # noqa: E402

B = 8  # global envs of every learner
F64 = torch.float64
OFFPOLICY_SETS = ["buffer_size=256", "batch_size=16", "steps_per_iter=4", "updates_per_iter=2"]
EPISODIC_SETS = ["buffer_episodes=64", "batch_episodes=8", "episodes_per_iter=1", "updates_per_iter=2"]
DISCRETE = ("qmix", "vdn", "rqmix", "rvdn")
EPISODIC = ("rmaddpg", "rmatd3", "rmasac", "rqmix", "rvdn")


def onpolicy(cls, cfg, n, mesh, **env_kw):
    env = gt.make_env("formation_hd_env", num_agents=n, dtype=F64, mesh=mesh, **env_kw)
    return cls(env, cfg, num_envs=B, device="cpu", dtype=F64)


def offpolicy(name, mesh, extra=()):
    """The learner ``name`` of the registry, built in float64."""
    kw = dict(episode_length=4) if name in EPISODIC else {}
    env = gt.make_env("formation_hd_env", num_agents=3, discrete_action=name in DISCRETE, dtype=F64, mesh=mesh, **kw)
    sets = (EPISODIC_SETS if name in EPISODIC else OFFPOLICY_SETS) + list(extra)
    algo = make_algo(name, env, B, sets, device="cpu")
    return type(algo)(env, algo.cfg, num_envs=B, device="cpu", dtype=F64)


#: the families held over their iterations (those of tests/test_sharding.py)
FAMILIES = {
    "mappo": lambda m: onpolicy(MAPPO, MAPPOConfig(rollout_len=4, ppo_epochs=2, num_minibatches=2), 3, m),
    "mappo_fused": lambda m: onpolicy(MAPPO, MAPPOConfig(rollout_len=4, ppo_epochs=2, fused_collect=True,
                                                         fused_update=True), 3, m),
    "mappo_structured": lambda m: onpolicy(MAPPO, MAPPOConfig(rollout_len=2, ppo_epochs=2, num_minibatches=2,
                                                              grad_accum=2), 33, m),
    "rmappo": lambda m: onpolicy(RMAPPO, RMAPPOConfig(rollout_len=4, ppo_epochs=2, num_minibatches=2,
                                                      data_chunk_length=2), 3, m, episode_length=3),
    "maddpg": lambda m: offpolicy("maddpg", m),
    "masac": lambda m: offpolicy("masac", m, ["warmup_random_steps=8"]),
    "qmix": lambda m: offpolicy("qmix", m),
    "rqmix": lambda m: offpolicy("rqmix", m),
}
#: the other seven names, one iteration each
OTHERS = {name: (lambda m, name=name: offpolicy(name, m))
          for name in ("ddpg", "matd3", "vdn", "rmaddpg", "rmatd3", "rmasac", "rvdn")}


def params_of(ts):
    """Every parameter of the state's networks (online and target), in
    field order."""
    return [p.detach().clone() for m in tensor._modules(ts).values() for p in m.parameters()]


def train(build, mesh, iters):
    algo = build(mesh)
    g = torch.Generator()
    g.manual_seed(11)
    state = algo.init(g)
    parallel.shard_params_(state[0], mesh)
    metrics = []
    for _ in range(iters):
        *state, m = algo.train_step(*state, g)
        metrics.append({k: float(v) for k, v in m.items()})
    ts = state[0]
    cut = [tensor.cut_of(p) is not None for m in tensor._modules(ts).values() for p in m.parameters()]
    return {"metrics": metrics, "params": params_of(tensor.whole_state(ts, mesh)), "local": params_of(ts),
            "cut": cut}


def run_all(mesh):
    out = {name: train(build, mesh, 2 if name.startswith(("mappo", "rmappo")) else 3)
           for name, build in FAMILIES.items()}
    out.update({name: train(build, mesh, 1) for name, build in OTHERS.items()})
    return out


# -- the building blocks, in the TP=2 world --------------------------------------------

def _close(a, b):
    return float((a - b).abs().max())


def blocks(mesh):
    """Largest errors of the cut forms against the whole ones: a Dense
    layer against ``nn.Linear`` (output, input gradient, weight and bias
    gradients), the GRU cells (strided cut) against the whole cells, a
    ClipAdam step with active clipping, and a state's cut/gather round
    trip."""
    out = {}
    g = torch.Generator()
    g.manual_seed(3)
    x = torch.randn(5, 4, 6, generator=g, dtype=F64)
    up = torch.randn(5, 4, 8, generator=g, dtype=F64)

    def grads(module, *inputs):
        inputs = [t.clone().requires_grad_(True) for t in inputs]
        y = module(*inputs)
        (y * up[..., :y.shape[-1]]).sum().backward()
        return y.detach(), [t.grad for t in inputs], [p.grad for p in module.parameters()]

    lin = torch.nn.Linear(6, 8).to(F64)
    with torch.no_grad():  # every rank's the same (each process's global generator differs)
        for p in lin.parameters():
            p.copy_(torch.randn(p.shape, generator=g, dtype=F64))
    dense = nets.Dense(6, 8).to(F64)
    dense.load_state_dict(lin.state_dict())
    tensor.shard_module_(dense, mesh)
    (y0, gx0, gp0), (y1, gx1, gp1) = grads(lin, x), grads(dense, x)
    out["dense"] = max([_close(y0, y1), _close(gx0[0], gx1[0])]
                       + [_close(tensor.local_like(a, p), b) for a, b, p in zip(gp0, gp1, dense.parameters())])
    out["dense_cut"] = [tensor.cut_of(p) is not None for p in dense.parameters()]

    h = torch.randn(5, 4, 8, generator=g, dtype=F64)
    for name, make in (("gru", lambda: nets.GRUCell(6, 8, torch.Generator().manual_seed(1))),
                       ("stacked_gru", lambda: nets.StackedGRUCell(4, 6, 8, torch.Generator().manual_seed(1)))):
        whole, cut = make().to(F64), make().to(F64)
        with torch.no_grad():  # nonzero biases, so that their cut shows
            for n, p in whole.named_parameters():
                if n.startswith("bias"):
                    p.copy_(torch.randn(p.shape, generator=g, dtype=F64))
        cut.load_state_dict(whole.state_dict())
        tensor.shard_module_(cut, mesh)
        (y0, gi0, gp0), (y1, gi1, gp1) = grads(whole, h, x), grads(cut, h, x)
        out[name] = max([_close(y0, y1)] + [_close(a, b) for a, b in zip(gi0, gi1)]
                        + [_close(tensor.local_like(a, p), b) for a, b, p in zip(gp0, gp1, cut.parameters())])
        out[name + "_local"] = {n: tuple(p.shape) for n, p in cut.named_parameters()}

    # ClipAdam: a gradient well past max_norm, three steps
    ws = [torch.randn(s, generator=g, dtype=F64) for s in ((6, 8), (8,), (4, 8))]
    gs = [[torch.randn(w.shape, generator=g, dtype=F64) * 30 for w in ws] for _ in range(3)]
    tx = ClipAdam(1e-2, max_norm=1.0)
    whole = [torch.nn.Parameter(w.clone()) for w in ws]
    cut = [torch.nn.Parameter(w.clone()) for w in ws]
    for p in cut:  # the 2-D ones cut along their last axis, the bias whole
        if p.dim() == 2:
            p.tp_cut = tensor.Cut(mesh, p.dim() - 1, 1)
            p.data = p.tp_cut.local(p.data)
    st0, st1 = tx.init(whole), tx.init(cut)
    for step in gs:
        st0 = tx.step(whole, step, st0)
        st1 = tx.step(cut, [tensor.local_like(s, p) for s, p in zip(step, cut)], st1)
    out["clip_active"] = bool(torch.sqrt(sum((s * s).sum() for s in gs[0])) > 1.0)
    out["clip_adam"] = max(_close(tensor.local_like(a.detach(), b), b.detach()) for a, b in zip(whole, cut))

    # a state's cut and gather round trip (MAPPO N=3, its moments nonzero)
    algo = onpolicy(MAPPO, MAPPOConfig(), 3, mesh)
    ts = algo.init_state(*algo._networks(torch.Generator().manual_seed(4)))
    ts.opt_state = ts.opt_state._replace(mu=[torch.randn(m.shape, generator=g, dtype=F64)
                                             for m in ts.opt_state.mu])
    before = params_of(ts) + [m.clone() for m in ts.opt_state.mu]
    tensor.shard_params_(ts, mesh)
    held = [m.shape for m in ts.opt_state.mu]
    back = tensor.whole_state(ts, mesh)
    after = params_of(back) + list(back.opt_state.mu)
    out["round_trip"] = all(torch.equal(a, b) for a, b in zip(before, after, strict=True))
    out["moments_cut"] = all(tuple(s) == tuple(p.shape) for s, p in zip(held, ts.params()))
    return out


def n243_held(mesh):
    """The parameter and moment elements this rank holds of MAPPO N=243
    (structured, float32)."""
    env = gt.make_env("formation_hd_env", num_agents=243, mesh=mesh)
    algo = MAPPO(env, MAPPOConfig(), num_envs=2, device="cpu")
    ts = algo.init_state(*algo._networks(torch.Generator().manual_seed(0)))
    whole = (sum(p.numel() for p in ts.params()), sum(m.numel() for m in ts.opt_state.mu + ts.opt_state.nu))
    tensor.shard_params_(ts, mesh)
    local = (sum(p.numel() for p in ts.params()), sum(m.numel() for m in ts.opt_state.mu + ts.opt_state.nu))
    return {"whole": whole, "local": local, "bytes": tensor.held_bytes(ts)}


def rank_main(mesh, out_dir, label):
    out = run_all(mesh)
    if dp.size(mesh) == 1:
        out["blocks"] = blocks(mesh)
        out["n243"] = n243_held(mesh)
    out["coords"] = (dp.rank(mesh), tensor.rank(mesh))
    r = dp.rank(mesh) * tensor.size(mesh) + tensor.rank(mesh)
    torch.save(out, os.path.join(out_dir, f"{label}_rank{r}.pt"))


if __name__ == "__main__":
    out_dir, world = sys.argv[1:]
    if world == "w1":
        torch.save(run_all(None), os.path.join(out_dir, "w1.pt"))
    else:
        parallel.spawn(rank_main, {"tp2": 2, "dp2tp2": 4}[world], (out_dir, world), device_type="cpu", tp=2)
