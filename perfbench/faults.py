"""Faults planted under the timed path, to see the check come out false:
the calibration reads them on the card at the cell's size, the tests on
the CPU at a small one.  Each takes what the driver hands it (the learner,
or the rollout call) and breaks it in place or returns it broken."""

from __future__ import annotations

import torch


def unchanged_state(learner):
    """The optimizer's step returns its state and leaves the parameters."""
    learner.tx.step = lambda params, grads, state: state


def half_batch(learner):
    """The update sees half of the batch: its mean is over the rest."""
    prepare = learner._prepare

    def halved(ts, traj, last_value):
        ts, data = prepare(ts, traj, last_value)
        return ts, {k: v[: v.shape[0] // 2] for k, v in data.items()}
    learner._prepare = halved


def stale_state(roll):
    """A chunk returns the state it started from (its rewards are right)."""
    def stale(env, st, gen, wl):
        _, rew = roll(env, st, gen, wl)
        return st, rew
    return stale


def altered_answer(roll):
    """Every reward is one percent off where it is produced."""
    def altered(env, st, gen, wl):
        st2, rew = roll(env, st, gen, wl)
        return st2, rew * 1.01
    return altered


def no_exchange(learner):
    """Each rank of a data-parallel world applies its own share of the
    gradient: the exchange between the cards is left out."""
    learner._reduce = lambda grads, met, whole=("alpha",): (grads, met)


def _env_step(learner, alter):
    step = learner.env.step_state

    def altered(state, actions, generator=None):
        return alter(*step(state, actions, generator))
    learner.env.step_state = altered


def altered_reward(learner):
    """Every env step's reward is one percent off where it is produced."""
    _env_step(learner, lambda st, out: (st, out.__class__(obs=out.obs, reward=out.reward * 1.01,
                                                          done=out.done, info=out.info)))


def altered_state(learner):
    """Every env step moves each agent a hundredth of the arena off."""
    n = learner.n_agents
    _env_step(learner, lambda st, out: (st.replace(pos=torch.cat([st.pos[:, :n] + 1e-2, st.pos[:, n:]], 1)), out))


TRAIN = dict(unchanged_state=unchanged_state, half_batch=half_batch)
# the env's answers, where the cell follows each of the program's steps
STEPS = dict(altered_reward=altered_reward, altered_state=altered_state)
ACROSS_CHIPS = dict(no_exchange=no_exchange)
ROLLOUT = dict(unchanged_state=stale_state, altered_answer=altered_answer)


def of_cell(workload: dict) -> dict:
    """The faults a cell can have, by name."""
    if workload["driver"] != "train":
        return ROLLOUT
    out = dict(TRAIN, **(STEPS if workload.get("follow") == "steps" else {}))
    return dict(out, **(ACROSS_CHIPS if int(workload.get("chips", 1)) > 1 else {}))


def by_name(driver: str, name: str):
    return (dict(TRAIN, **STEPS, **ACROSS_CHIPS) if driver == "train" else ROLLOUT)[name]
