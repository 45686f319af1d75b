"""The control steps of a round as the program takes them.

``StepTap`` wraps the rollout engine's control step
(``evotorch_tpu_torch.neuroevolution.net.vecrl._act_and_step``: the policy,
the clip, the env's step, truncation and the rewards' shift) while a round
is tapped. It keeps every step's rewards and dones on every lane (the
tensors the program made, not copies) and, on ``LANES`` lanes drawn from the
seed, the inputs (but the parameters, which the reference takes from the
population) and outputs of the first step and of ``STEPS`` more drawn
uniformly over the round (a reservoir), each with the next step's
observations and statistics on every lane. A recurrent policy's state
(``policy_states``, the call's 8th argument, and the new one it returns
last) is kept on those lanes too, flattened to a tuple of ``(lanes, k)``
leaves in the port's order, with the state the step before returned (the
tap holds a reference to it, no copy): what a lane was fed, what it got
back and what it had. A stateless policy's keeps nothing. ``check.py``
holds them to the reference: one control step from the program's state,
the policy state each lane is fed, the contract's bookkeeping from the
program's rewards and dones, and the statistics' update. Outside a tapped
round it only forwards the call.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

__all__ = ["LANES", "STEPS", "StepTap"]

#: lanes of a round whose steps are compared
LANES = 64
#: steps of a round compared besides the first
STEPS = 4


def _take_lanes(state, lanes):
    """The lanes ``lanes`` of an env state (body leaves ``(nb, k, B)``, the
    step counter ``(B,)``)."""
    body = type(state.obs_state)(*(leaf.index_select(-1, lanes) for leaf in state.obs_state))
    return type(state)(obs_state=body, t=state.t.index_select(0, lanes))


def _take_state(state, lanes):
    """The lanes ``lanes`` of a policy state (nested tuples of tensors with
    the lanes first, None where a module has none), as a tuple of its
    leaves in order; None for a stateless policy."""
    leaves = []

    def walk(x):
        if isinstance(x, (tuple, list)):
            for part in x:
                walk(part)
        elif x is not None:
            leaves.append(x.index_select(0, lanes))

    walk(state)
    return tuple(leaves) or None


class StepTap:
    def __init__(self, rng: np.random.Generator):
        from evotorch_tpu_torch.neuroevolution.net import vecrl

        self._module = vecrl
        self._original = vecrl._act_and_step
        self.rng = rng
        self.round: Optional[dict] = None
        self._waiting: List[dict] = []
        self._previous_state = None
        vecrl._act_and_step = self._step

    def close(self):
        self._module._act_and_step = self._original

    def begin(self):
        self.round = {"rewards": [], "dones": [], "captures": [], "lanes": None}
        self._waiting = []
        self._previous_state = None

    def end(self) -> Optional[dict]:
        out, self.round = self.round, None
        self._waiting = []
        self._previous_state = None
        return out

    def _step(self, env, forward, params, obs, stats, env_states, steps_in_episode, policy_states, *args, **kwargs):
        out = self._original(env, forward, params, obs, stats, env_states, steps_in_episode, policy_states, *args, **kwargs)
        r = self.round
        if r is None:
            return out
        previous, self._previous_state = self._previous_state, out[5]
        for cap in self._waiting:
            cap["next_obs"], cap["next_stats"] = obs, stats
        self._waiting = []
        t = len(r["rewards"])
        new_states, new_obs, rewards, dones, steps = out[:5]
        r["rewards"].append(rewards)
        r["dones"].append(dones)
        if t == 0:
            width = int(obs.shape[0])
            picked = np.sort(self.rng.choice(width, size=min(LANES, width), replace=False))
            r["lanes"] = torch.as_tensor(picked, dtype=torch.int64, device=obs.device)
            r["first_obs"], r["first_stats"] = obs, stats
            slot = len(r["captures"])
        elif len(r["captures"]) < STEPS + 1:
            slot = len(r["captures"])
        else:
            j = int(self.rng.integers(0, t))  # the reservoir over steps 1..t
            if j >= STEPS:
                return out
            slot = 1 + j
        lanes = r["lanes"]
        cap = {
            "t": t,
            "obs": obs.index_select(0, lanes),
            "stats": stats,
            "states": _take_lanes(env_states, lanes),
            "steps_in": steps_in_episode.index_select(0, lanes),
            "new_states": _take_lanes(new_states, lanes),
            "new_obs": new_obs.index_select(0, lanes),
            "rewards": rewards.index_select(0, lanes),
            "dones": dones.index_select(0, lanes),
            "steps": steps.index_select(0, lanes),
            "policy_states": _take_state(policy_states, lanes),
            "new_policy_states": _take_state(out[5], lanes),
            "previous_policy_states": _take_state(previous, lanes),
        }
        if slot == len(r["captures"]):
            r["captures"].append(cap)
        else:
            r["captures"][slot] = cap
        self._waiting.append(cap)
        return out

