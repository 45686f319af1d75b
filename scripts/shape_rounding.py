#!/usr/bin/env python3
"""Does a lane round alike in a block of lanes and in the whole population?

    python3 scripts/shape_rounding.py [--popsize 10000] [--block 5000] [--steps 200]
        [--device cuda]

A sharded evaluation (``evotorch_tpu_torch/parallel``) runs each rank's
block of lanes with the kernels of the block's shapes. For the flagship
(Humanoid, ``tanh_mlp(109, 17, [64, 64])``, a population drawn around a
zero center with stdev 0.1, the PGPE sampler's rows), this computes the
first ``--block`` lanes twice, at the population's width and at the
block's, from the same rows, and reports the largest absolute difference
of each piece: the policy forward (``policy``), one env step from the
same states and actions (``env_obs``, ``env_rewards``), and the closed
loop of the ``budget`` contract, the block drawing its resets as a rank
does (every row drawn, its own taken), after 1, 10, 50 and ``--steps``
control steps (``loop_returns``, the running returns). 0.0 means bit for
bit. The last line is one JSON object with these numbers, the device
and, on a card, its name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--popsize", type=int, default=10_000)
    parser.add_argument("--block", type=int, default=5_000)
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from evotorch_tpu_torch import resolve_device
    from evotorch_tpu_torch.algorithms.functional import pgpe, pgpe_ask
    from evotorch_tpu_torch.envs import Humanoid
    from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy, stats_init, tanh_mlp
    from evotorch_tpu_torch.neuroevolution.net import vecrl

    device = resolve_device(args.device)
    n, k = args.popsize, args.block
    env = Humanoid(device=device)
    policy = FlatParamsPolicy(tanh_mlp(env.observation_size, env.action_size, [64, 64]))
    state = pgpe(
        center_init=torch.zeros(policy.parameter_count, device=device), center_learning_rate=0.1,
        stdev_learning_rate=0.1, objective_sense="max", stdev_init=0.1,
    )  # fmt: skip
    generator = torch.Generator(device=device).manual_seed(0)
    values = pgpe_ask(generator, state, popsize=n)
    table = env.reset_noise(n, generator)
    states, obs = env.batch_reset_from(table)
    states_k, obs_k = env.batch_reset_from(table[:k])

    out = {}
    raw, _ = policy(values, obs, None)
    raw_k, _ = policy(values[:k], obs[:k], None)
    out["policy"] = _max_diff(raw[:k], raw_k)
    actions = torch.clamp(raw, env.action_space.lb, env.action_space.ub)
    _, new_obs, rewards, _ = env.batch_step(states, actions)
    _, new_obs_k, rewards_k, _ = env.batch_step(states_k, actions[:k])
    out["env_obs"] = _max_diff(new_obs[:k], new_obs_k)
    out["env_rewards"] = _max_diff(rewards[:k], rewards_k)

    # the budget loop at both widths, as a rank runs its block: every reset
    # drawn for the n lanes, the block taking its rows (global lane ids)
    options = vecrl._make_options(False, None, None, None, None)
    loop = {}
    for width in (n, k):
        g = torch.Generator(device=device).manual_seed(1)
        store = values[:width]
        lanes = vecrl._lane_view(width, torch.arange(width), None, n, device)
        carry = vecrl._budget_init(env, policy, store, g, stats_init(env.observation_size, device=device), options, lanes)
        step = vecrl._make_budget_step(env, policy, store, g, max_t=args.steps, options=options, lanes=lanes)
        marks = {}
        for t in range(1, args.steps + 1):
            carry = step(carry)
            if t in (1, 10, 50, args.steps):
                marks[t] = carry.scores[:k].clone()
        loop[width] = marks
    out["loop_returns"] = {str(t): _max_diff(loop[n][t], loop[k][t]) for t in loop[k]}

    result = {"device": str(device), "popsize": n, "block": k, "max_abs_diff": out}
    if device.type == "cuda":
        result["card"] = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
        )
        result["nvidia_smi"] = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
