"""Generation times of the flagship example through the object API against
the functional path, on one CUDA card.

Run on a machine with a CUDA device, from the root of a checkout:

    python3 -m evotorch_tpu_torch.oo_times [--rounds 2] [--popsize 10000]

Four configurations of the flagship (Humanoid, the 64-64 tanh MLP of
``examples/humanoid_pgpe.py``, popsize 10,000, ``budget`` contract with
200 steps, PGPE with ClipUp and centered ranking at the example's
constants):

- ``oo``: ``VecNE`` + ``PGPE`` with bfloat16 policy compute and
  observation normalization, as the example runs it;
- ``functional``: the same generation through ``make_generation_step``
  with ``pgpe_ask`` / ``pgpe_tell``;
- ``oo_f32``: ``oo`` with float32 policy compute;
- ``oo_no_norm``: ``oo`` without observation normalization.

First each configuration is built and run alone for two generations (a
warm-up, then one full generation), and its peak memory is taken over that
(``torch.cuda.max_memory_allocated`` above what was allocated before it was
built). Then all four take one generation in turns, ``--rounds`` times.
Each generation is timed by the host's clock from a drained card to a
drained card. The last line is one JSON object with every time, the peaks,
and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

NETWORK = "Linear(obs_length, 64) >> Tanh() >> Linear(64, 64) >> Tanh() >> Linear(64, act_length)"
EPISODE_LENGTH = 200
PGPE_KW = dict(
    center_learning_rate=0.06,
    stdev_learning_rate=0.1,
    radius_init=0.27,
    optimizer="clipup",
    optimizer_config={"max_speed": 0.12},
    ranking_method="centered",
)


def _oo(popsize: int, *, bf16: bool, norm: bool):
    import torch

    from evotorch_tpu_torch.algorithms import PGPE
    from evotorch_tpu_torch.neuroevolution import VecNE

    problem = VecNE(
        "humanoid",
        NETWORK,
        observation_normalization=norm,
        episode_length=EPISODE_LENGTH,
        eval_mode="budget",
        compute_dtype=torch.bfloat16 if bf16 else None,
        seed=0,
    )
    searcher = PGPE(problem, popsize=popsize, **PGPE_KW)
    return searcher.step


def _functional(popsize: int):
    import torch

    from evotorch_tpu_torch.algorithms.functional import pgpe, pgpe_ask, pgpe_tell
    from evotorch_tpu_torch.envs import Humanoid
    from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy, stats_init, str_to_net
    from evotorch_tpu_torch.parallel import make_generation_step

    env = Humanoid()
    policy = FlatParamsPolicy(str_to_net(NETWORK, obs_length=env.observation_size, act_length=env.action_size))
    state = pgpe(center_init=torch.zeros(policy.parameter_count, device=env.device), objective_sense="max", **PGPE_KW)
    generation = make_generation_step(
        env,
        policy,
        ask=lambda g, s: pgpe_ask(g, s, popsize=popsize),
        tell=pgpe_tell,
        popsize=popsize,
        num_episodes=1,
        episode_length=EPISODE_LENGTH,
        eval_mode="budget",
        observation_normalization=True,
        compute_dtype=torch.bfloat16,
        nonfinite_quarantine=True,
    )
    carry = {"state": state, "stats": stats_init(env.observation_size, device=env.device)}
    generator = torch.Generator(device=env.device).manual_seed(0)

    def step():
        carry["state"], _, carry["stats"], _, _ = generation(carry["state"], generator, carry["stats"])

    return step


def _timed(step) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--popsize", type=int, default=10_000)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("oo_times: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    configs = {
        "oo": lambda: _oo(args.popsize, bf16=True, norm=True),
        "functional": lambda: _functional(args.popsize),
        "oo_f32": lambda: _oo(args.popsize, bf16=False, norm=True),
        "oo_no_norm": lambda: _oo(args.popsize, bf16=True, norm=False),
    }
    steps, alone, peaks = {}, {}, {}
    for name, build in configs.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        steps[name] = build()
        alone[name] = [_timed(steps[name]) for _ in range(2)]
        peaks[name] = torch.cuda.max_memory_allocated() - base
        print(f"[alone] {name}: warm-up {alone[name][0]:.3f} s, generation {alone[name][1]:.3f} s, peak {peaks[name] / 1e9:.3f} GB")
    turns = {name: [] for name in configs}
    for r in range(args.rounds):
        for name, step in steps.items():
            turns[name].append(_timed(step))
        print(f"[turns] round {r + 1}: " + ", ".join(f"{k} {v[-1]:.3f} s" for k, v in turns.items()))
    print(smi)
    print(
        json.dumps(
            {
                "card": smi,
                "popsize": args.popsize,
                "episode_length": EPISODE_LENGTH,
                "alone_s": alone,
                "turns_s": turns,
                "peak_bytes": peaks,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.getcwd())
    sys.exit(main())
