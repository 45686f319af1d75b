"""What decides ``correct``: the window's outputs against the plain
reference (``reference/``), after the program's state is freed.

The Humanoid's closed loop is chaotic: a one-ulp change grows over a whole
episode into a different score. So the rollout is not replayed whole;
each number below compares where rounding does not grow, and a program
that computes the same arithmetic in another order stays correct. Each has
its limit in the configuration's ``limits``:

- ``start_gap``: the first generation's center and stdev against the
  benchmark's own (the center it made from the seed, ``radius / sqrt(L)``);
  exact.
- ``ask_gap``: rows of the kept round's population, drawn from the seed,
  against the reference sampler fed the generator state the program had
  before that ask: the widest gap over ``|mu| + sigma * (1 + |e|)``.
- ``draws_gap``: 1 when the reference's draws (the ask, the reset noise of
  the round) do not leave its generator where the program's was, else 0.
- ``step_gap``: one control step of the reference (normalization with the
  program's statistics, the configuration's plain policy on the
  population row that the contract gives the lane and on the policy state
  the program fed it, the clip, the env's step, truncation, the rewards'
  shift) from the program's state at the kept round's first step and at
  steps drawn from the seed, on lanes drawn from the seed, against the
  program's next state, observations, rewards and policy state (the
  widest ``|x - x_ref| / max(1, |x_ref|)``; 1 for a done or a step count
  that differs); the round's first observations against the reset noise
  replayed from the generator; and, for a recurrent policy, the state each
  active lane was fed: exactly the initial state where the contract starts
  its episode (zeros after a ``budget`` lane's done), elsewhere exactly
  the state the step before returned for the same item (1 where not).
- ``tally_gap``: the round's scores against the contract's bookkeeping
  (``budget``, ``episodes``, the refill scheduler) replayed in float64 from
  the program's rewards and dones of every step on every lane; 1 where the
  steps do not hold every solution's whole evaluation.
- ``steps_gap``: the round's interaction count against that replay's; exact.
- ``stats_gap``: the observation statistics' update at the round's start
  and after each compared step, from the program's observations on the
  lanes that the contract feeds in, and the count over the whole round; the
  widest ``|x - x_ref| / max(1, |x_ref|)``.
- ``rounds_gap``: over the generations that ended, the rounds whose size is
  not the popsize, and the rounds run past or short of the adaptive loop's
  rule (stop once ``popsize_max`` solutions, or more than
  ``num_interactions`` interactions, are reached); exact.
- ``center_gap``, ``stdev_gap``: the first generations' tells (up to
  three), the reference following its own center, stdev and ClipUp
  velocity from the start on the program's populations and scores joined
  over each generation's rounds: the widest ``||x - x_ref|| / ||x_ref -
  x_0||`` after a tell.

A factored (low-rank) population, ``theta_i = center + basis @ coeffs[i]``
(a configuration's ``lowrank_rank``), is compared in its own terms where
the ask is concerned and as the rows it stands for everywhere else:

- ``ask_gap``: the basis against the reference's replay of its
  generation's first round (over ``sigma * (1 + |g|) / sqrt(k)``), every
  coefficient (over ``1 + |z|``), and ``ASK_ROWS`` rows materialized in
  float64 on the dense rows' scale;
- ``draws_gap``: every ended round's ask replayed from the generator (the
  basis on a generation's first round only, then the coefficients) lands
  where the program's did, and the kept round's rollout as above;
- ``step_gap``: the tapped lanes' rows materialized in float64 and rounded
  to the program's dtype;
- ``center_gap``, ``stdev_gap``: the reference's dense tell on the
  generation's ``+`` rows materialized in float64, in blocks of rows.

The round checked is one of the window's, drawn from the seed.
``replay_round`` (the whole round replayed op for op: bit for bit on the
CPU; on the card the physics kernel rounds otherwise than the reference's
plain loop, so the gaps there are chaotic) is a diagnostic that
``control.py`` prints, not a gate.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from .reference import policies
from .reference import rollout as ref_rollout
from .reference import search as ref_search
from .reference.physics import BodyState, EnvState

__all__ = ["check_round", "control_readings", "judge", "replay_round", "run_checks", "unchanged_tell_readings"]

ASK_ROWS = 16
#: rows of a factored population materialized at a time
ROW_BLOCK = 1024


def _is_factored(values) -> bool:
    """A population held as ``center``, ``basis`` and ``coeffs``."""
    return hasattr(values, "coeffs")


def _popsize(values) -> int:
    return int(values.coeffs.shape[0] if _is_factored(values) else values.shape[0])


def _joined(parts: list):
    """The rounds of one generation as one population (a factored one's
    rounds share its center and basis)."""
    if _is_factored(parts[0]):
        return parts[0]._replace(coeffs=torch.cat([p.coeffs for p in parts]))
    return torch.cat(parts)


def _factored_rows(values, rows: Optional[torch.Tensor] = None, *, dtype=torch.float64):
    """Rows ``rows`` (all when None) of a factored population, materialized
    in float64 (``center + basis @ coeffs[row]``) a block at a time and
    rounded to ``dtype``: a list of blocks."""
    coeffs = values.coeffs if rows is None else values.coeffs.index_select(0, rows)
    center, basis = values.center.to(torch.float64), values.basis.to(torch.float64)
    return [
        torch.addmm(center, coeffs[i : i + ROW_BLOCK].to(torch.float64), basis.T).to(dtype)
        for i in range(0, coeffs.shape[0], ROW_BLOCK)
    ]


def _rows(values, rows: torch.Tensor) -> torch.Tensor:
    """The parameter rows ``rows`` of a population in its dtype."""
    if not _is_factored(values):
        return values.index_select(0, rows)
    return torch.cat(_factored_rows(values, rows, dtype=values.center.dtype))


def _rel_gap(x: torch.Tensor, ref: torch.Tensor) -> float:
    x64, r64 = x.detach().to(torch.float64), ref.detach().to(torch.float64)
    if x64.shape != r64.shape:
        return 1.0
    if x64.numel() == 0:
        return 0.0
    both = ~torch.isfinite(x64) & ~torch.isfinite(r64) & (torch.isnan(x64) == torch.isnan(r64))
    gap = torch.abs(x64 - r64) / torch.clamp(torch.abs(r64), min=1.0)
    return float(torch.max(torch.where(both, 0.0, torch.nan_to_num(gap, nan=math.inf))))


def _reference_stats(stats, device, dtype=torch.float32) -> ref_rollout.Stats:
    return ref_rollout.Stats(*(x.to(device=device, dtype=dtype) for x in (stats.count, stats.sum, stats.sum_of_squares)))


def _stats_gap(got, ref: ref_rollout.Stats) -> float:
    return max(
        _rel_gap(got.count.reshape(1), ref.count.reshape(1)),
        _rel_gap(got.sum, ref.sum),
        _rel_gap(got.sum_of_squares, ref.sum_of_squares),
    )


def _reference_state(state) -> EnvState:
    return EnvState(obs_state=BodyState(*state.obs_state), t=state.t)


def _state_gap(got, ref: EnvState) -> float:
    gaps = [_rel_gap(a, b) for a, b in zip(got.obs_state, ref.obs_state)]
    return max(gaps + [0.0 if torch.equal(got.t, ref.t) else 1.0])


def _leaves_gap(got, ref) -> float:
    """The widest relative gap over a policy state's leaves; 1 where one
    side has a state and the other none, or the leaves differ in number."""
    if got is None or ref is None:
        return 0.0 if got is None and ref is None else 1.0
    if len(got) != len(ref):
        return 1.0
    return max(_rel_gap(a, b) for a, b in zip(got, ref))


def _fed_gap(fed, expected, active: torch.Tensor) -> float:
    """0 when, on the active lanes, the fed policy state is bit for bit the
    expected one, else 1."""
    if fed is None or expected is None:
        return 0.0 if fed is None and expected is None else 1.0
    if len(fed) != len(expected):
        return 1.0
    for a, b in zip(fed, expected):
        if a.shape != b.shape or not torch.equal(a[active].to(torch.float64), b[active].to(torch.float64)):
            return 1.0
    return 0.0


def _float32(state):
    return None if state is None else tuple(x.to(torch.float32) for x in state)


def _cell_policy(config: dict, device):
    env = policies.make_env(config, device)
    return env, policies.make(config, env.observation_size, env.action_size)


def check_ask(kept: dict, rng: np.random.Generator, device, *, rows_dtype=None) -> Dict[str, float]:
    """``ask_gap`` and the ask's share of ``draws_gap``; ``rows_dtype``
    rounds the reference rows to a lower precision (the control)."""
    if _is_factored(kept["values"]):
        return check_ask_lowrank(kept, rng, device, rows_dtype=rows_dtype)
    gen = torch.Generator(device=device)
    gen.set_state(kept["gen_state_prev"])
    key, offset = ref_search.draw_seed(gen)
    draws_ok = torch.equal(gen.get_state(), kept["gen_state_before"])
    values = kept["values"]
    n = int(values.shape[0])
    directions = rng.choice(n // 2, size=min(ASK_ROWS // 2, n // 2), replace=False)
    rows = np.sort(np.concatenate([2 * directions, 2 * directions + 1]))
    mu = kept["mu"].detach().to(torch.float64).cpu().numpy()
    sigma = kept["sigma"].detach().to(torch.float64).cpu().numpy()
    ref, e = ref_search.ask_rows(key, offset, mu, sigma, rows)
    if rows_dtype is not None:
        ref = torch.as_tensor(ref).to(rows_dtype).to(torch.float64).numpy()
    got = values[torch.as_tensor(rows, device=values.device)].detach().to(torch.float64).cpu().numpy()
    scale = np.abs(mu)[None, :] + sigma[None, :] * (1.0 + np.abs(e))
    return {"ask_gap": float(np.max(np.abs(got - ref) / scale)), "ask_draws_ok": draws_ok}


def check_ask_lowrank(kept: dict, rng: np.random.Generator, device, *, rows_dtype=None) -> Dict[str, float]:
    """A factored ask's ``ask_gap`` (basis, coefficients, rows) and its
    share of ``draws_gap``; ``rows_dtype`` rounds the reference's center,
    basis and coefficients to a lower precision (the control), as the
    program's cast of a factored population does."""
    values = kept["values"]
    n, k = _popsize(values), int(values.basis.shape[-1])
    sigma = kept["sigma"].to(torch.float64)
    gen = torch.Generator(device=device)
    gen.set_state(kept["basis_state"])
    basis_ref, g, _ = ref_search.ask_lowrank(gen, sigma, n, k, draw_basis=True)
    gen.set_state(kept["gen_state_prev"])
    coeffs_ref = ref_search.ask_lowrank(gen, sigma, n, k, draw_basis=kept["first_in_generation"]).coeffs
    draws_ok = torch.equal(gen.get_state(), kept["gen_state_before"])
    mu = kept["mu"].to(torch.float64)
    if rows_dtype is not None:
        mu, basis_ref, coeffs_ref = (x.to(rows_dtype).to(torch.float64) for x in (mu, basis_ref, coeffs_ref))
    basis, coeffs = values.basis.to(torch.float64), values.coeffs.to(torch.float64)
    basis_scale = sigma[:, None] * (1.0 + torch.abs(g)) / math.sqrt(k)
    directions = rng.choice(n // 2, size=min(ASK_ROWS // 2, n // 2), replace=False)
    rows = torch.as_tensor(np.sort(np.concatenate([2 * directions, 2 * directions + 1])), device=coeffs.device)
    got = torch.cat(_factored_rows(values, rows))
    step = coeffs_ref.index_select(0, rows) @ basis_ref.T  # sigma * e of the dense rows
    ref = mu + step
    row_scale = torch.abs(mu) + sigma + torch.abs(step)
    gaps = [
        torch.max(torch.abs(basis - basis_ref) / basis_scale),
        torch.max(torch.abs(coeffs - coeffs_ref) / (1.0 + torch.abs(coeffs_ref))),
        torch.max(torch.abs(got - ref) / row_scale),
    ]
    return {"ask_gap": max(float(x) for x in gaps), "ask_draws_ok": draws_ok}


def lowrank_draws_ok(rounds: List[dict], device, *, length: int, rank: int) -> bool:
    """Every round's factored ask replayed from the generator state before
    it (the basis on a generation's first round only, then the
    coefficients) leaves the generator where the program's was."""
    gen = torch.Generator(device=device)
    sigma = torch.zeros(length, dtype=torch.float64, device=device)
    for r in rounds:
        gen.set_state(r["gen_state_prev"])
        ref_search.ask_lowrank(gen, sigma, r["size"], rank, draw_basis=r["first_in_generation"])
        if not torch.equal(gen.get_state(), r["gen_state_before"]):
            return False
    return True


def _rollout_kwargs(config: dict, traffic: dict) -> dict:
    return dict(
        contract=traffic["eval_mode"], episode_length=int(config["episode_length"]),
        decrease_rewards_by=config.get("decrease_rewards_by"),
        observation_normalization=bool(config["observation_normalization"]),
        refill_width=traffic.get("refill_width"), refill_period=int(traffic.get("refill_period", 1)),
    )  # fmt: skip


def check_round(kept: dict, config: dict, traffic: dict, device, *, dtype=torch.float64) -> Dict[str, float]:
    """``step_gap``, ``tally_gap``, ``steps_gap``, ``stats_gap`` and the
    rollout's share of ``draws_gap``, from the kept round's tapped steps;
    ``dtype`` computes the bookkeeping and the statistics' update in a lower
    precision (the control). ``step_parts`` holds the policy state's terms
    of ``step_gap`` apart: ``policy_state`` (the new state's gap) and
    ``policy_state_fed`` (1 where a lane was fed another state than the
    contract gives it)."""
    env, policy = _cell_policy(config, device)
    values = kept["values"]
    length = int(values.center.shape[0] if _is_factored(values) else values.shape[1])
    if length != policy.parameter_count:
        raise ValueError(f"the population has {length} parameters, the reference policy {policy.parameter_count}")
    kw = _rollout_kwargs(config, traffic)
    contract = kw["contract"]
    max_t = min(env.max_episode_steps, kw["episode_length"])
    shift, normalize = kw["decrease_rewards_by"], kw["observation_normalization"]
    n = _popsize(values)
    tap = kept["steps"]
    rewards, dones = torch.stack(tap["rewards"]), torch.stack(tap["dones"])
    tally = ref_rollout.tally(
        contract, rewards, dones, n=n, max_t=max_t, refill_width=kw["refill_width"], refill_period=kw["refill_period"],
        dtype=dtype,
    )  # fmt: skip
    out = {
        "tally_gap": _rel_gap(kept["scores"], tally.scores) if tally.complete else 1.0,
        "steps_gap": float(abs((kept["count_after"] - kept["count_before"]) - tally.env_steps)),
    }

    # the round's start: the reset noise replayed from the generator
    gen = torch.Generator(device=device)
    gen.set_state(kept["gen_state_before"])
    obs0 = ref_rollout.reset_draws(env, gen, contract=contract, n=n, steps=rewards.shape[0], refill_width=kw["refill_width"])
    out["rollout_draws_ok"] = torch.equal(gen.get_state(), kept["gen_state_after"])
    step_gaps = [_rel_gap(tap["first_obs"], obs0)]

    # one control step from the program's state at each tapped step
    lanes = tap["lanes"]
    initial = policy.initial_state(int(lanes.shape[0]), device)
    zeros = None if initial is None else tuple(torch.zeros_like(x) for x in initial)
    state_gaps, fed_gaps = [0.0], [0.0]
    for cap in tap["captures"]:
        t = cap["t"]
        sols = lanes if tally.lane_sol is None else tally.lane_sol[t].index_select(0, lanes)
        fed = cap["policy_states"]
        new_states, new_obs, rew, done, steps, new_policy = ref_rollout.act_and_step(
            env, policy, _rows(values, sols), cap["obs"], _reference_stats(cap["stats"], device),
            _reference_state(cap["states"]), cap["steps_in"], _float32(fed), max_t=max_t, shift=shift,
            normalize=normalize,
        )  # fmt: skip
        # the state the contract gives each lane: fresh where its episode
        # starts, else what the step before returned; judged where active
        fresh = initial if t == 0 or contract != "budget" else zeros
        starts = tally.starts[t].index_select(0, lanes)
        active = torch.ones_like(starts) if t == 0 or tally.masks is None else tally.masks[t - 1].index_select(0, lanes)
        previous = cap["previous_policy_states"]  # None at the round's first step
        expected = fresh if fresh is None or previous is None else ref_rollout.where_state(starts, fresh, previous)
        state_gaps.append(_leaves_gap(cap["new_policy_states"], new_policy))
        fed_gaps.append(_fed_gap(fed, expected, active))
        step_gaps += [
            _state_gap(cap["new_states"], new_states),
            _rel_gap(cap["new_obs"], new_obs),
            _rel_gap(cap["rewards"], rew),
            0.0 if torch.equal(cap["dones"], done) else 1.0,
            0.0 if torch.equal(cap["steps"], steps) else 1.0,
        ]
    out["step_parts"] = {"policy_state": max(state_gaps), "policy_state_fed": max(fed_gaps)}
    out["step_gap"] = max(step_gaps + state_gaps + fed_gaps)

    if normalize:
        before = _reference_stats(kept["stats_before"], device, dtype)
        stats_gaps = [_stats_gap(tap["first_stats"], ref_rollout.stats_update(before, tap["first_obs"].to(dtype)))]
        for cap in tap["captures"]:
            if "next_stats" not in cap:
                continue  # the round's last step
            mask = None if tally.masks is None else tally.masks[cap["t"]]
            ref = ref_rollout.stats_update(_reference_stats(cap["stats"], device, dtype), cap["next_obs"].to(dtype), mask)
            stats_gaps.append(_stats_gap(cap["next_stats"], ref))
        width = rewards.shape[1]
        fed = width * (1 + rewards.shape[0]) if tally.masks is None else width + int(tally.masks.sum())
        count = kept["stats_after"].count.to(torch.float64) - kept["stats_before"].count.to(torch.float64)
        stats_gaps.append(abs(float(count) - fed) / max(1.0, float(kept["stats_after"].count)))
        out["stats_gap"] = max(stats_gaps)
    return out


def check_rounds(rounds: List[dict], config: dict) -> float:
    """``rounds_gap`` over the generations whose rounds all ran."""
    popsize = int(config["popsize"])
    popsize_max, budget = config.get("popsize_max"), config.get("num_interactions")
    by_generation: Dict[int, List[dict]] = {}
    for r in rounds:
        by_generation.setdefault(r["generation"], []).append(r)
    wrong = 0
    for rs in by_generation.values():
        first, total, prev = rs[0]["count_before"], 0, -1
        for i, r in enumerate(rs):
            wrong += int(r["size"] != popsize)
            total += r["size"]
            made = r["count_after"] - first
            stop = budget is None or (popsize_max is not None and total >= popsize_max) or made > budget or made <= prev
            prev = made
            last = i == len(rs) - 1
            if stop != last:
                wrong += 1
                break
    return float(wrong)


def check_tells(generations: dict, config: dict, center0: torch.Tensor, *, dtype=torch.float64) -> Dict[str, float]:
    """``start_gap``, and ``center_gap``/``stdev_gap`` over the tells that
    ran; ``dtype`` computes the reference's tells in a lower precision (the
    control)."""
    device = center0.device
    length = int(center0.shape[0])
    mu0 = center0.to(torch.float64)
    sigma0 = torch.full((length,), float(np.float32(float(config["radius_init"]) / math.sqrt(length))), dtype=torch.float64, device=device)
    out: Dict[str, float] = {}
    first = generations.get(1, {})
    if "mu_ask" in first:
        out["start_gap"] = max(
            float(torch.max(torch.abs(first["mu_ask"].to(torch.float64) - mu0))),
            float(torch.max(torch.abs(first["sigma_ask"].to(torch.float64) - sigma0))),
        )
    state = ref_search.TellState(mu0, sigma0, torch.zeros_like(mu0))
    center_gaps, stdev_gaps = [], []
    k = 1
    while k in generations and generations[k]["values"] and "mu_ask" in generations.get(k + 1, {}):
        g, nxt = generations[k], generations[k + 1]
        values = _joined(g["values"])
        plus = _factored_rows(values._replace(coeffs=values.coeffs[0::2])) if _is_factored(values) else [values[0::2]]
        state = ref_search.tell(
            state, plus, torch.cat(g["scores"]),
            center_learning_rate=float(config["center_learning_rate"]), momentum=float(config["momentum"]),
            max_speed=float(config["max_speed"]), stdev_learning_rate=float(config["stdev_learning_rate"]),
            stdev_max_change=float(config["stdev_max_change"]), dtype=dtype,
        )  # fmt: skip
        state = ref_search.TellState(*(x.to(torch.float64) for x in state))
        mu_p, sigma_p = nxt["mu_ask"].to(torch.float64), nxt["sigma_ask"].to(torch.float64)
        center_gaps.append(float(torch.linalg.vector_norm(mu_p - state.mu) / torch.linalg.vector_norm(state.mu - mu0)))
        stdev_gaps.append(float(torch.linalg.vector_norm(sigma_p - state.sigma) / torch.linalg.vector_norm(state.sigma - sigma0)))
        k += 1
    if center_gaps:
        out["center_gap"] = max(center_gaps)
        out["stdev_gap"] = max(stdev_gaps)
    out["tells_checked"] = len(center_gaps)
    return out


def run_checks(config, traffic, *, device, kept: Optional[dict], generations: dict, rounds: List[dict], center0, rng):
    """Every number compared, each with its limit (``config["limits"]``),
    the number of tells checked, and ``step_gap``'s policy-state terms
    (``check_round``'s ``step_parts``)."""
    numbers: Dict[str, float] = {}
    tells = check_tells(generations, config, center0)
    tells_checked = tells.pop("tells_checked")
    numbers.update(tells)
    if kept is None:
        raise RuntimeError("no round of the window was kept for the check")
    ask = check_ask(kept, rng, device)
    roll = check_round(kept, config, traffic, device)
    numbers["ask_gap"] = ask["ask_gap"]
    rollout_draws_ok = roll.pop("rollout_draws_ok")
    draws_ok = ask["ask_draws_ok"] and rollout_draws_ok
    values = kept["values"]
    if _is_factored(values):
        draws_ok = draws_ok and lowrank_draws_ok(rounds, device, length=int(values.center.shape[0]), rank=int(values.basis.shape[-1]))
    numbers["draws_gap"] = 0.0 if draws_ok else 1.0
    parts = roll.pop("step_parts")
    numbers.update(roll)
    numbers["rounds_gap"] = check_rounds(rounds, config)
    limits = config["limits"]
    return {name: {"value": value, "limit": float(limits[name])} for name, value in numbers.items()}, tells_checked, parts


def replay_round(kept: dict, config: dict, traffic: dict, device) -> Dict[str, float]:
    """The kept round replayed whole by the frozen rollout from the
    program's population, statistics and generator state: the widest
    relative gaps of the scores and the statistics, and the count's. Bit for
    bit on the CPU; a program that rounds otherwise (the card's physics
    kernel) reads chaotic gaps here and stays correct."""
    env, policy = _cell_policy(config, device)
    gen = torch.Generator(device=device)
    gen.set_state(kept["gen_state_before"])
    values = kept["values"]
    if _is_factored(values):
        values = torch.cat(_factored_rows(values, dtype=values.center.dtype))
    out = ref_rollout.rollout(env, policy, values, gen, _reference_stats(kept["stats_before"], device), **_rollout_kwargs(config, traffic))
    return {
        "replay_score_gap": _rel_gap(kept["scores"], out.scores),
        "replay_stats_gap": _stats_gap(kept["stats_after"], out.stats),
        "replay_steps_gap": float(abs((kept["count_after"] - kept["count_before"]) - out.env_steps)),
    }


def control_readings(config, traffic, *, kept: dict, generations: dict, center0, dtype, seed: int) -> Dict[str, float]:
    """The ask's, the bookkeeping's, the statistics' and the tells' numbers
    with the reference computed in ``dtype`` in the program's place: the
    readings that a lower precision gives, the upper readings of those
    numbers' limits."""
    device = center0.device
    out = {"ask_gap": check_ask(kept, np.random.default_rng(seed), device, rows_dtype=dtype)["ask_gap"]}
    roll = check_round(kept, config, traffic, device, dtype=dtype)
    out.update({k: roll[k] for k in ("tally_gap", "stats_gap") if k in roll})
    tells = check_tells(generations, config, center0, dtype=dtype)
    out.update({k: tells[k] for k in ("center_gap", "stdev_gap") if k in tells})
    return out


def unchanged_tell_readings(config, *, generations: dict, center0) -> Dict[str, float]:
    """The tells' numbers of a program whose tell leaves the distribution as
    it was, planted in the window's own data: each generation asks with the
    first generation's center and stdev."""
    first = generations.get(1, {})
    planted = {k: dict(g, mu_ask=first.get("mu_ask"), sigma_ask=first.get("sigma_ask")) for k, g in generations.items() if "mu_ask" in g}
    tells = check_tells(planted, config, center0)
    return {k: tells[k] for k in ("center_gap", "stdev_gap") if k in tells}


def judge(numbers: Dict[str, dict]) -> bool:
    """Correct when every number with a limit is finite and at most it."""
    for item in numbers.values():
        if not math.isfinite(item["value"]) or item["value"] > item["limit"]:
            return False
    return True
