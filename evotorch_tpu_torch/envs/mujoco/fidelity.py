"""Matched-action env-fidelity harness: the port's native torch envs
against real MuJoCo (counterpart of ``evotorch_tpu/envs/mujoco/fidelity.py``).

Both simulators are driven with **identical action sequences** (smooth
AR(1) exploration noise, plus an all-zero sequence: the zero-action drift
diagnostic); per-step reward terms are recorded on each side
(``batch_reward_terms`` on the native envs, ``MjVecEnv.last_terms`` on the
real ones), and the report summarizes per-term divergence: the means on
each side, the mean absolute per-step difference, and the correlation of
the per-step traces over the steps where both sims are still alive.

The two engines integrate different body plans with different contact
models, so per-step traces are *not* expected to match; the comparison
measures whether the native tasks put the policy in the same reward regime
(velocity scale, control-cost scale, survival) as the canonical benchmark.

Run as a module (host physics; the native envs on ``--device``, the card
unless given)::

    python -m evotorch_tpu_torch.envs.mujoco.fidelity \
        --pairs halfcheetah,walker2d --seqs 8 --steps 300 --device cpu
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["PAIRS", "run_fidelity", "format_fidelity_markdown"]

# native registry name -> (real gymnasium id, native env kwargs)
PAIRS: Dict[str, tuple] = {
    "halfcheetah": ("HalfCheetah-v5", {}),
    "walker2d": ("Walker2d-v5", {}),
    # survival-only pair: the native cartpole is the closest dynamics match
    # to InvertedPendulum-v5 (cart + pole, |angle| termination); only the
    # total-reward / episode statistics are comparable
    "cartpole": ("InvertedPendulum-v5", {"continuous_actions": True}),
}


def _action_sequences(rng: np.random.Generator, n_seqs: int, n_steps: int, act_dim: int):
    """Smooth AR(1) exploration actions in [-1, 1]; sequence 0 is all-zero
    (the zero-action drift check — free reward on either sim shows up as a
    nonzero velocity mean in that lane)."""
    rho, amp = 0.8, 0.6
    acts = np.zeros((n_seqs, n_steps, act_dim))
    for s in range(1, n_seqs):
        a = np.zeros(act_dim)
        for t in range(n_steps):
            a = rho * a + np.sqrt(1.0 - rho * rho) * rng.normal(0.0, amp, act_dim)
            acts[s, t] = a
    return np.clip(acts, -1.0, 1.0)


def _native_trajectories(env, actions: np.ndarray, seed: int) -> Dict[str, np.ndarray]:
    """Drive the native env with ``actions`` ``(S, T, na)`` from resets drawn
    by a generator seeded with ``seed``; returns per-step ``(S, T)`` term
    traces (NaN once a lane's episode has ended) and ``alive``."""
    import torch

    S, T, _ = actions.shape
    generator = torch.Generator(device=env.device).manual_seed(int(seed))
    state, _ = env.batch_reset(S, generator)
    has_terms = hasattr(env, "batch_reward_terms")

    out = {"reward_total": np.full((S, T), np.nan), "alive": np.zeros((S, T), bool)}
    active = np.ones(S, dtype=bool)
    for t in range(T):
        a = torch.as_tensor(actions[:, t, :], dtype=torch.float32, device=env.device)
        state, _, reward, done = env.batch_step(state, a)
        reward, done = reward.cpu().numpy(), done.cpu().numpy()
        out["reward_total"][active, t] = reward[active]
        out["alive"][:, t] = active
        if has_terms:
            terms = env.batch_reward_terms(state.obs_state, torch.clamp(a, -1.0, 1.0).T)
            for name in ("x_velocity", "reward_ctrl", "reward_survive"):
                trace = out.setdefault(name, np.full((S, T), np.nan))
                trace[active, t] = terms[name].cpu().numpy()[active]
        active = active & ~done
        if not active.any():
            break
    return out


def _mujoco_trajectories(env_id: str, actions: np.ndarray, seed: int) -> Dict[str, np.ndarray]:
    """Same trace collection on the real env through :class:`MjVecEnv` (one
    lane per action sequence, single episode per lane)."""
    import gymnasium as gym

    from .mjvecenv import MjVecEnv

    S, T, _ = actions.shape
    venv = MjVecEnv(lambda: gym.make(env_id), S)
    try:
        venv.seed([seed + i for i in range(S)])
        venv.reset()
        out = {"reward_total": np.full((S, T), np.nan), "alive": np.zeros((S, T), bool)}
        active = np.ones(S, dtype=bool)
        for t in range(T):
            _, rewards, dones = venv.step(actions[:, t, :], active=active)
            out["reward_total"][active, t] = rewards[active]
            out["alive"][:, t] = active
            for name in ("x_velocity", "reward_ctrl", "reward_survive"):
                if name in venv.last_terms:
                    trace = out.setdefault(name, np.full((S, T), np.nan))
                    trace[active, t] = venv.last_terms[name][active]
            active = active & ~dones
            if not active.any():
                break
        return out
    finally:
        venv.close()


def _term_summary(native: np.ndarray, mujoco: np.ndarray, both: np.ndarray) -> dict:
    a, b = native[both], mujoco[both]
    summary = {
        "native_mean": float(np.nanmean(native)),
        "mujoco_mean": float(np.nanmean(mujoco)),
        "matched_steps": int(both.sum()),
    }
    if a.size >= 2:
        summary["mean_abs_diff"] = float(np.mean(np.abs(a - b)))
        sa, sb = np.std(a), np.std(b)
        summary["corr"] = (
            float(np.corrcoef(a, b)[0, 1]) if sa > 1e-12 and sb > 1e-12 else None
        )
    return summary


def run_fidelity(
    pairs: Optional[Sequence[str]] = None,
    *,
    n_seqs: int = 8,
    n_steps: int = 300,
    seed: int = 0,
    device=None,
) -> dict:
    """Run the matched-action comparison for each named pair (default: all of
    :data:`PAIRS`), the native envs on ``device`` (the card unless given),
    and return the report dict (JSON-serializable)."""
    from ..._device import resolve_device
    from ..registry import make_env

    device = resolve_device(device)

    names = list(PAIRS) if pairs is None else list(pairs)
    report = {
        "config": {"n_seqs": n_seqs, "n_steps": n_steps, "seed": seed},
        "pairs": {},
    }
    rng = np.random.default_rng(seed)
    for name in names:
        env_id, native_kwargs = PAIRS[name]
        env = make_env(name, device=device, **native_kwargs)
        act_dim = int(np.prod(env.action_space.shape))
        import gymnasium as gym

        probe = gym.make(env_id)
        mj_act_dim = int(np.prod(probe.action_space.shape))
        probe.close()
        if act_dim != mj_act_dim:
            raise ValueError(
                f"{name}: native action dim {act_dim} != {env_id} dim {mj_act_dim}"
            )
        actions = _action_sequences(rng, n_seqs, n_steps, act_dim)
        native = _native_trajectories(env, actions, seed)
        mujoco = _mujoco_trajectories(env_id, actions, seed)

        both = native["alive"] & mujoco["alive"]
        terms = {}
        for term in ("x_velocity", "reward_ctrl", "reward_survive", "reward_total"):
            if term in native and term in mujoco:
                terms[term] = _term_summary(native[term], mujoco[term], both)
        # zero-action drift: lane 0 carries the all-zero action sequence
        zero_drift = {}
        for side, traces in (("native", native), ("mujoco", mujoco)):
            if "x_velocity" in traces:
                lane = traces["x_velocity"][0]
                zero_drift[f"{side}_mean_velocity"] = float(np.nanmean(lane))
        pair_report = {
            "mujoco_env": env_id,
            "action_dim": act_dim,
            "native_weights": {
                "forward_reward_weight": float(getattr(env, "forward_reward_weight", 0.0)),
                "ctrl_cost_weight": float(getattr(env, "ctrl_cost_weight", 0.0)),
                "alive_bonus": float(getattr(env, "alive_bonus", 0.0)),
            },
            "terms": terms,
            "episode": {
                "native_mean_length": float(native["alive"].sum(axis=1).mean()),
                "mujoco_mean_length": float(mujoco["alive"].sum(axis=1).mean()),
            },
        }
        if zero_drift:
            pair_report["zero_action_drift"] = zero_drift
        report["pairs"][name] = pair_report
    return report


def format_fidelity_markdown(report: dict) -> str:
    """The report as markdown: one table per pair."""
    cfg = report["config"]
    lines = [
        "### Env-fidelity: native rigid-body vs real MuJoCo `-v5` (matched actions)",
        "",
        f"Harness: `python -m evotorch_tpu_torch.envs.mujoco.fidelity` — "
        f"{cfg['n_seqs']} AR(1) action sequences (one all-zero) x "
        f"{cfg['n_steps']} steps, seed {cfg['seed']}. Per-step terms compared "
        "over the steps where both sims are alive.",
        "",
    ]
    for name, pair in report["pairs"].items():
        lines.append(f"**{name} vs {pair['mujoco_env']}**")
        lines.append("")
        lines.append("| term | native mean | mujoco mean | mean abs diff | corr |")
        lines.append("|---|---|---|---|---|")
        for term, s in pair["terms"].items():
            corr = s.get("corr")
            lines.append(
                f"| {term} | {s['native_mean']:+.3f} | {s['mujoco_mean']:+.3f} | "
                f"{s.get('mean_abs_diff', float('nan')):.3f} | "
                f"{'n/a' if corr is None else f'{corr:+.2f}'} |"
            )
        ep = pair["episode"]
        lines.append(
            f"| episode length | {ep['native_mean_length']:.0f} | "
            f"{ep['mujoco_mean_length']:.0f} | | |"
        )
        drift = pair.get("zero_action_drift")
        if drift:
            lines.append("")
            lines.append(
                "Zero-action drift (mean forward velocity, all-zero lane): "
                + ", ".join(f"{k} = {v:+.3f} m/s" for k, v in drift.items())
            )
        lines.append("")
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--pairs", default=None, help="comma list (default: all)")
    parser.add_argument("--seqs", type=int, default=8)
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None, help="write the JSON report here")
    parser.add_argument("--markdown", action="store_true", help="print the report as markdown")
    parser.add_argument("--device", default=None, help="the native envs' device (default: the card)")
    args = parser.parse_args(argv)

    pairs = None if args.pairs is None else [p.strip() for p in args.pairs.split(",") if p.strip()]
    report = run_fidelity(pairs, n_seqs=args.seqs, n_steps=args.steps, seed=args.seed, device=args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    if args.markdown:
        print(format_fidelity_markdown(report))
    else:
        print(json.dumps(report))


if __name__ == "__main__":
    main()
