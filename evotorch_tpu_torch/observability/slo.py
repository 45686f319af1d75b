"""Declarative SLO watchdog over the decoded per-group telemetry
(counterpart of ``evotorch_tpu/observability/slo.py``, host-side and ported
whole: the same rules give the same verdicts on the same decoded
telemetry).

Rules are declarative records (``Rule`` or equivalent dicts) checked once
per generation against a decoded
:class:`~evotorch_tpu_torch.observability.devicemetrics.GroupTelemetry`
matrix, the wire the engines already return, so checking costs no extra
device sync. The kinds:

``occupancy_floor``
    every group's (or one group's) lane occupancy must be >= ``threshold``;
    groups allotted no capacity are skipped.
``starvation_ceiling``
    the share of refills in the top queue-wait bucket (waits of 64 steps or
    more) must be <= ``threshold``, per group or global.
``no_steady_compiles``
    the ``steady_compiles`` status key must be 0; skipped when the key is
    absent, as it is in the port, which compiles no programs.
``min_progress``
    every group's (or one group's) env-step count must be >= ``threshold``.
``min_model_efficiency``
    the ``model_efficiency`` status key must be >= ``threshold``; skipped
    when absent.
``max_nonfinite_share``
    the quarantined share must be <= ``threshold``: the exact
    ``eval_nonfinite_share`` status key when present, else the telemetry's
    per-group episode-denominated share.

Three search-health kinds read the float32 health plane and the algorithm
status keys through the :class:`~evotorch_tpu_torch.observability.health.
HealthMonitor` the watchdog owns (``SLOWatchdog.health``;
``state_dict()``/``load_state_dict()`` checkpoint its windows):

``plateau``
    the per-generation score mean (per group, or global with ``group=None``)
    must keep a significant trend; a violation once the no-trend streak
    reaches ``threshold`` generations.
``stdev_collapse``
    the ``stdev_norm`` status key must stay >= ``threshold`` x its first
    value.
``score_snr_floor``
    the score signal-to-noise ratio ``|mean| / std`` must be >=
    ``threshold`` (skipped below 2 scores; a zero std passes).

The verdicts surface as status keys (``slo_ok`` / ``slo_violations`` /
``slo_detail``) through ``VecNE(slo=...)``, suspend a tenant of
``serving.EvalServer``, and give a benchmark verdict through the CLI::

    python -m evotorch_tpu_torch.observability.slo --check-bench bench.log \
        --verdict-out slo_verdict.txt

which reads the last JSON line of a benchmark log, applies the default
rules (``steady_compiles`` 0, a global occupancy floor) and the flags,
writes a one-word ``pass``/``fail``/``insufficient`` verdict file, prints a
JSON verdict line and exits 0 (pass), 1 (fail) or 2 (no decodable line, or
none of the checked keys in it). A partial trailing line is skipped.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Optional, Tuple, Union

from .devicemetrics import GroupTelemetry
from .health import HealthMonitor

__all__ = [
    "Rule",
    "RULE_KINDS",
    "SLOReport",
    "SLOWatchdog",
    "DEFAULT_BENCH_RULES",
]


RULE_KINDS = (
    "occupancy_floor",
    "starvation_ceiling",
    "no_steady_compiles",
    "min_progress",
    "min_model_efficiency",
    "max_nonfinite_share",
    "plateau",
    "stdev_collapse",
    "score_snr_floor",
)


@dataclass(frozen=True)
class Rule:
    """One declarative SLO rule.

    ``group=None`` means "every group" for the per-group kinds (and the
    global figure for ``starvation_ceiling``); an int pins the rule to a
    single group row.
    """

    kind: str
    threshold: float = 0.0
    group: Optional[int] = None

    def __post_init__(self):
        if self.kind not in RULE_KINDS:
            raise ValueError(
                f"unknown SLO rule kind {self.kind!r}; expected one of {RULE_KINDS}"
            )


@dataclass(frozen=True)
class SLOReport:
    """Outcome of one watchdog evaluation (one generation)."""

    ok: bool
    violations: Tuple[str, ...] = field(default_factory=tuple)
    checked: int = 0

    def as_status(self) -> Dict[str, Any]:
        status: Dict[str, Any] = {
            "slo_ok": bool(self.ok),
            "slo_violations": len(self.violations),
        }
        if self.violations:
            status["slo_detail"] = "; ".join(self.violations)
        return status

    def summary(self) -> str:
        if self.ok:
            return f"SLO ok ({self.checked} rules)"
        return f"SLO FAIL ({len(self.violations)}/{self.checked}): " + "; ".join(
            self.violations
        )


def _coerce_rule(rule: Union[Rule, Dict[str, Any]]) -> Rule:
    if isinstance(rule, Rule):
        return rule
    if isinstance(rule, dict):
        return Rule(**rule)
    raise TypeError(f"SLO rule must be a Rule or a dict, got {type(rule).__name__}")


class SLOWatchdog:
    """Evaluates a fixed rule set against per-group telemetry each call.

    The search-health rule kinds (``plateau``, ``stdev_collapse``,
    ``score_snr_floor``) are *stateful*: the watchdog owns a
    :class:`~evotorch_tpu_torch.observability.health.HealthMonitor` whose trend
    windows advance one step per :meth:`check` call.
    ``state_dict()``/``load_state_dict()`` round-trip that window state so
    checkpointed runs resume with identical verdict timing.
    """

    def __init__(
        self,
        rules: Optional[Iterable[Union[Rule, dict]]] = None,
        *,
        health: Optional[HealthMonitor] = None,
    ):
        if rules is None or rules is True:
            rules = DEFAULT_RULES
        self.rules: Tuple[Rule, ...] = tuple(_coerce_rule(r) for r in rules)
        self.health = health if health is not None else HealthMonitor()

    def __repr__(self):
        return f"SLOWatchdog(rules={list(self.rules)!r})"

    # --------------------------------------------------------- serialization
    def state_dict(self) -> Dict[str, Any]:
        return {"health": self.health.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> "SLOWatchdog":
        health_state = state.get("health")
        if health_state:
            self.health.load_state_dict(health_state)
        return self

    # ------------------------------------------------------------ evaluation
    def check(
        self,
        telemetry: Optional[GroupTelemetry],
        *,
        status: Optional[Dict[str, Any]] = None,
    ) -> SLOReport:
        """Evaluate every rule; telemetry=None checks only status-keyed rules."""
        violations = []
        checked = 0
        for rule in self.rules:
            outcome = self._check_rule(rule, telemetry, status or {})
            if outcome is None:  # rule not applicable (no data) — skipped
                continue
            checked += 1
            if outcome:
                violations.append(outcome if isinstance(outcome, str) else str(outcome))
        return SLOReport(
            ok=not violations, violations=tuple(violations), checked=checked
        )

    def _check_rule(self, rule, telemetry, status):
        """Returns None (skipped), False (passed) or a violation string."""
        if rule.kind == "no_steady_compiles":
            compiles = status.get("steady_compiles")
            if compiles is None:
                return None
            if int(compiles) > 0:
                return f"steady_compiles={int(compiles)} (expected 0)"
            return False
        if rule.kind == "min_model_efficiency":
            efficiency = status.get("model_efficiency")
            if efficiency is None:  # no ledger columns on this run — skip
                return None
            if float(efficiency) < rule.threshold:
                return (
                    f"model_efficiency={float(efficiency):.4g} < "
                    f"{rule.threshold:g}"
                )
            return False
        if rule.kind == "max_nonfinite_share":
            share = None
            if rule.group is None:
                share = status.get("eval_nonfinite_share")
            if share is None:
                if telemetry is None:
                    return None
                share = telemetry.nonfinite_share(group=rule.group)
            if float(share) > rule.threshold:
                label = "global" if rule.group is None else f"g{rule.group}"
                return (
                    f"nonfinite_share {label}={float(share):.3f} > "
                    f"{rule.threshold:g}"
                )
            return False
        if rule.kind == "stdev_collapse":
            value = status.get("stdev_norm")
            if value is None:
                return None
            value = float(value)
            self.health.observe("stdev_norm", value, group=rule.group)
            baseline = self.health.baseline("stdev_norm", group=rule.group)
            if baseline is None or baseline <= 0.0:
                return None
            if value < rule.threshold * baseline:
                return (
                    f"stdev_norm={value:.4g} < {rule.threshold:g} x "
                    f"baseline {baseline:.4g} (collapse)"
                )
            return False
        if rule.kind == "plateau":
            # group=None reads the GLOBAL score mean (like
            # starvation_ceiling's global figure), not every group
            value = None
            if telemetry is not None and telemetry.has_health:
                stats = telemetry.score_stats(group=rule.group)
                if stats["count"] > 0:
                    value = stats["mean"]
            if value is None and rule.group is None:
                value = status.get("score_mean", status.get("mean_eval"))
            if value is None:
                return None
            trend = self.health.observe(
                "score_mean", float(value), group=rule.group
            )
            if trend.stall_streak >= max(rule.threshold, 1.0):
                label = "global" if rule.group is None else f"g{rule.group}"
                return (
                    f"plateau {label}: no significant score trend for "
                    f"{trend.stall_streak} generations "
                    f"(|trend| {abs(trend.delta_ewma):.3g} <= "
                    f"noise floor {trend.noise_floor:.3g})"
                )
            return False
        if rule.kind == "score_snr_floor":
            if telemetry is None or not telemetry.has_health:
                return None
            stats = telemetry.score_stats(group=rule.group)
            if stats["count"] < 2:
                return None
            snr = (
                float("inf")
                if stats["std"] <= 0.0
                else abs(stats["mean"]) / stats["std"]
            )
            if snr < rule.threshold:
                label = "global" if rule.group is None else f"g{rule.group}"
                return f"score_snr {label}={snr:.3g} < {rule.threshold:g}"
            return False
        if telemetry is None:
            return None
        groups = (
            range(telemetry.num_groups) if rule.group is None else (rule.group,)
        )
        if rule.kind == "occupancy_floor":
            failed = []
            for g in groups:
                t = telemetry.group(g)
                if t.capacity <= 0:  # no lanes allotted: vacuously true
                    continue
                if t.occupancy < rule.threshold:
                    failed.append(f"g{g}={t.occupancy:.3f}")
            if failed:
                return f"occupancy < {rule.threshold:g}: " + ", ".join(failed)
            return False
        if rule.kind == "starvation_ceiling":
            targets = (None,) if rule.group is None else (rule.group,)
            failed = []
            for g in targets:
                share = telemetry.starvation_share(group=g)
                if share > rule.threshold:
                    label = "global" if g is None else f"g{g}"
                    failed.append(f"{label}={share:.3f}")
            if failed:
                return f"starvation > {rule.threshold:g}: " + ", ".join(failed)
            return False
        if rule.kind == "min_progress":
            failed = []
            for g in groups:
                steps = int(telemetry.group(g).env_steps)
                if steps < rule.threshold:
                    failed.append(f"g{g}={steps}")
            if failed:
                return f"env_steps < {rule.threshold:g}: " + ", ".join(failed)
            return False
        raise AssertionError(rule.kind)  # unreachable: ctor validates


#: defaults when ``VecNE(slo=True)`` asks for a watchdog without
#: spelling rules out: no silent retraces, nobody fully starved
DEFAULT_RULES: Tuple[Rule, ...] = (
    Rule("no_steady_compiles"),
    Rule("starvation_ceiling", threshold=0.5),
    Rule("min_progress", threshold=1),
)

#: battery-verdict defaults for ``--check-bench``: the flagship bench line
#: must be retrace-free and show a sane primary-mode occupancy
DEFAULT_BENCH_RULES: Tuple[Rule, ...] = (
    Rule("no_steady_compiles"),
    Rule("occupancy_floor", threshold=0.1),
)


# ---------------------------------------------------------------- bench CLI
def _score_snr(mean: float, std: float) -> float:
    """|mean| / std; infinite when the spread is exactly zero."""
    return float("inf") if float(std) <= 0.0 else abs(float(mean)) / float(std)


def check_bench_line(
    line: Dict[str, Any],
    *,
    occupancy_floor: float = 0.1,
    min_model_efficiency: Optional[float] = None,
    max_nonfinite_share: Optional[float] = None,
    max_score_collapse: Optional[float] = None,
    min_score_snr: Optional[float] = None,
    max_queue_wait_p99: Optional[float] = None,
) -> SLOReport:
    """Apply the battery rules to one decoded bench.py JSON line.

    The bench line carries scalars, not a (G, K) matrix, so this reads the
    top-level ``occupancy`` / ``steady_compiles`` keys (plus per-mode
    occupancies under ``modes``) directly. With ``min_model_efficiency``
    set, the program-ledger efficiency columns (``model_efficiency``,
    top-level and per contract under ``modes`` — present when the line was
    produced with BENCH_LEDGER=1) must each clear the floor; a line with
    no ledger columns skips those checks (missing analysis degrades, it
    doesn't fail).

    The health-plane flags read the ``score_mean`` / ``score_std`` columns
    (present when the line was produced with BENCH_HEALTH=1, the default):
    ``max_score_collapse`` fails when the score SNR ``|mean| / std``
    EXCEEDS the ceiling (the population's spread collapsed below 1/T of
    its mean scale — stdev-collapse seen from the score side);
    ``min_score_snr`` fails when the SNR is below the floor (the scores
    are noise-dominated). Lines without the columns skip both.

    ``max_queue_wait_p99`` gates the tail of the refill queue-wait
    distribution (in loop steps, from the on-device histograms): the
    top-level ``queue_wait_p99``, every per-mode one under ``modes``, and
    the serving A/B's ``serve_queue_wait_p99`` (a BENCH_SERVE=1 line) must
    each stay at or below the ceiling — the multi-tenant fairness gate.
    Lines without the columns skip the check.
    """
    violations = []
    checked = 0

    def _check_queue_wait(value, label):
        nonlocal checked
        if max_queue_wait_p99 is None or value is None:
            return
        checked += 1
        if float(value) > max_queue_wait_p99:
            violations.append(
                f"{label}queue_wait_p99={float(value):g} > {max_queue_wait_p99:g}"
            )

    _check_queue_wait(line.get("queue_wait_p99"), "")
    _check_queue_wait(line.get("serve_queue_wait_p99"), "serve_")
    compiles = line.get("steady_compiles")
    if compiles is not None:
        checked += 1
        if int(compiles) > 0:
            violations.append(f"steady_compiles={int(compiles)} (expected 0)")
    occ = line.get("occupancy")
    if occ is not None:
        checked += 1
        if float(occ) < occupancy_floor:
            violations.append(f"occupancy={float(occ):.3f} < {occupancy_floor:g}")
    nfs = line.get("eval_nonfinite_share")
    if max_nonfinite_share is not None and nfs is not None:
        checked += 1
        if float(nfs) > max_nonfinite_share:
            violations.append(
                f"eval_nonfinite_share={float(nfs):.3f} > {max_nonfinite_share:g}"
            )
    eff = line.get("model_efficiency")
    if min_model_efficiency is not None and eff is not None:
        checked += 1
        if float(eff) < min_model_efficiency:
            violations.append(
                f"model_efficiency={float(eff):.4g} < {min_model_efficiency:g}"
            )

    def _check_health(mean, std, label):
        nonlocal checked
        if mean is None or std is None:
            return
        snr = _score_snr(mean, std)
        if max_score_collapse is not None:
            checked += 1
            if snr > max_score_collapse:
                violations.append(
                    f"{label}score_snr={snr:.3g} > {max_score_collapse:g} "
                    "(score spread collapsed)"
                )
        if min_score_snr is not None:
            checked += 1
            if snr < min_score_snr:
                violations.append(
                    f"{label}score_snr={snr:.3g} < {min_score_snr:g}"
                )

    _check_health(line.get("score_mean"), line.get("score_std"), "")
    modes = line.get("modes") or {}
    for mode, rec in sorted(modes.items()):
        if not isinstance(rec, dict):
            continue
        mocc = rec.get("occupancy")
        if mocc is not None:
            checked += 1
            if float(mocc) < occupancy_floor:
                violations.append(
                    f"modes.{mode}.occupancy={float(mocc):.3f} < {occupancy_floor:g}"
                )
        meff = rec.get("model_efficiency")
        if min_model_efficiency is not None and meff is not None:
            checked += 1
            if float(meff) < min_model_efficiency:
                violations.append(
                    f"modes.{mode}.model_efficiency={float(meff):.4g} < "
                    f"{min_model_efficiency:g}"
                )
        _check_health(
            rec.get("score_mean"), rec.get("score_std"), f"modes.{mode}."
        )
        _check_queue_wait(rec.get("queue_wait_p99"), f"modes.{mode}.")
    return SLOReport(ok=not violations, violations=tuple(violations), checked=checked)


def _last_json_line(path: str) -> Optional[Dict[str, Any]]:
    """The last decodable JSON line of the log, or None when there is none.

    A crashed writer leaves a partial trailing line; that (and any other
    non-JSON noise) is skipped, not raised — the last COMPLETE line wins.
    """
    last = None
    with open(path, "r", encoding="utf-8") as fh:
        for raw in fh:
            raw = raw.strip()
            if not raw or not raw.startswith("{"):
                continue
            try:
                last = json.loads(raw)
            except json.JSONDecodeError:  # partial/corrupt row — skip it
                continue
    return last


def _main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="SLO watchdog: verdict over a bench.py JSON log"
    )
    parser.add_argument(
        "--check-bench",
        metavar="LOG",
        required=True,
        help="bench log; the LAST JSON line is checked",
    )
    parser.add_argument(
        "--occupancy-floor",
        type=float,
        default=0.1,
        help="minimum acceptable occupancy, global and per mode (default 0.1)",
    )
    parser.add_argument(
        "--min-model-efficiency",
        type=float,
        default=None,
        help="minimum acceptable program-ledger model_efficiency, global "
        "and per contract (default: unchecked; needs a BENCH_LEDGER=1 line)",
    )
    parser.add_argument(
        "--max-nonfinite-share",
        type=float,
        default=None,
        help="maximum acceptable eval_nonfinite_share (quarantined share of "
        "the population; default: unchecked)",
    )
    parser.add_argument(
        "--max-score-collapse",
        type=float,
        default=None,
        help="maximum acceptable score SNR |score_mean|/score_std, global "
        "and per contract — above it the population spread has collapsed "
        "(default: unchecked; needs a BENCH_HEALTH=1 line)",
    )
    parser.add_argument(
        "--min-score-snr",
        type=float,
        default=None,
        help="minimum acceptable score SNR |score_mean|/score_std — below "
        "it the scores are noise-dominated (default: unchecked)",
    )
    parser.add_argument(
        "--max-queue-wait-p99",
        type=float,
        default=None,
        help="maximum acceptable refill queue-wait p99 (loop steps), "
        "top-level, per contract and for the serving A/B "
        "(default: unchecked; needs histogrammed refill events)",
    )
    parser.add_argument(
        "--verdict-out",
        metavar="PATH",
        default=None,
        help="write a one-word pass/fail/insufficient verdict file",
    )
    args = parser.parse_args(argv)

    line = _last_json_line(args.check_bench)
    if line is None:
        report = SLOReport(ok=False, violations=(), checked=0)
    else:
        report = check_bench_line(
            line,
            occupancy_floor=args.occupancy_floor,
            min_model_efficiency=args.min_model_efficiency,
            max_nonfinite_share=args.max_nonfinite_share,
            max_score_collapse=args.max_score_collapse,
            min_score_snr=args.min_score_snr,
            max_queue_wait_p99=args.max_queue_wait_p99,
        )
    if report.checked == 0:
        # no decodable line, or a line with none of the checked keys (e.g.
        # BENCH_TELEMETRY=0): missing data is not a pass and not a fail
        verdict, code = "insufficient", 2
    elif report.ok:
        verdict, code = "pass", 0
    else:
        verdict, code = "fail", 1
    if args.verdict_out:
        with open(args.verdict_out, "w", encoding="utf-8") as fh:
            fh.write(verdict + "\n")
    print(
        json.dumps(
            {
                "slo_verdict": verdict,
                "slo_checked": report.checked,
                "slo_violations": list(report.violations),
                "source": args.check_bench,
            },
            sort_keys=True,
        )
    )
    return code


if __name__ == "__main__":
    raise SystemExit(_main())
