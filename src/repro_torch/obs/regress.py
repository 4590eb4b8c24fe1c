"""Noise-aware perf-regression sentinel over ``BENCH_denoise.json`` (a copy
of the reference's ``repro.obs.regress``).

The bench file is an append-only log: every CI run and local sweep adds
points, so each ``(name, kind, identity)`` family accumulates a history.
This module turns that history into a *guarded signal*: the newest point
in each family is compared against the family's baseline (the prior
points) and judged ``ok`` / ``regressed`` / ``improved`` /
``insufficient-history`` / ``unguarded``.

The discipline mirrors ``benchmarks/table15_observability``'s paired
overhead gate, which never trusts a single estimator: there the gate is
``min(median_ratio, floor_ratio) <= budget`` so one noisy interleaved
pair cannot fail the build. Here a family only counts as **regressed
when two independent estimators agree**:

* the latest value is beyond the per-kind threshold from the **median**
  of the baseline (central tendency), **and**
* the latest value is strictly outside the baseline's observed
  **envelope** (worse than every retained baseline point — i.e. outside
  the noise floor the history itself demonstrates).

``improved`` is the mirror image. Families with fewer than
``min_history`` baseline points get an explicit ``insufficient-history``
verdict — never a silent pass — and kinds without a rule are
``unguarded`` (also explicit). Points are ordered by the ``run_seq``
stamp ``benchmarks/common.py::bench_record`` writes (monotone, derived
from file contents, so ordering never trusts wall-clock timestamps);
legacy points without one keep file order and sort before stamped ones.

Stdlib-only, like the rest of ``repro_torch.obs``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
from typing import Any, Iterable

__all__ = [
    "Rule",
    "KIND_RULES",
    "VERDICTS",
    "load_points",
    "family_key",
    "analyze",
    "render_report",
    "MIN_HISTORY",
]

#: baseline points required before a family is judged at all
MIN_HISTORY = 3

#: newest baseline points retained per family (older history ages out)
BASELINE_DEPTH = 8

VERDICTS = ("ok", "regressed", "improved", "insufficient-history", "unguarded")


@dataclasses.dataclass(frozen=True)
class Rule:
    """How one point kind is judged.

    ``field`` is the metric extracted from each point; ``direction`` is
    which way is good (``higher`` / ``lower``); exactly one of
    ``rel_tol`` (fractional distance from the baseline median, for
    ratio-like metrics) or ``abs_tol`` (absolute distance, for dB-scale
    metrics where ratios are meaningless near zero) is the threshold.
    """

    field: str
    direction: str  # "higher" | "lower"
    rel_tol: float = 0.0
    abs_tol: float = 0.0

    def __post_init__(self):
        if self.direction not in ("higher", "lower"):
            raise ValueError(f"direction must be higher|lower, got {self.direction!r}")
        if (self.rel_tol > 0) == (self.abs_tol > 0):
            raise ValueError("exactly one of rel_tol/abs_tol must be > 0")


#: per-kind judgement rules (kinds map to BENCHMARKS.md's point schema)
KIND_RULES: dict[str, Rule] = {
    "speedup": Rule("speedup", "higher", rel_tol=0.10),
    "kernel": Rule("speedup", "higher", rel_tol=0.10),
    "executor": Rule("speedup", "higher", rel_tol=0.10),
    "multitenant": Rule("speedup", "higher", rel_tol=0.10),
    "bandwidth": Rule("speedup", "higher", rel_tol=0.10),
    "fleet": Rule("aggregate_fps", "higher", rel_tol=0.15),
    "throughput": Rule("mb_per_s", "higher", rel_tol=0.15),
    "snr": Rule("snr_db", "higher", abs_tol=0.5),
    "snr_gain": Rule("gain_db", "higher", abs_tol=0.5),
    "obs_overhead": Rule("ratio_disabled", "lower", rel_tol=0.03),
    "slo": Rule("overhead_ratio", "lower", rel_tol=0.03),
    # table17 autoscale family: capacity (sessions sustained at a fixed
    # SLO, higher is better) and reaction (flash-crowd onset -> scale-up
    # mark in virtual seconds, lower is better). Virtual-clock metrics
    # are stable, so modest tolerances suffice.
    "autoscale": Rule("sustained_sessions", "higher", rel_tol=0.20),
    "autoscale_reaction": Rule("reaction_s", "lower", rel_tol=0.25),
}


def load_points(path: str) -> list[dict]:
    """Points from a BENCH json file (list of dicts; non-dicts dropped)."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, list):
        raise ValueError(f"{path}: expected a JSON list of points")
    return [p for p in doc if isinstance(p, dict)]


def family_key(point: dict) -> str:
    """Stable identity of the family a point belongs to.

    name + kind + every configuration-like field: strings and dicts
    (``config``, plan descriptions, filter/regime labels) are identity;
    numeric and boolean fields are measurements/outcomes and are not.
    ``run_seq``/``timestamp`` are ordering, never identity.
    """
    ident: dict[str, Any] = {}
    for k in sorted(point):
        if k in ("run_seq", "timestamp", "ts"):
            continue
        v = point[k]
        if isinstance(v, str) or isinstance(v, dict):
            ident[k] = v
    return json.dumps(ident, sort_keys=True)


def _ordered(points: Iterable[tuple[int, dict]]) -> list[dict]:
    """Family points oldest->newest: legacy (no run_seq) keep file order
    and precede stamped points, stamped points sort by run_seq."""

    def sort_key(item: tuple[int, dict]):
        idx, p = item
        seq = p.get("run_seq")
        if isinstance(seq, (int, float)) and not isinstance(seq, bool):
            return (1, float(seq), idx)
        return (0, float(idx), idx)

    return [p for _, p in sorted(points, key=sort_key)]


def _judge(values: list[float], rule: Rule, min_history: int) -> dict:
    """Verdict dict for one family's ordered metric values."""
    latest = values[-1]
    base = values[:-1][-BASELINE_DEPTH:]
    out: dict[str, Any] = {
        "latest": latest,
        "baseline_n": len(base),
        "field": rule.field,
        "direction": rule.direction,
    }
    if len(base) < min_history:
        out["verdict"] = "insufficient-history"
        return out
    med = statistics.median(base)
    lo, hi = min(base), max(base)
    out.update({"baseline_median": med, "baseline_min": lo, "baseline_max": hi})
    if rule.rel_tol > 0:
        worse = med * (1.0 - rule.rel_tol)
        better = med * (1.0 + rule.rel_tol)
        if rule.direction == "lower":
            worse = med * (1.0 + rule.rel_tol)
            better = med * (1.0 - rule.rel_tol)
    else:
        worse = med - rule.abs_tol
        better = med + rule.abs_tol
        if rule.direction == "lower":
            worse = med + rule.abs_tol
            better = med - rule.abs_tol
    if rule.direction == "higher":
        regressed = latest < worse and latest < lo
        improved = latest > better and latest > hi
    else:
        regressed = latest > worse and latest > hi
        improved = latest < better and latest < lo
    out["verdict"] = "regressed" if regressed else ("improved" if improved else "ok")
    return out


def analyze(
    points: list[dict],
    *,
    rules: dict[str, Rule] | None = None,
    min_history: int = MIN_HISTORY,
) -> dict:
    """Judge every point family; returns the full verdict report.

    ``{"families": {key: {...verdict row...}}, "summary": {verdict:
    count}, "points": N}`` — ``render_report`` turns it into terminal
    lines, ``scripts/bench_regress.py`` writes it as the CI artifact.
    """
    rules = KIND_RULES if rules is None else rules
    groups: dict[str, list[tuple[int, dict]]] = {}
    for idx, p in enumerate(points):
        groups.setdefault(family_key(p), []).append((idx, p))
    families: dict[str, dict] = {}
    summary = {v: 0 for v in VERDICTS}
    for key, members in sorted(groups.items()):
        ordered = _ordered(members)
        head = ordered[-1]
        kind = str(head.get("kind", ""))
        row: dict[str, Any] = {
            "name": head.get("name", "?"),
            "kind": kind,
            "points": len(ordered),
        }
        rule = rules.get(kind)
        if rule is None:
            row["verdict"] = "unguarded"
        else:
            values = [
                float(p[rule.field])
                for p in ordered
                if isinstance(p.get(rule.field), (int, float))
                and not isinstance(p.get(rule.field), bool)
            ]
            if not values:
                row["verdict"] = "unguarded"
                row["note"] = f"no numeric {rule.field!r} in family"
            else:
                row.update(_judge(values, rule, min_history))
        summary[row["verdict"]] += 1
        families[key] = row
    return {"points": len(points), "families": families, "summary": summary}


def render_report(report: dict, *, verbose: bool = False) -> str:
    """Terminal rendering: one line per non-ok family (all with verbose)."""
    lines = []
    order = {"regressed": 0, "insufficient-history": 1, "improved": 2, "ok": 3, "unguarded": 4}
    rows = sorted(
        report["families"].values(),
        key=lambda r: (order.get(r["verdict"], 9), str(r["name"])),
    )
    for row in rows:
        if not verbose and row["verdict"] in ("ok", "unguarded"):
            continue
        detail = ""
        if "latest" in row and "baseline_median" in row:
            detail = (
                f" {row['field']}={row['latest']:.4g}"
                f" baseline(median={row['baseline_median']:.4g},"
                f" n={row['baseline_n']})"
            )
        elif "latest" in row:
            detail = f" {row['field']}={row['latest']:.4g} n={row['baseline_n']}"
        lines.append(f"{row['verdict']:<21} {row['name']} [{row['kind']}]{detail}")
    s = report["summary"]
    lines.append(
        "summary: "
        + " ".join(f"{k}={s[k]}" for k in VERDICTS)
        + f" (points={report['points']})"
    )
    return "\n".join(lines)
