"""Noise-aware regression gate over two ``BENCH_*.json`` reports.

A naive percent threshold either cries wolf on noisy cells or sleeps
through regressions on quiet ones.  This gate uses each cell's *measured
spread*: a cell regresses only when the new median sits outside the old
median by more than ``k`` times the BASELINE run's inter-quartile range
(the same robust statistic the timing protocol's outlier rejection uses),
with a small relative floor so a zero-IQR cell cannot flag on scheduler
jitter.  The band deliberately ignores the candidate run's own spread —
a regression that also inflates its variance must not widen its own gate.

Cells are keyed by (scenario, chip); only ``kind == "measured"`` rows are
gated — ``kind == "model"`` rows are deterministic roofline predictions,
so a change there is a code change, not a measurement regression.

``normalize=True`` additionally divides the new medians by the run-pair's
global median ratio before gating, so a uniformly slower/faster *host*
(CI machine lottery) does not drown the one kernel that actually
regressed: only cells that move relative to the rest of their own sweep
can fail.

Serving cells carry two extra gated metrics beyond ``us_median``, emitted
as synthetic ``scenario:metric`` rows: ``tokens_per_s`` (higher is
better, so the verdict is inverted; under ``normalize`` the new value is
*multiplied* by the host scale, since a uniformly slower host depresses
throughput by exactly the factor it inflates latencies) and
``cache_hit_ratio`` (a deterministic scheduling property in [0, 1], gated
with a small absolute band and never host-normalized).

The verdict rows serialize to an ``obs-compare`` JSON document that
``experiments/make_report.py`` renders and CI archives next to the bench
trajectory.  A copy of ``repro.obs.compare`` that reads the port's own
``bench.results``, so a host without jax can gate the port's rows.
"""
from __future__ import annotations

import json
import statistics
from dataclasses import dataclass, field
from typing import Any, Dict, IO, List, Optional, Tuple, Union

from ..bench.results import BenchReport, BenchResult
from .metrics import quantile

__all__ = ["CellVerdict", "CompareResult", "compare_reports",
           "format_compare", "cell_noise_us", "DEFAULT_K",
           "DEFAULT_REL_FLOOR"]

#: how many IQRs outside the baseline median a cell must move to flag.
DEFAULT_K = 3.0

#: relative noise floor: |delta| below this fraction of the baseline median
#: never flags, even for a cell whose measured spread was ~0.
DEFAULT_REL_FLOOR = 0.05

#: IQR ~= 1.349 sigma for a normal distribution — the fallback when a row
#: carries only ``us_std`` (reports written before raw trials were kept).
_STD_TO_IQR = 1.349

#: hit ratio is deterministic given the trace, but admission order can
#: shift a block boundary; allow this much absolute movement before
#: flagging.
HIT_RATIO_BAND = 0.02

#: extra per-cell metrics gated as synthetic ``scenario:metric`` rows:
#: (key, higher_is_better, absolute band or None for rel_floor * base,
#:  host_scaled).  Cells lacking the key (all kernel rows) are skipped.
_EXTRA_METRICS = (
    ("tokens_per_s", True, None, True),
    ("cache_hit_ratio", True, HIT_RATIO_BAND, False),
)


def _iqr(samples: List[float]) -> float:
    s = sorted(samples)
    return quantile(s, 0.75) - quantile(s, 0.25)


def cell_noise_us(metrics: Dict[str, Any]) -> float:
    """One cell's measured spread in microseconds: the IQR of its kept
    trial times when the row carries them, else derived from the std."""
    times = metrics.get("times_us")
    if isinstance(times, (list, tuple)) and len(times) >= 4:
        return _iqr([float(t) for t in times])
    return _STD_TO_IQR * float(metrics.get("us_std", 0.0) or 0.0)


@dataclass
class CellVerdict:
    """Gate outcome for one (scenario, chip) cell."""
    scenario: str
    chip: str
    kernel: str = ""
    strategy: str = ""
    verdict: str = "pass"       # pass | regress | improve | new | missing
    base_us: Optional[float] = None
    new_us: Optional[float] = None
    adj_new_us: Optional[float] = None   # after host normalization
    band_us: float = 0.0        # +/- noise band around the baseline median
    delta_pct: float = 0.0      # (adj_new - base) / base * 100

    def to_dict(self) -> Dict[str, Any]:
        return {"scenario": self.scenario, "chip": self.chip,
                "kernel": self.kernel, "strategy": self.strategy,
                "verdict": self.verdict, "base_us": self.base_us,
                "new_us": self.new_us, "adj_new_us": self.adj_new_us,
                "band_us": self.band_us, "delta_pct": self.delta_pct}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CellVerdict":
        return cls(**d)


@dataclass
class CompareResult:
    """All verdicts plus the gate summary; serializes to obs-compare JSON."""
    verdicts: List[CellVerdict] = field(default_factory=list)
    k: float = DEFAULT_K
    rel_floor: float = DEFAULT_REL_FLOOR
    host_scale: float = 1.0     # global new/base median ratio (1.0 = off)
    normalized: bool = False

    def counts(self) -> Dict[str, int]:
        out = {"pass": 0, "regress": 0, "improve": 0, "new": 0, "missing": 0}
        for v in self.verdicts:
            out[v.verdict] = out.get(v.verdict, 0) + 1
        return out

    @property
    def n_regressions(self) -> int:
        return self.counts()["regress"]

    def to_dict(self) -> Dict[str, Any]:
        return {"schema_version": 1, "kind": "obs-compare",
                "k": self.k, "rel_floor": self.rel_floor,
                "host_scale": self.host_scale,
                "normalized": self.normalized,
                "counts": self.counts(),
                "rows": [v.to_dict() for v in self.verdicts]}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CompareResult":
        if d.get("kind") != "obs-compare":
            raise ValueError("not an obs-compare document")
        return cls(verdicts=[CellVerdict.from_dict(r)
                             for r in d.get("rows", [])],
                   k=d.get("k", DEFAULT_K),
                   rel_floor=d.get("rel_floor", DEFAULT_REL_FLOOR),
                   host_scale=d.get("host_scale", 1.0),
                   normalized=d.get("normalized", False))

    def save(self, out: Union[str, IO[str]]) -> None:
        if hasattr(out, "write"):
            json.dump(self.to_dict(), out, indent=1, sort_keys=True)
            out.write("\n")
        else:
            with open(out, "w") as f:
                json.dump(self.to_dict(), f, indent=1, sort_keys=True)
                f.write("\n")

    @classmethod
    def load(cls, path: str) -> "CompareResult":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def _measured_cells(report: BenchReport) -> Dict[Tuple[str, str], BenchResult]:
    cells = {}
    for r in report.results:
        if r.kind == "measured" and "us_median" in r.metrics:
            cells[(r.scenario, r.chip)] = r
    return cells


def compare_reports(base: BenchReport, new: BenchReport, *,
                    k: float = DEFAULT_K,
                    rel_floor: float = DEFAULT_REL_FLOOR,
                    normalize: bool = False) -> CompareResult:
    """Gate ``new`` against ``base``; see the module docstring for the
    noise model.  Returns every cell's verdict (sorted, regressions
    first) plus the applied parameters."""
    base_cells = _measured_cells(base)
    new_cells = _measured_cells(new)
    common = sorted(set(base_cells) & set(new_cells))

    scale = 1.0
    if normalize and common:
        ratios = [new_cells[c].metrics["us_median"]
                  / base_cells[c].metrics["us_median"]
                  for c in common
                  if base_cells[c].metrics["us_median"] > 0]
        if ratios:
            scale = statistics.median(ratios)
            scale = scale if scale > 0 else 1.0

    verdicts: List[CellVerdict] = []
    for cell in common:
        b, n = base_cells[cell], new_cells[cell]
        base_us = float(b.metrics["us_median"])
        new_us = float(n.metrics["us_median"])
        adj_new = new_us / scale
        band = max(k * cell_noise_us(b.metrics), rel_floor * base_us)
        if adj_new > base_us + band:
            verdict = "regress"
        elif adj_new < base_us - band:
            verdict = "improve"
        else:
            verdict = "pass"
        verdicts.append(CellVerdict(
            scenario=b.scenario, chip=b.chip, kernel=b.kernel,
            strategy=n.strategy, verdict=verdict, base_us=base_us,
            new_us=new_us, adj_new_us=adj_new, band_us=band,
            delta_pct=((adj_new - base_us) / base_us * 100.0
                       if base_us else 0.0)))
        for key, higher_better, abs_band, scaled in _EXTRA_METRICS:
            if key not in b.metrics or key not in n.metrics:
                continue
            base_v = float(b.metrics[key])
            new_v = float(n.metrics[key])
            # a slower host divides throughput where it multiplies time,
            # so the correction runs the other way for these rows
            adj_v = new_v * scale if scaled else new_v
            vband = (abs_band if abs_band is not None
                     else rel_floor * abs(base_v))
            lo, hi = base_v - vband, base_v + vband
            if adj_v < lo:
                mverdict = "regress" if higher_better else "improve"
            elif adj_v > hi:
                mverdict = "improve" if higher_better else "regress"
            else:
                mverdict = "pass"
            verdicts.append(CellVerdict(
                scenario=f"{b.scenario}:{key}", chip=b.chip,
                kernel=b.kernel, strategy=n.strategy, verdict=mverdict,
                base_us=base_v, new_us=new_v, adj_new_us=adj_v,
                band_us=vband,
                delta_pct=((adj_v - base_v) / base_v * 100.0
                           if base_v else 0.0)))

    for cell in sorted(set(base_cells) - set(new_cells)):
        b = base_cells[cell]
        verdicts.append(CellVerdict(
            scenario=b.scenario, chip=b.chip, kernel=b.kernel,
            strategy=b.strategy, verdict="missing",
            base_us=float(b.metrics["us_median"])))
    for cell in sorted(set(new_cells) - set(base_cells)):
        n = new_cells[cell]
        verdicts.append(CellVerdict(
            scenario=n.scenario, chip=n.chip, kernel=n.kernel,
            strategy=n.strategy, verdict="new",
            new_us=float(n.metrics["us_median"])))

    order = {"regress": 0, "missing": 1, "improve": 2, "new": 3, "pass": 4}
    verdicts.sort(key=lambda v: (order[v.verdict], v.scenario, v.chip))
    return CompareResult(verdicts=verdicts, k=k, rel_floor=rel_floor,
                         host_scale=scale, normalized=normalize)


def format_compare(res: CompareResult, *, base_path: str = "base",
                   new_path: str = "new", verbose: bool = False) -> str:
    """Human-readable gate report.  Non-pass verdicts always print;
    ``verbose`` adds the passing cells too."""
    c = res.counts()
    lines = [f"compare: {new_path} vs {base_path} "
             f"(k={res.k:g}, rel_floor={res.rel_floor:g}"
             + (f", host_scale={res.host_scale:.3f}" if res.normalized
                else "") + ")",
             "  " + "  ".join(f"{k}={v}" for k, v in c.items())]
    shown = [v for v in res.verdicts
             if verbose or v.verdict != "pass"]
    if shown:
        lines.append(f"  {'verdict':<8s} {'scenario':<36s} {'chip':<10s} "
                     f"{'base_us':>10s} {'new_us':>10s} {'band_us':>9s} "
                     f"{'delta':>8s}")
    for v in shown:
        base_s = f"{v.base_us:.1f}" if v.base_us is not None else "-"
        new_s = f"{v.adj_new_us:.1f}" if v.adj_new_us is not None else \
            (f"{v.new_us:.1f}" if v.new_us is not None else "-")
        delta = f"{v.delta_pct:+.1f}%" \
            if v.verdict in ("pass", "regress", "improve") else "-"
        lines.append(f"  {v.verdict:<8s} {v.scenario:<36s} {v.chip:<10s} "
                     f"{base_s:>10s} {new_s:>10s} {v.band_us:>9.2f} "
                     f"{delta:>8s}")
    lines.append("GATE: " + ("REGRESSED" if res.n_regressions else "ok")
                 + f" ({res.n_regressions} regression(s))")
    return "\n".join(lines)
