"""Fold depth-sweep measurements into the paper's "async pays / async
hurts" regime map.

The ``regime/*`` scenario family measures, per kernel x shape x dtype
cell, a SYNC baseline plus the kernel's best async strategy at each ring
depth.  This module reduces those measured rows into one verdict row per
cell:

  verdict            "pays" | "neutral" | "hurts"  (±PAYS_MARGIN vs sync)
  break_even_depth   smallest ring depth that beats (or ties) the sync
                     baseline, or None if no depth ever does
  best_depth         the depth with the lowest measured median
  speedup            sync_us / best_us

A verdict row is a normal schema-v2 ``BenchResult`` with ``kind="regime"``
so it travels in the same BENCH_*.json artifact as the measurements it
summarizes, and ``experiments/make_report.py`` can render the map without
re-deriving it.  A copy of ``repro.bench.regime`` with the same margin and
rules, so both packages give the same verdict for the same rows.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from .results import BenchResult, now_iso

__all__ = ["PAYS_MARGIN", "regime_rows"]

#: relative margin vs the sync baseline inside which a cell is "neutral" —
#: interpreter/CPU timing jitter makes a tighter call meaningless.
PAYS_MARGIN = 0.05


def _cell_key(r: BenchResult) -> Tuple[str, Tuple[int, ...], str]:
    return (r.kernel, tuple(r.shape), r.dtype)


def regime_rows(rows: Iterable[BenchResult]) -> List[BenchResult]:
    """Reduce measured ``section == "regime"`` rows to one verdict row per
    (kernel, shape, dtype) cell.  Cells missing their sync baseline or any
    async measurement are skipped (a partial sweep yields a partial map,
    never a fabricated verdict)."""
    cells: Dict[Tuple[str, Tuple[int, ...], str], List[BenchResult]] = {}
    for r in rows:
        if r.section == "regime" and r.kind == "measured":
            cells.setdefault(_cell_key(r), []).append(r)

    out: List[BenchResult] = []
    for (kernel, shape, dtype), grp in sorted(cells.items()):
        baseline = next((r for r in grp if r.strategy == "sync"), None)
        if baseline is None:
            continue
        base_us = baseline.metrics.get("us_median")
        if not base_us:
            continue

        # best async median per ring depth (min across strategies if a
        # future sweep measures several per depth)
        us_by_depth: Dict[int, float] = {}
        strat_by_depth: Dict[int, str] = {}
        for r in grp:
            if r.strategy == "sync":
                continue
            us = r.metrics.get("us_median")
            if us is None:
                continue
            depth = int(r.config.get("depth", 2))
            if depth not in us_by_depth or us < us_by_depth[depth]:
                us_by_depth[depth] = float(us)
                strat_by_depth[depth] = r.strategy
        if not us_by_depth:
            continue

        depths = sorted(us_by_depth)
        best_depth = min(depths, key=lambda d: (us_by_depth[d], d))
        best_us = us_by_depth[best_depth]
        break_even: Optional[int] = next(
            (d for d in depths if us_by_depth[d] <= base_us), None)
        if best_us < base_us * (1.0 - PAYS_MARGIN):
            verdict = "pays"
        elif best_us > base_us * (1.0 + PAYS_MARGIN):
            verdict = "hurts"
        else:
            verdict = "neutral"

        metrics: Dict[str, object] = {
            "baseline_us": float(base_us),
            "best_depth": best_depth,
            "best_us": best_us,
            "break_even_depth": break_even,
            "speedup": float(base_us) / best_us if best_us else 0.0,
            "verdict": verdict,
        }
        for d in depths:
            metrics[f"us_d{d}"] = us_by_depth[d]

        out.append(BenchResult(
            scenario=f"regime/{kernel}/map", kernel=kernel,
            shape=list(shape), dtype=dtype,
            strategy=strat_by_depth[best_depth], chip=baseline.chip,
            metrics=metrics, config={}, config_source="derived",
            kind="regime", section="regime",
            interpret=baseline.interpret, backend=baseline.backend,
            jax_version=baseline.jax_version, created_at=now_iso()))
    return out
