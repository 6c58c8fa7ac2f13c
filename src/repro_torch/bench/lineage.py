"""Lineage validation: catalog expectations vs published numbers.

The paper's core move (§6) is an *expectation model* — for any chip pair,
``T_speedup = min(FLOP ratio, BW ratio)`` — validated against measurements
across K80→A100.  This module closes the same loop for the catalog's
Hopper extension: it computes the expected speedups from ``core.hardware``
/ ``core.balance`` and compares them against a committed reference table of
published numbers (paper Table 1 derivations for the K80→A100 arc; the
Hopper microbenchmark papers, Luo et al. arXiv:2402.13499 / 2501.12084, for
A100→H100/H200), emitting one verdict row per pair:

  * ``within-band`` — catalog expectation within the pair's relative band,
  * ``over``        — catalog predicts *more* speedup than published,
  * ``under``       — catalog predicts *less*.

``over``/``under`` mean the catalog and the published record have drifted
apart (a mistyped chip row, or a reference number that needs re-sourcing) —
CI fails on either.  The reference table lives at
``experiments/baselines/LINEAGE_hopper.json``; the verdicts are rendered by
``experiments/make_report.py --lineage`` and gated by
``python -m repro_torch.bench.cli lineage``.  A copy of
``repro.bench.lineage``: the port reads the same committed table and never
writes it.
"""
from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass
from typing import Dict, IO, List, Optional, Union

from ..core import hardware
from ..core.balance import expect_speedup

__all__ = ["LineagePair", "LineageVerdict", "load_reference",
           "validate", "lineage_chain", "to_doc", "default_reference_path",
           "REFERENCE_KIND", "REFERENCE_SCHEMA", "DOC_KIND"]

REFERENCE_KIND = "lineage-reference"
REFERENCE_SCHEMA = 1
DOC_KIND = "lineage-validation"


@dataclass(frozen=True)
class LineagePair:
    """One published chip-pair speedup the catalog must reproduce."""
    old: str
    new: str
    published: float             # published/derived speedup for the pair
    band: float                  # relative tolerance (0.15 = +-15%)
    precision: str = "f32"
    source: str = ""             # citation for ``published``
    note: str = ""


@dataclass(frozen=True)
class LineageVerdict:
    """A validated pair: catalog expectation vs the published number."""
    old: str
    new: str
    precision: str
    expected: float              # catalog min(FLOP ratio, BW ratio)
    flop_ratio: float
    bw_ratio: float
    binds: str                   # which ratio limits: "flops"|"bandwidth"
    published: float
    band: float
    rel_dev: float               # expected/published - 1
    verdict: str                 # "within-band" | "over" | "under"
    source: str = ""
    note: str = ""

    @property
    def ok(self) -> bool:
        return self.verdict == "within-band"


def default_reference_path() -> str:
    """The committed reference table, resolved relative to this checkout."""
    return os.path.normpath(os.path.join(
        os.path.dirname(__file__), "..", "..", "..",
        "experiments", "baselines", "LINEAGE_hopper.json"))


def load_reference(path_or_file: Union[str, IO]) -> List[LineagePair]:
    """Parse a lineage-reference JSON; raises ``ValueError`` on a wrong
    ``kind``/``schema`` or an unknown chip name (typos must not pass as
    silently-empty validations)."""
    if hasattr(path_or_file, "read"):
        doc = json.load(path_or_file)
    else:
        with open(path_or_file) as f:
            doc = json.load(f)
    if doc.get("kind") != REFERENCE_KIND:
        raise ValueError(f"not a {REFERENCE_KIND} document: "
                         f"kind={doc.get('kind')!r}")
    if doc.get("schema") != REFERENCE_SCHEMA:
        raise ValueError(f"unsupported {REFERENCE_KIND} schema "
                         f"{doc.get('schema')!r} (want {REFERENCE_SCHEMA})")
    pairs = []
    for row in doc.get("pairs", []):
        pair = LineagePair(
            old=row["old"], new=row["new"],
            published=float(row["published"]), band=float(row["band"]),
            precision=row.get("precision", "f32"),
            source=row.get("source", ""), note=row.get("note", ""))
        for name in (pair.old, pair.new):
            if name not in hardware.CATALOG:
                raise ValueError(f"reference pair {pair.old}->{pair.new} "
                                 f"names unknown chip {name!r}")
        if pair.published <= 0 or pair.band < 0:
            raise ValueError(f"reference pair {pair.old}->{pair.new} has "
                             f"non-positive published/band")
        pairs.append(pair)
    if not pairs:
        raise ValueError("reference table has no pairs")
    return pairs


def _judge(pair: LineagePair) -> LineageVerdict:
    exp = expect_speedup(hardware.get_chip(pair.old),
                         hardware.get_chip(pair.new), pair.precision)
    rel = exp.expected / pair.published - 1.0
    if rel > pair.band:
        verdict = "over"
    elif rel < -pair.band:
        verdict = "under"
    else:
        verdict = "within-band"
    return LineageVerdict(
        old=pair.old, new=pair.new, precision=pair.precision,
        expected=exp.expected, flop_ratio=exp.flop_ratio,
        bw_ratio=exp.bw_ratio, binds=exp.binds,
        published=pair.published, band=pair.band, rel_dev=rel,
        verdict=verdict, source=pair.source, note=pair.note)


def validate(pairs: List[LineagePair]) -> List[LineageVerdict]:
    """Judge every reference pair against the live catalog."""
    return [_judge(p) for p in pairs]


def lineage_chain(names: Optional[List[str]] = None,
                  precision: str = "f32") -> List[LineageVerdict]:
    """Consecutive-pair expectations along a lineage arc (default: the
    datacenter K80→…→H100 arc) with no published number to judge against —
    the 'what does the catalog itself predict' rows of the report.  These
    carry verdict "expected" and published/band/rel_dev of 0."""
    arc = list(names or hardware.DATACENTER_LINEAGE)
    out = []
    for old, new in zip(arc, arc[1:]):
        exp = expect_speedup(hardware.get_chip(old),
                             hardware.get_chip(new), precision)
        out.append(LineageVerdict(
            old=old, new=new, precision=precision,
            expected=exp.expected, flop_ratio=exp.flop_ratio,
            bw_ratio=exp.bw_ratio, binds=exp.binds,
            published=0.0, band=0.0, rel_dev=0.0, verdict="expected"))
    return out


def to_doc(verdicts: List[LineageVerdict],
           chain: Optional[List[LineageVerdict]] = None,
           reference: str = "") -> Dict:
    """The machine-readable validation document (make_report renders it)."""
    counts = {"within-band": 0, "over": 0, "under": 0}
    for v in verdicts:
        counts[v.verdict] = counts.get(v.verdict, 0) + 1
    return {
        "kind": DOC_KIND,
        "schema": 1,
        "reference": reference,
        "counts": counts,
        "ok": counts.get("over", 0) == 0 and counts.get("under", 0) == 0,
        "rows": [asdict(v) for v in verdicts],
        "chain": [asdict(v) for v in (chain or [])],
    }
