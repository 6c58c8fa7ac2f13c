"""Schema-versioned benchmark result records — the BENCH_*.json format.

A copy of ``repro.bench.results`` with no new keys, so the reference's
``BenchReport.load`` and ``repro.obs.compare`` read the port's rows as they
are.  Port rows set ``backend`` to "cuda" or "cpu", ``interpret=False`` and
``jax_version=""``; the torch and CUDA versions and the card's name and
power limit travel in ``metrics``.

Every measured (or roofline-projected) scenario run becomes one
``BenchResult`` row carrying the metrics *and* full provenance: the chip
model (``core.hardware``), the async strategy actually run, the resolved
kernel config and where it came from (tuning registry vs seed default vs
scenario override), backend/interpret mode and jax version.  A
``BenchReport`` is the on-disk trajectory artifact.

Versioning mirrors the tuning registry's discipline: v2 is the current
structured-row format; v1 (the old ``benchmarks/run.py`` free-form
``table/name/metrics`` rows) is *upgraded* on load, never misread, and an
unknown version raises ``ResultSchemaMismatch`` so a future format is never
silently reinterpreted.
"""
from __future__ import annotations

import datetime
import json
from dataclasses import dataclass, field, asdict
from typing import Any, Dict, IO, List, Optional, Union

SCHEMA_VERSION = 2

__all__ = ["SCHEMA_VERSION", "BenchResult", "BenchReport",
           "ResultSchemaMismatch", "upgrade_v1_row", "now_iso"]


class ResultSchemaMismatch(RuntimeError):
    pass


def now_iso() -> str:
    return datetime.datetime.now(
        datetime.timezone.utc).isoformat(timespec="seconds")


@dataclass
class BenchResult:
    """One result row: what ran, on what, configured how, and the numbers."""
    scenario: str                       # registered scenario name
    kernel: str
    shape: List[int]
    dtype: str
    strategy: str                       # async strategy actually run
    chip: str                           # hardware.Chip model name
    metrics: Dict[str, Any] = field(default_factory=dict)
    # provenance ------------------------------------------------------------
    config: Dict[str, Any] = field(default_factory=dict)   # resolved config
    config_source: str = "default"      # "tuned" | "default" | "scenario" |
    #                                     "legacy-v1"
    tuned_key: Optional[str] = None     # tuning-registry key when tuned
    trace_id: Optional[str] = None      # obs scenario-span id (when traced)
    kind: str = "measured"              # "measured" | "model"
    section: str = ""                   # paper figure/table this row feeds
    interpret: bool = True
    backend: str = ""                   # device type at run time
    jax_version: str = ""
    created_at: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BenchResult":
        return cls(**d)


def upgrade_v1_row(row: Dict[str, Any]) -> BenchResult:
    """Lift an old ``benchmarks/run.py`` v1 row ({table, name, section,
    metrics}) into a v2 record.  Provenance the old format never carried
    stays empty rather than guessed."""
    return BenchResult(
        scenario=f"{row.get('table', '?')}/{row.get('name', '?')}",
        kernel=str(row.get("table", "")),
        shape=[], dtype="", strategy="", chip="",
        metrics=dict(row.get("metrics", {})),
        config_source="legacy-v1",
        section=str(row.get("section", "")))


@dataclass
class BenchReport:
    """An ordered collection of rows plus run-level provenance; serializes
    to the BENCH_*.json trajectory format."""
    results: List[BenchResult] = field(default_factory=list)
    generator: str = "repro_torch.bench"
    jax_version: str = ""
    backend: str = ""
    created_at: str = ""

    def add(self, result: BenchResult) -> BenchResult:
        self.results.append(result)
        return result

    def extend(self, results) -> None:
        self.results.extend(results)

    def __len__(self) -> int:
        return len(self.results)

    def kernels(self) -> List[str]:
        return sorted({r.kernel for r in self.results if r.kernel})

    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema_version": SCHEMA_VERSION,
            "generator": self.generator,
            "jax_version": self.jax_version,
            "backend": self.backend,
            "created_at": self.created_at or now_iso(),
            "rows": [r.to_dict() for r in self.results],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BenchReport":
        version = d.get("schema_version")
        if version == SCHEMA_VERSION:
            rows = [BenchResult.from_dict(r) for r in d.get("rows", [])]
        elif version == 1:
            rows = [upgrade_v1_row(r) for r in d.get("rows", [])]
        else:
            raise ResultSchemaMismatch(
                f"bench report has schema_version={version!r}, expected "
                f"{SCHEMA_VERSION} (or 1, which is upgraded on load)")
        return cls(results=rows,
                   generator=d.get("generator", "repro_torch.bench"),
                   jax_version=d.get("jax_version", ""),
                   backend=d.get("backend", ""),
                   created_at=d.get("created_at", ""))

    # -- persistence --------------------------------------------------------

    def save(self, out: Union[str, IO[str]]) -> None:
        if hasattr(out, "write"):
            json.dump(self.to_dict(), out, indent=1, sort_keys=True)
            out.write("\n")
        else:
            with open(out, "w") as f:
                json.dump(self.to_dict(), f, indent=1, sort_keys=True)
                f.write("\n")

    @classmethod
    def load(cls, path: str) -> "BenchReport":
        with open(path) as f:
            return cls.from_dict(json.load(f))
