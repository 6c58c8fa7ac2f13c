"""Persistent autotuning results registry.

The counterpart of ``repro.tuning.registry``, field for field and key for
key, so that each package's ``TuningRecord.from_dict`` reads the other's
records.  Its default file is its own (``tuning_registry_torch.json``, or
``$REPRO_TORCH_TUNING_REGISTRY``), so that a reference tune in the same
directory never feeds the port.  The key's mode is "compiled" for a
measurement of the card's kernels and "interpret" for one of the CPU's
plain versions; ``jax_version`` is "".

One JSON file holds every tuning record this host has produced, keyed by
``kernel|shape|dtype|chip|mode``.  Records carry full measurement provenance
(every candidate's timings, the analytic prediction, prune statistics), not
just the winning config, so the paper's expectation-vs-measurement analysis
can be replayed from the registry alone.

The file is schema-versioned: a registry written by an incompatible version
is *ignored* (with a warning) rather than misread — tuning is a cache, so
the safe failure mode is re-measurement, never a wrong config.
"""
from __future__ import annotations

import json
import logging
import os
import tempfile
from dataclasses import dataclass, field, asdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

log = logging.getLogger("repro_torch.tuning")

SCHEMA_VERSION = 2      # v2: measurement mode (interpret/compiled) in keys

#: Environment override for the default registry location.
REGISTRY_ENV = "REPRO_TORCH_TUNING_REGISTRY"
DEFAULT_REGISTRY = "tuning_registry_torch.json"


def default_registry_path() -> str:
    return os.environ.get(REGISTRY_ENV, DEFAULT_REGISTRY)


def make_key(kernel: str, shape: Sequence[int], dtype: str, chip: str,
             interpret: bool = True) -> str:
    """Timings of the card's kernels and of the CPU's plain versions are
    not comparable, so the mode is part of the cell identity: a card tune
    can never be clobbered by a CPU run of the same (kernel, shape, dtype,
    chip)."""
    return "|".join([kernel, "x".join(str(int(s)) for s in shape),
                     str(dtype), chip,
                     "interpret" if interpret else "compiled"])


@dataclass
class Measurement:
    """One empirically-timed candidate (or its failure)."""
    config: Dict[str, Any]
    us_median: float = 0.0
    us_mean: float = 0.0
    us_min: float = 0.0
    us_std: float = 0.0
    n_trials: int = 0
    n_outliers: int = 0
    predicted_us: float = 0.0
    error: Optional[str] = None


@dataclass
class TuningRecord:
    """Everything the autotuner learned about one (kernel, shape, dtype,
    chip) cell: the winner plus full provenance."""
    kernel: str
    shape: List[int]
    dtype: str
    chip: str
    best: Dict[str, Any]
    best_us: float
    default_us: float = 0.0            # the hard-coded default's time
    speedup_vs_default: float = 0.0
    measurements: List[Measurement] = field(default_factory=list)
    n_candidates: int = 0
    n_pruned: int = 0
    interpret: bool = True
    jax_version: str = ""
    created_at: str = ""

    @property
    def key(self) -> str:
        return make_key(self.kernel, self.shape, self.dtype, self.chip,
                        self.interpret)

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TuningRecord":
        d = dict(d)
        d["measurements"] = [Measurement(**m)
                             for m in d.get("measurements", [])]
        return cls(**d)


class SchemaMismatch(RuntimeError):
    pass


class Registry:
    """Load/store TuningRecords in one schema-versioned JSON file.

    Writes are atomic (tmp file + rename) so a crashed tune never tears the
    cache.  ``strict=True`` raises on a schema mismatch instead of treating
    the file as empty.
    """

    def __init__(self, path: Optional[str] = None, *, strict: bool = False):
        self.path = path or default_registry_path()
        self.strict = strict
        self._records: Optional[Dict[str, Dict[str, Any]]] = None
        self._dirty: set = set()        # keys written via put() since load

    # -- persistence --------------------------------------------------------

    def load(self) -> Dict[str, Dict[str, Any]]:
        if self._records is not None:
            return self._records
        self._records = {}
        if os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    data = json.load(f)
            except (OSError, json.JSONDecodeError) as e:
                if self.strict:
                    raise
                log.warning("tuning registry %s unreadable (%s); starting "
                            "empty", self.path, e)
                return self._records
            version = data.get("schema_version")
            if version != SCHEMA_VERSION:
                if self.strict:
                    raise SchemaMismatch(
                        f"registry {self.path} has schema_version={version}, "
                        f"expected {SCHEMA_VERSION}")
                log.warning("tuning registry %s has schema_version=%s "
                            "(want %s); ignoring stale cache",
                            self.path, version, SCHEMA_VERSION)
                return self._records
            self._records = data.get("records", {})
        return self._records

    def save(self) -> None:
        records = self.load()
        # merge-on-save: re-read the file so concurrent tuners' records
        # survive.  Only keys THIS process wrote via put() overlay the disk
        # view — merely-read keys must not revert another writer's newer
        # record (atomic rename below prevents torn files, this prevents
        # lost updates in both directions)
        if os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    data = json.load(f)
                if data.get("schema_version") == SCHEMA_VERSION:
                    merged = data.get("records", {})
                    merged.update({k: records[k] for k in self._dirty
                                   if k in records})
                    self._records = records = merged
            except (OSError, json.JSONDecodeError):
                pass
        payload = {"schema_version": SCHEMA_VERSION, "records": records}
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    # -- record access ------------------------------------------------------

    def get(self, kernel: str, shape: Sequence[int], dtype: str,
            chip: str, interpret: bool = True) -> Optional[TuningRecord]:
        raw = self.load().get(make_key(kernel, shape, dtype, chip,
                                       interpret))
        return TuningRecord.from_dict(raw) if raw is not None else None

    def put(self, record: TuningRecord, *, save: bool = True) -> None:
        self.load()[record.key] = record.to_dict()
        self._dirty.add(record.key)
        if save:
            self.save()

    def keys(self) -> List[str]:
        return sorted(self.load())

    def records(self) -> List[TuningRecord]:
        return [TuningRecord.from_dict(v) for _, v in
                sorted(self.load().items())]

    def records_for(self, kernel: str,
                    chip: Optional[str] = None) -> List[TuningRecord]:
        out = []
        for rec in self.records():
            if rec.kernel != kernel:
                continue
            if chip is not None and rec.chip != chip:
                continue
            out.append(rec)
        return out

    def __len__(self) -> int:
        return len(self.load())
