"""Machine-balance analysis (paper Fig. 1 + §6 expectation model).

The paper derives, for each chip:
  * machine balance B/F = memory_bandwidth / peak_flops  (fp32 and fp64),
  * compute density = FLOPS / mm^2,
and from any pair (old, new) the *expected minimum speedup*

    T_speedup = min(FLOP_new/FLOP_old, BW_new/BW_old)

which holds regardless of whether an application is compute- or memory-bound
(paper §6: V100→A100 gives min(1.38, 1.73) = 1.38x — and Rodinia measured 1.34x,
i.e. the A100 under-delivers). A copy of ``repro.core.balance``, which the
port cannot import (``repro`` imports jax); tests/test_torch_lineage.py holds
the two equal on every catalog pair.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from .hardware import Chip, CATALOG


@dataclass(frozen=True)
class Balance:
    """Per-chip derivations.  f64 fields are NaN ("n/a") for chips without
    f64 units; density fields are NaN when the die area is unpublished —
    renderers must print "n/a" for NaN, never a number."""
    name: str
    bf_f32: float                # bytes per fp32 flop
    bf_f64: float                # NaN when the chip has no f64 units
    density_f32: float           # GFLOPS / mm^2; NaN when die unpublished
    density_f64: float


def machine_balance(chip: Chip) -> Balance:
    bf32 = chip.mem_bw_gbs / (chip.tflops_f32 * 1e3)
    bf64 = chip.mem_bw_gbs / (chip.tflops_f64 * 1e3) if chip.has_f64 \
        else float("nan")
    d32 = chip.tflops_f32 * 1e3 / chip.die_mm2 if chip.density_known \
        else float("nan")
    d64 = (chip.tflops_f64 * 1e3 / chip.die_mm2
           if chip.density_known and chip.has_f64 else float("nan"))
    return Balance(chip.name, bf32, bf64, d32, d64)


_PRECISIONS = ("f32", "f64")


def _flops_at(chip: Chip, precision: str) -> float:
    """Peak TFLOPs at ``precision``; raises for unknown precisions and for
    f64 on chips without f64 units (instead of silently dividing by the
    0.0 sentinel into inf/nan ratios)."""
    if precision not in _PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; "
                         f"valid: {_PRECISIONS}")
    if precision == "f64":
        if not chip.has_f64:
            raise ValueError(
                f"{chip.name} has no f64 units; f64 ratios are undefined "
                "(use precision='f32' for the lineage metric)")
        return chip.tflops_f64
    return chip.tflops_f32


@dataclass(frozen=True)
class SpeedupExpectation:
    """The §6 expectation, kept with both ratio terms so a report can say
    *which* roofline ceiling binds, not just the min."""
    old: str
    new: str
    precision: str
    flop_ratio: float
    bw_ratio: float

    @property
    def expected(self) -> float:
        return min(self.flop_ratio, self.bw_ratio)

    @property
    def binds(self) -> str:
        """Which term limits the expected speedup."""
        return "flops" if self.flop_ratio <= self.bw_ratio else "bandwidth"


def expect_speedup(old: Chip, new: Chip,
                   precision: str = "f32") -> SpeedupExpectation:
    """Paper §6 expectation with both terms.  Raises ``ValueError`` when
    ``precision='f64'`` and either chip lacks f64 units (TPUs)."""
    flop_ratio = _flops_at(new, precision) / _flops_at(old, precision)
    bw_ratio = new.mem_bw_gbs / old.mem_bw_gbs
    return SpeedupExpectation(old.name, new.name, precision,
                              flop_ratio, bw_ratio)


def expected_speedup(old: Chip, new: Chip, precision: str = "f32") -> float:
    """Paper §6: T_speedup = min(FLOP ratio, BW ratio).

    Raises ``ValueError`` for ``precision='f64'`` when either chip has no
    f64 units (every TPU) — the ratio used to silently become inf/nan."""
    return expect_speedup(old, new, precision).expected


def roofline_time(flops: float, bytes_moved: float, chip: Chip,
                  precision: str = "f32") -> float:
    """Classic 2-term roofline execution-time estimate (seconds) on one chip.
    Raises for f64 on chips without f64 units (same contract as
    ``expected_speedup``)."""
    peak = _flops_at(chip, precision) * 1e12
    t_compute = flops / peak
    t_memory = bytes_moved / (chip.mem_bw_gbs * 1e9)
    return max(t_compute, t_memory)


def attainable_flops(intensity: float, chip: Chip, precision: str = "f32") -> float:
    """Roofline attainable FLOP/s at a given arithmetic intensity (flops/byte)."""
    peak = _flops_at(chip, precision) * 1e12
    return min(peak, intensity * chip.mem_bw_gbs * 1e9)


def ridge_point(chip: Chip, precision: str = "f32") -> float:
    """Arithmetic intensity (flops/byte) where the roofline bends."""
    peak = _flops_at(chip, precision) * 1e12
    return peak / (chip.mem_bw_gbs * 1e9)


def lineage_table() -> Dict[str, Balance]:
    """Balance derivations for every catalog chip.  (A ``precision``
    parameter used to be accepted and silently ignored — ``Balance`` always
    carries both precisions; tests/test_balance.py pins this signature.)"""
    return {name: machine_balance(chip) for name, chip in CATALOG.items()}
