"""Hardware catalog: the paper's Table 1, its Hopper extension and the TPU rows.

A copy of ``repro.core.hardware`` (``Chip`` and ``CATALOG``), with one
change: the port targets the H100 SXM, not the TPU v5e.  ``detect_chip``
names the catalog row of the card this process runs on.
"""
from __future__ import annotations

import shutil
import subprocess
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

__all__ = ["Chip", "CATALOG", "TARGET", "get_chip", "detect_chip",
           "card_power_limit"]


@dataclass(frozen=True)
class Chip:
    name: str
    vendor: str
    year: str
    arch: str
    grade: str                     # "datacenter" | "consumer" | "tpu"
    mem_gb: float
    mem_bw_gbs: float              # external memory bandwidth, GB/s
    tflops_f32: float              # fp32 (GPU) / bf16 (TPU — the lineage metric)
    tflops_f64: float              # 0.0 = no f64 units (TPUs)
    n_cores: int                   # SMs (GPU) / TensorCores-per-chip (TPU)
    tdp_w: float                   # 0.0 = unpublished (render as "n/a")
    die_mm2: float                 # 0.0 = unpublished (render as "n/a")
    # interconnect (per-link, unidirectional)
    link_gbs: float = 0.0
    vmem_mb: float = 0.0           # on-chip scratch (shared mem / VMEM)
    # async bulk-copy engine generation: "" = plain synchronous loads,
    # "cp.async" = Ampere per-thread async copies, "tma" = Hopper bulk
    # tensor-memory accelerator, "dma" = TPU DMA engines
    async_engine: str = ""

    @property
    def has_f64(self) -> bool:
        return self.tflops_f64 > 0.0

    @property
    def density_known(self) -> bool:
        return self.die_mm2 > 0.0


GPUS: Tuple[Chip, ...] = (
    Chip("K80", "nvidia", "2014Q4", "Kepler", "datacenter", 12, 240.6, 4.113, 1.371, 13, 300, 561),
    Chip("P100", "nvidia", "2016Q2", "Pascal", "datacenter", 16, 732.2, 10.61, 5.304, 56, 300, 610),
    Chip("V100", "nvidia", "2017Q3", "Volta", "datacenter", 16, 897.0, 14.13, 7.066, 80, 300, 815),
    Chip("A100", "nvidia", "2020Q3", "Ampere", "datacenter", 40, 1555.0, 19.49, 9.746, 108, 250, 826, async_engine="cp.async"),
    Chip("GTX745", "nvidia", "2014Q1", "Maxwell", "consumer", 4, 28.80, 0.793, 0.02479, 3, 55, 148),
    Chip("K2200", "nvidia", "2014Q3", "Maxwell", "consumer", 4, 80.19, 1.439, 0.04496, 5, 68, 148),
    Chip("GTX1050Ti", "nvidia", "2016Q4", "Pascal", "consumer", 4, 112.1, 2.138, 0.0668, 6, 75, 132),
    Chip("RTX2060S", "nvidia", "2019Q3", "Turing", "consumer", 8, 448.0, 7.181, 0.224, 34, 175, 445),
)

HOPPER: Tuple[Chip, ...] = (
    Chip("H100-SXM", "nvidia", "2022Q4", "Hopper", "datacenter", 80, 3352.0, 66.91, 33.45, 132, 700, 814, async_engine="tma"),
    Chip("H100-PCIe", "nvidia", "2022Q4", "Hopper", "datacenter", 80, 2039.0, 51.22, 25.61, 114, 350, 814, async_engine="tma"),
    Chip("H200", "nvidia", "2024Q2", "Hopper", "datacenter", 141, 4890.0, 66.91, 33.45, 132, 700, 814, async_engine="tma"),
)

TPUS: Tuple[Chip, ...] = (
    Chip("TPUv2", "google", "2017", "TPUv2", "tpu", 8, 700.0, 45.0, 0.0, 2, 280, 0, link_gbs=62.5, vmem_mb=24, async_engine="dma"),
    Chip("TPUv3", "google", "2018", "TPUv3", "tpu", 16, 900.0, 123.0, 0.0, 2, 220, 0, link_gbs=81.25, vmem_mb=32, async_engine="dma"),
    Chip("TPUv4", "google", "2021", "TPUv4", "tpu", 32, 1200.0, 275.0, 0.0, 2, 170, 0, link_gbs=50.0, vmem_mb=128, async_engine="dma"),
    Chip("TPUv5e", "google", "2023", "TPUv5e", "tpu", 16, 819.0, 197.0, 0.0, 1, 0, 0, link_gbs=50.0, vmem_mb=128, async_engine="dma"),
    Chip("TPUv5p", "google", "2023", "TPUv5p", "tpu", 95, 2765.0, 459.0, 0.0, 2, 0, 0, link_gbs=100.0, vmem_mb=128, async_engine="dma"),
)

CATALOG: Dict[str, Chip] = {c.name: c for c in GPUS + HOPPER + TPUS}

#: the chip the port is built and measured for
TARGET = CATALOG["H100-SXM"]


def get_chip(name: str) -> Chip:
    try:
        return CATALOG[name]
    except KeyError:
        raise KeyError(f"unknown chip {name!r}; known: {sorted(CATALOG)}") from None


def card_power_limit(index: int = 0) -> str:
    """The card's power limit as ``nvidia-smi`` prints it ("700.00 W"), or
    "" where ``nvidia-smi`` is missing or fails."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return ""
    try:
        out = subprocess.run(
            [smi, "-i", str(index), "--query-gpu=power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.strip()


def _watts(limit: str) -> Optional[float]:
    try:
        return float(limit.split()[0])
    except (IndexError, ValueError):
        return None


def detect_chip(index: int = 0) -> str:
    """The ``CATALOG`` name of CUDA device ``index``: ``H100-SXM`` or
    ``H100-PCIe``.  The device name decides; where it does not say which
    form factor ("NVIDIA H100"), the power limit does (the PCIe card is
    rated 350 W, the SXM module 700 W).  Any other card raises, and the
    caller must name the chip (``--chip``)."""
    import torch
    name = torch.cuda.get_device_name(index)
    if "H100" in name and "NVL" not in name:
        if "PCIe" in name:
            return "H100-PCIe"
        if "HBM3" in name or "SXM" in name:
            return "H100-SXM"
        watts = _watts(card_power_limit(index))
        if watts is not None:
            return "H100-SXM" if watts > 400 else "H100-PCIe"
    raise RuntimeError(
        f"cannot map CUDA device {name!r} to a catalog chip; pass --chip "
        f"(known: {sorted(CATALOG)})")
