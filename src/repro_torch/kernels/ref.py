"""Plain-torch oracles: the semantic ground truth the runner checks against.

Ports of ``repro.kernels.ref.stream_ref`` and ``hotspot_ref``, written in
the most obvious way with no tiling.  The other oracles come with their
kernels.
"""
from __future__ import annotations

import torch

__all__ = ["stream_ref", "hotspot_ref"]


def stream_ref(x: torch.Tensor, iters: int = 1) -> torch.Tensor:
    for _ in range(iters):
        x = x * 0.5 + 0.5
    return x


def hotspot_ref(temp: torch.Tensor, power: torch.Tensor, *, iters: int,
                rx: float = 0.1, ry: float = 0.1, rz: float = 0.5,
                cap: float = 0.5) -> torch.Tensor:
    """temp, power: (R, C).  Edge cells clamp (replicate padding), matching
    the Rodinia boundary treatment."""
    t = temp
    for _ in range(iters):
        up = torch.cat([t[:1], t[:-1]], dim=0)
        down = torch.cat([t[1:], t[-1:]], dim=0)
        left = torch.cat([t[:, :1], t[:, :-1]], dim=1)
        right = torch.cat([t[:, 1:], t[:, -1:]], dim=1)
        delta = cap * (power + (up + down - 2.0 * t) * ry
                       + (left + right - 2.0 * t) * rx
                       + (80.0 - t) * rz)
        t = t + delta
    return t
