"""Plain-torch oracles: the semantic ground truth the runner checks against.

Ports of ``repro.kernels.ref.stream_ref``, ``hotspot_ref`` and
``lud_ref``, written in the most obvious way with no tiling.  The other
oracles come with their kernels.
"""
from __future__ import annotations

import torch

__all__ = ["stream_ref", "hotspot_ref", "lud_ref"]


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


def lud_ref(a: torch.Tensor) -> torch.Tensor:
    """Doolittle LU without pivoting, unblocked, as Rodinia's lud: the
    combined matrix with U on and above the diagonal and the strict lower
    triangle of L (unit diagonal implied).

    The reference masks the whole matrix each step; this updates only the
    trailing block in place, the same arithmetic (col = a[:, k] / pivot,
    a -= col * row) on a clone of ``a``, in ``a``'s dtype."""
    a = a.clone()
    for k in range(a.shape[0] - 1):
        a[k + 1:, k] /= a[k, k]
        a[k + 1:, k + 1:] -= torch.outer(a[k + 1:, k], a[k, k + 1:])
    return a
