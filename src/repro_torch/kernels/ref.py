"""Plain-torch oracles: the semantic ground truth the runner checks against.

Ports of ``repro.kernels.ref.stream_ref``, ``hotspot_ref``,
``pathfinder_ref``, ``nw_ref``, ``lud_ref``, ``matmul_ref`` and
``attention_ref``, written in the most obvious way with no tiling.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["stream_ref", "hotspot_ref", "pathfinder_ref", "nw_ref", "lud_ref",
           "matmul_ref", "attention_ref"]


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


def pathfinder_ref(wall: torch.Tensor) -> torch.Tensor:
    """wall: (rows, cols) int32 costs.  dst[j] = wall[r,j] + min(prev[j-1],
    prev[j], prev[j+1]); edges clamp.  Returns the final row of path costs."""
    prev = wall[0]
    for row in wall[1:]:
        left = torch.cat([prev[:1], prev[:-1]])
        right = torch.cat([prev[1:], prev[-1:]])
        prev = row + torch.minimum(prev, torch.minimum(left, right))
    return prev


def nw_ref(seq_scores: torch.Tensor, penalty: int) -> torch.Tensor:
    """seq_scores: (n, n) similarity matrix.  Returns the (n+1, n+1) DP
    table with first row/col -i*penalty, filled with
        M[i,j] = max(M[i-1,j-1] + s[i-1,j-1], M[i,j-1] - p, M[i-1,j] - p),
    in ``seq_scores``' dtype.

    Filled anti-diagonal by anti-diagonal, as the reference's docstring
    describes: the cells of diagonal d = i + j read only diagonals d-1 and
    d-2, so each of the 2n-1 diagonals is one vector step (the reference's
    element-by-element double scan would be n^2 Python steps)."""
    n = seq_scores.shape[0]
    dev, dt = seq_scores.device, seq_scores.dtype
    w = n + 1
    m = torch.zeros((w, w), dtype=dt, device=dev)
    edge = -penalty * torch.arange(w, dtype=dt, device=dev)
    m[0, :] = edge
    m[:, 0] = edge
    flat, s = m.view(-1), seq_scores.reshape(-1)
    rows = torch.arange(1, w, device=dev)
    for d in range(2, 2 * n + 1):
        i = rows[max(1, d - n) - 1:min(n, d - 1)]
        k = i * w + (d - i)                         # flat index of (i, d-i)
        diag = flat[k - w - 1] + s[(i - 1) * n + (d - i - 1)]
        flat[k] = torch.maximum(diag, torch.maximum(flat[k - 1],
                                                    flat[k - w]) - penalty)
    return m


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


def _full_f32(t: torch.Tensor) -> None:
    """The f32 oracles hold kernels to 1e-4 and 2e-5: on the card their
    products must not run in TF32 (PyTorch's default, asserted here, not
    assumed)."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is set; the "
                           "f32 oracles need full f32 products")


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) in f32."""
    _full_f32(a)
    return a.float() @ b.float()


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, scale: Optional[float] = None,
                  window: int = 0) -> torch.Tensor:
    """q, k, v: (heads, seq, head_dim) -> (heads, seq, head_dim), f32 math;
    masked logits are -inf, as the reference's."""
    _full_f32(q)
    q, k, v = (t.float() for t in (q, k, v))
    s, d = q.shape[-2:]
    scale = scale if scale is not None else 1.0 / d ** 0.5
    logits = torch.einsum("hqd,hkd->hqk", q * scale, k)
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window > 0:
        mask &= ki > qi - window
    logits = logits.masked_fill(~mask, float("-inf"))
    return torch.einsum("hqk,hkd->hqd", torch.softmax(logits, dim=-1), v)
