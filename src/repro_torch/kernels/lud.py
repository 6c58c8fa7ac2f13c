"""Rodinia LUD: blocked LU without pivoting, as four hand-written kernels.

The counterpart of ``repro.kernels.lud`` (``lud_diagonal``,
``lud_perimeter_row``, ``lud_perimeter_col``, ``lud_internal`` and the host
loop ``lud_pallas``).  Each ``*_cuda`` wrapper launches ``csrc/lud.cu`` for
CUDA tensors and computes its ``*_plain`` version for CPU tensors; nothing
else reaches a plain version.  ``LAUNCHES`` counts kernel launches by
kernel.

``lud_cuda`` is the whole factorisation.  On the card one C call
(``lud_launch``) runs the host loop and enqueues its 4 nb - 3 launches on
the current stream, in place on one working copy of the input.  The
per-kernel wrappers, like the C launchers, update their last argument in
place and return it; the plain versions return new tensors.  The C
launchers count the launches they enqueue, and ``LAUNCHES`` adds those
counts.

On the card ``bs`` is 16, 32 or 64: the kernels are built for those block
sizes, each keeps every block start on 16 bytes (the copies move 16-byte
units), and 64 is what DROP_OFF's registers hold (bs U values and 16 C
values a thread).  The internal update's tiles are ``TILE`` x ``TILE``;
``csrc/lud.cu`` says why not the reference's 128 x 128.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from ..core.async_pipeline import (ALL_STRATEGIES, SMEM_PER_BLOCK,
                                   PipelineSpec, as_spec, smem_budget)
from . import _build
from .ref import lud_ref

__all__ = ["lud_cuda", "lud_plain", "lud_diagonal_cuda",
           "lud_diagonal_plain", "lud_perimeter_row_cuda",
           "lud_perimeter_row_plain", "lud_perimeter_col_cuda",
           "lud_perimeter_col_plain", "lud_internal_cuda",
           "lud_internal_plain", "internal_smem", "LAUNCHES", "TILE",
           "CARD_BS"]

#: kernel launches so far, by kernel, in the order of the C launchers'
#: launched[4] (the counts chip_smoke.py reads)
LAUNCHES: Dict[str, int] = dict.fromkeys(
    ("diagonal", "perimeter_row", "perimeter_col", "internal"), 0)

#: rows and columns of an internal tile; LUD_BI and LUD_BJ in csrc/lud.cu
TILE = 64

#: block sizes the card's kernels are built for
CARD_BS = (16, 32, 64)


# -- plain versions -----------------------------------------------------------

def lud_diagonal_plain(block: torch.Tensor) -> torch.Tensor:
    """The (bs, bs) block's Doolittle factors, combined (unblocked LU)."""
    return lud_ref(block)


def lud_perimeter_row_plain(diag: torch.Tensor,
                            strip: torch.Tensor) -> torch.Tensor:
    """L^-1 strip, L the unit lower triangle of ``diag`` (forward
    substitution down the (bs, W) strip)."""
    x = strip.clone()
    for r in range(1, x.shape[0]):
        x[r] -= diag[r, :r] @ x[:r]
    return x


def lud_perimeter_col_plain(diag: torch.Tensor,
                            strip: torch.Tensor) -> torch.Tensor:
    """strip U^-1, U the upper triangle of ``diag`` (non-unit), for the
    (H, bs) strip."""
    x = strip.clone()
    for c in range(x.shape[1]):
        x[:, c] = (x[:, c] - x[:, :c] @ diag[:c, c]) / diag[c, c]
    return x


def lud_internal_plain(l: torch.Tensor, u: torch.Tensor,
                       c: torch.Tensor) -> torch.Tensor:
    """C - L U for L (H, bs), U (bs, W), C (H, W)."""
    return c - l @ u


def lud_plain(a: torch.Tensor, bs: int = 32) -> torch.Tensor:
    """The blocked loop of ``lud_pallas`` over the plain versions."""
    n = _check_square(a, bs)
    a = a.clone()
    nb = n // bs
    for k in range(nb):
        lo, hi = k * bs, (k + 1) * bs
        a[lo:hi, lo:hi] = lud_diagonal_plain(a[lo:hi, lo:hi])
        if k == nb - 1:
            break
        diag = a[lo:hi, lo:hi]
        a[lo:hi, hi:] = lud_perimeter_row_plain(diag, a[lo:hi, hi:])
        a[hi:, lo:hi] = lud_perimeter_col_plain(diag, a[hi:, lo:hi])
        a[hi:, hi:] = lud_internal_plain(a[hi:, lo:hi], a[lo:hi, hi:],
                                         a[hi:, hi:])
    return a


# -- validation ---------------------------------------------------------------

def _check_square(a: torch.Tensor, bs: int) -> int:
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"lud takes a square matrix, got {tuple(a.shape)}")
    n = a.shape[0]
    if bs < 1 or n % bs or bs > n:
        raise ValueError(f"n={n} not divisible by block size bs={bs}")
    return n


def _on_card(what: str, *ts: torch.Tensor) -> bool:
    """False for CPU tensors, True for float32 tensors on one CUDA device;
    anything else raises."""
    devices = {t.device for t in ts}
    if all(d.type == "cpu" for d in devices):
        return False
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{what} takes tensors on one CPU or CUDA device, "
                         f"got {sorted(map(str, devices))}")
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError(f"{what} kernel is built for float32")
    return True


def _check_card_bs(bs: int) -> None:
    if bs not in CARD_BS:
        raise ValueError(f"the card's lud kernels take bs in {CARD_BS}, "
                         f"got {bs}")


def _check_rows(what: str, *ts: torch.Tensor) -> None:
    if any(t.stride(1) != 1 for t in ts):
        raise ValueError(f"{what} kernel needs row-major rows (stride 1 "
                         f"along a row)")


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def internal_smem(spec: PipelineSpec, bs: int) -> int:
    """Dynamic shared memory of one ``lud_internal`` block: run_pipeline's
    ring, out ring and barriers for a U (bs, TILE) and a C (TILE, TILE)
    tile, then the L (TILE, bs) tile at the next 16 bytes.  Raises
    ``ValueError`` past what a block may have."""
    tile = TILE * TILE * 4
    smem = _round16(smem_budget(spec, [bs * TILE * 4, tile], tile).card) \
        + bs * TILE * 4
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"lud_internal {spec} at bs={bs} needs {smem} bytes "
                         f"of shared memory > {SMEM_PER_BLOCK}")
    return smem


def _launch(fn_name: str, t: torch.Tensor, *args) -> Tuple[int, ...]:
    """Call one of the library's C launchers on ``t``'s device and stream,
    add the launches it enqueued to ``LAUNCHES`` and return them by kernel;
    a non-zero cudaError_t raises RuntimeError."""
    lib = _build.library("lud")
    launched = (ctypes.c_int * len(LAUNCHES))()
    rc = getattr(lib, fn_name)(t.device.index or 0, *args, launched,
                               torch.cuda.current_stream(t.device).cuda_stream)
    for k, count in zip(LAUNCHES, launched):
        LAUNCHES[k] += count
    _build.check(lib, rc, fn_name)
    return tuple(launched)


def _spec_args(spec: PipelineSpec):
    return (ALL_STRATEGIES.index(spec.strategy), spec.ahead, spec.out_depth,
            spec.ring_depth)


# -- the kernels ----------------------------------------------------------------

def lud_diagonal_cuda(block: torch.Tensor) -> torch.Tensor:
    """Factor the (bs, bs) ``block`` in place and return it."""
    if block.dim() != 2 or block.shape[0] != block.shape[1] or \
            block.shape[0] < 1:
        raise ValueError(f"diagonal block must be square, got "
                         f"{tuple(block.shape)}")
    if not _on_card("lud_diagonal", block):
        return block.copy_(lud_diagonal_plain(block))
    bs = block.shape[0]
    _check_card_bs(bs)
    _check_rows("lud_diagonal", block)
    _launch("lud_diagonal_launch", block, bs, block.data_ptr(),
            block.stride(0))
    return block


def _check_perimeter(diag: torch.Tensor, strip: torch.Tensor,
                     bs: int) -> None:
    if tuple(diag.shape) != (bs, bs) or strip.numel() == 0:
        raise ValueError(f"diag {tuple(diag.shape)} and strip "
                         f"{tuple(strip.shape)} do not share block size "
                         f"{bs}, or the strip is empty")


def lud_perimeter_row_cuda(diag: torch.Tensor,
                           strip: torch.Tensor) -> torch.Tensor:
    """Solve the (bs, W) ``strip`` in place against ``diag``'s unit lower
    triangle and return it."""
    bs, w = strip.shape
    _check_perimeter(diag, strip, bs)
    if not _on_card("lud_perimeter_row", diag, strip):
        return strip.copy_(lud_perimeter_row_plain(diag, strip))
    _check_card_bs(bs)
    _check_rows("lud_perimeter_row", diag, strip)
    _launch("lud_perimeter_row_launch", strip, bs, diag.data_ptr(),
            diag.stride(0), strip.data_ptr(), strip.stride(0), w)
    return strip


def lud_perimeter_col_cuda(diag: torch.Tensor,
                           strip: torch.Tensor) -> torch.Tensor:
    """Solve the (H, bs) ``strip`` in place against ``diag``'s upper
    triangle and return it."""
    h, bs = strip.shape
    _check_perimeter(diag, strip, bs)
    if not _on_card("lud_perimeter_col", diag, strip):
        return strip.copy_(lud_perimeter_col_plain(diag, strip))
    _check_card_bs(bs)
    _check_rows("lud_perimeter_col", diag, strip)
    _launch("lud_perimeter_col_launch", strip, bs, diag.data_ptr(),
            diag.stride(0), strip.data_ptr(), strip.stride(0), h)
    return strip


def lud_internal_cuda(l: torch.Tensor, u: torch.Tensor, c: torch.Tensor, *,
                      spec: PipelineSpec = PipelineSpec()) -> torch.Tensor:
    """C -= L U in place for L (H, bs), U (bs, W), C (H, W); returns C.  U
    and C tiles stream through the strategy's ring."""
    spec = as_spec(spec)
    (h, bs), w = l.shape, u.shape[1]
    if tuple(u.shape) != (bs, w) or tuple(c.shape) != (h, w) or \
            min(h, w, bs) < 1:
        raise ValueError(f"lud_internal shapes L {tuple(l.shape)}, U "
                         f"{tuple(u.shape)}, C {tuple(c.shape)} do not fit")
    if not _on_card("lud_internal", l, u, c):
        return c.copy_(lud_internal_plain(l, u, c))
    _check_card_bs(bs)
    _check_rows("lud_internal", l, u, c)
    if w % 4 or u.stride(0) % 4 or c.stride(0) % 4 or \
            u.data_ptr() % 16 or c.data_ptr() % 16:
        raise ValueError("lud_internal streams U and C in 16-byte units: W "
                         "and their row pitches must be multiples of 4 "
                         "floats and both must start on 16 bytes")
    smem = internal_smem(spec, bs)
    _launch("lud_internal_launch", c, *_spec_args(spec), l.data_ptr(),
            l.stride(0), u.data_ptr(), u.stride(0), c.data_ptr(),
            c.stride(0), h, w, bs, smem)
    return c


def lud_cuda(a: torch.Tensor, *, bs: int = 32,
             spec: PipelineSpec = PipelineSpec()) -> torch.Tensor:
    """Blocked LU of the (n, n) ``a`` with n % bs == 0, returned as the
    combined LU matrix (matches ``ref.lud_ref``); ``a`` is not changed."""
    spec = as_spec(spec)
    n = _check_square(a, bs)
    if not _on_card("lud", a):
        return lud_plain(a, bs)
    _check_card_bs(bs)
    smem = internal_smem(spec, bs)
    work = a.clone(memory_format=torch.contiguous_format)
    launched = _launch("lud_launch", work, *_spec_args(spec),
                       work.data_ptr(), n, bs, smem)
    nb = n // bs
    if launched != (nb, nb - 1, nb - 1, nb - 1):
        raise RuntimeError(f"lud_launch enqueued {launched} launches by "
                           f"kernel, not the {nb}, {nb - 1}, {nb - 1}, "
                           f"{nb - 1} of n={n} bs={bs}")
    return work
