"""Rodinia LUD: blocked LU without pivoting, as hand-written kernels.

The counterpart of ``repro.kernels.lud`` (``lud_diagonal``,
``lud_perimeter_row``, ``lud_perimeter_col``, ``lud_internal`` and the host
loop ``lud_pallas``).  Each ``*_cuda`` wrapper launches ``csrc/lud.cu`` for
CUDA tensors and computes its ``*_plain`` version for CPU tensors; nothing
else reaches a plain version.  ``LAUNCHES`` counts kernel launches by
kernel.

``lud_cuda`` is the whole factorisation.  On the card one C call
(``lud_launch``) runs the panel schedule of ``csrc/lud.cu`` and enqueues
its ``lud_launches(n, bs)`` launches on the current stream, in place on one
working copy of the input: per ``PANEL`` columns, ``PANEL / bs`` sub-steps
(diagonal, both perimeters in one launch, and ``lud_internal`` at K = bs
inside the panel), then one trailing update at K = ``PANEL`` on a body of
its own (``lud_internal_panel``).  The sub-step's two K = bs updates, the
panel's columns below the sub-step's block row and the panel's rows right
of the panel, are one launch (``lud_internal_pair_cuda``).  ``lud_plain``
runs the same schedule over the plain versions.  The per-kernel wrappers,
like the C launchers, update their last argument in place and return it;
the plain versions return new tensors.  The C launchers count the
launches they enqueue, and ``LAUNCHES`` adds those counts.

On the card ``bs`` is 16, 32 or 64: the kernels are built for those block
sizes, each keeps every block start on 16 bytes (the copies move 16-byte
units), and 64 is what DROP_OFF's registers hold.  The K = bs update
takes a region whose one side is at most ``PANEL - bs`` (as the panel
schedule's are): a block keeps that side whole, with the operand along it
resident, and streams ``TILE`` rows or columns at a time along the other.
The panel body's tiles are ``PANEL_TILE`` x ``PANEL_TILE`` with K in
slices of 32 (4 under DROP_OFF).
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from ..core.async_pipeline import (ALL_STRATEGIES, SMEM_PER_BLOCK,
                                   PipelineSpec, Strategy, as_spec,
                                   smem_budget)
from . import _build
from .ref import lud_ref

__all__ = ["lud_cuda", "lud_plain", "lud_diagonal_cuda",
           "lud_diagonal_plain", "lud_perimeter_row_cuda",
           "lud_perimeter_row_plain", "lud_perimeter_col_cuda",
           "lud_perimeter_col_plain", "lud_perimeters_cuda",
           "lud_internal_cuda", "lud_internal_plain",
           "lud_internal_pair_cuda", "lud_internal_pair_plain",
           "lud_panel_plain", "lud_launches", "internal_substeps",
           "internal_smem", "lud_smem", "check_card_config", "LAUNCHES",
           "TILE", "PANEL", "PANEL_TILE", "CARD_BS"]

#: kernel launches so far, by kernel, in the order of the C launchers'
#: launched[6] (the counts chip_smoke.py reads); "internal" is the K = bs
#: body (one region, or a sub-step's two in one launch), "internal_panel"
#: the trailing update at K = PANEL, "perimeters" both perimeter solves in
#: one launch (lud_launch's; "perimeter_row" and "perimeter_col" count the
#: solves launched alone)
LAUNCHES: Dict[str, int] = dict.fromkeys(
    ("diagonal", "perimeter_row", "perimeter_col", "internal",
     "internal_panel", "perimeters"), 0)

#: rows (tall region) or columns (wide region) of a K = bs internal tile;
#: kLudTile in csrc/lud.cu
TILE = 32

#: the panel width of the schedule; kPanel in csrc/lud.cu
PANEL = 128

#: rows and columns of a panel-body C tile; LP_BM and LP_BN in csrc/lud.cu
PANEL_TILE = 128

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


Region = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def lud_internal_pair_plain(tall: Region, wide: Optional[Region]):
    """Both K = bs updates of a sub-step, each (L, U, C) -> C - L U: the
    tall region and the wide one (None: the last panel has none); returns
    (tall's C, wide's C or None)."""
    return (lud_internal_plain(*tall),
            None if wide is None else lud_internal_plain(*wide))


def lud_panel_plain(a: torch.Tensor, p: int, bs: int) -> int:
    """Factor the panel of ``a`` at column ``p`` in place over the plain
    versions: its sub-steps (diagonal, perimeters, the updates inside the
    panel), not its trailing update.  Returns the panel's end column."""
    n = a.shape[0]
    end = min(p + PANEL, n)
    for c in range(p, end, bs):
        c1 = c + bs
        a[c:c1, c:c1] = lud_diagonal_plain(a[c:c1, c:c1])
        if c1 == n:
            break
        diag = a[c:c1, c:c1]
        a[c:c1, c1:] = lud_perimeter_row_plain(diag, a[c:c1, c1:])
        a[c1:, c:c1] = lud_perimeter_col_plain(diag, a[c1:, c:c1])
        if c1 < end:
            tall, wide = lud_internal_pair_plain(
                (a[c1:, c:c1], a[c:c1, c1:end], a[c1:, c1:end]),
                (a[c1:end, c:c1], a[c:c1, end:], a[c1:end, end:])
                if end < n else None)
            a[c1:, c1:end] = tall
            if wide is not None:
                a[c1:end, end:] = wide
    return end


def lud_plain(a: torch.Tensor, bs: int = 32) -> torch.Tensor:
    """The panel schedule of ``lud_launch`` over the plain versions: the LU
    of ``lud_pallas``, its rounding in the card's order."""
    n = _check_square(a, bs)
    a = a.clone()
    for p in range(0, n, PANEL):
        end = lud_panel_plain(a, p, bs)
        if end < n:
            a[end:, end:] = lud_internal_plain(a[end:, p:end], a[p:end, end:],
                                               a[end:, end:])
    return a


def lud_launches(n: int, bs: int) -> Tuple[int, int, int, int, int, int]:
    """Launches of one ``lud_launch`` at n % bs == 0, by kernel in the order
    of ``LAUNCHES``: diagonal, perimeter row and column alone (none: the
    schedule launches them together), internal at K = bs (one launch for
    both updates of each sub-step but a panel's last: PANEL/bs - 1 a
    panel), the trailing updates (one after each panel but the last) and
    both perimeters in one launch (every step but the last)."""
    nb, g = n // bs, PANEL // bs
    panels = -(-n // PANEL)
    last = (n - (panels - 1) * PANEL) // bs          # sub-steps of the last
    return nb, 0, 0, (panels - 1) * (g - 1) + last - 1, panels - 1, nb - 1


def internal_substeps(n: int, bs: int) -> List[Tuple[int, int, int]]:
    """(c, c1, end) of each sub-step of the panel schedule that updates at
    K = bs, in order (c1 = c + bs; the panel ends at column ``end``): its
    tall region is C = A[c1:, c1:end] with L = A[c1:, c:c1] and U =
    A[c:c1, c1:end], its wide one (none when end == n) C = A[c1:end, end:]
    with L = A[c1:end, c:c1] and U = A[c:c1, end:]."""
    return [(c, c + bs, end) for p in range(0, n, PANEL)
            for end in (min(p + PANEL, n),)
            for c in range(p, end, bs) if c + bs < end]


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


def _panel_kc(spec: PipelineSpec) -> int:
    """K rows of a panel-body ring slot (LudPanelShape::kc)."""
    return 4 if spec.strategy is Strategy.DROP_OFF else 32


def internal_smem(spec: PipelineSpec, k: int) -> int:
    """Dynamic shared memory of one ``lud_internal`` block at K = ``k``: the
    K = bs body's at a card bs, the panel body's at K = ``PANEL``.

    K = bs, at the widest region (a kept side of m = ``PANEL`` - k):
    run_pipeline's ring, out ring and barriers for an L (TILE, k) or U (k,
    TILE) tile and a C tile of TILE x m, TMA's mbarrier for the resident
    operand, then at the next 128 bytes the resident L (m, k) or U (k, m).
    Panel: the ring of U (kc, PANEL_TILE) and L (PANEL_TILE, kc)
    slices (rows padded by 16 bytes; under TMA dense, after 1024 bytes for
    the ring base's alignment) and TMA's barriers; no out ring.  Raises
    ``ValueError`` at any other K or past what a block may have."""
    spec = as_spec(spec)
    smem = _internal_layout(spec, k)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"lud_internal {spec} at K={k} needs {smem} bytes "
                         f"of shared memory > {SMEM_PER_BLOCK}")
    return smem


def _internal_layout(spec: PipelineSpec, k: int) -> int:
    """``internal_smem``'s bytes, whether or not a block may have them."""
    if k == PANEL:
        kc, t = _panel_kc(spec), PANEL_TILE
        if spec.strategy is Strategy.TMA:
            smem = 1024 + smem_budget(spec, [kc * t * 4, t * kc * 4], 0).card
        else:
            smem = smem_budget(spec, [kc * (t * 4 + 16), t * (kc * 4 + 16)],
                               0).card
    else:
        _check_card_bs(k)
        m = PANEL - k
        tile = TILE * m * 4
        laid = smem_budget(spec, [k * TILE * 4, tile], tile).card + \
            (8 if spec.strategy is Strategy.TMA else 0)
        smem = -(-laid // 128) * 128 + k * m * 4
    return smem


def lud_smem(spec: PipelineSpec, bs: int) -> int:
    """The most shared memory a block of a card bs's factorisation has:
    the larger of the K = bs body's and the panel body's."""
    spec = as_spec(spec)
    return max(_internal_layout(spec, bs), _internal_layout(spec, PANEL))


def check_card_config(dtype: torch.dtype, spec: PipelineSpec,
                      bs: int) -> None:
    """Raise ``ValueError`` for what the card's factorisation refuses: a
    type other than float32, a bs the kernels are not built for, a K = bs
    or panel body past a block's shared memory.  Callable on the CPU."""
    if dtype != torch.float32:
        raise ValueError("lud kernel is built for float32")
    _check_card_bs(bs)
    internal_smem(spec, bs)
    internal_smem(spec, PANEL)


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
    if block.stride(0) % 4 or block.data_ptr() % 16:
        raise ValueError("lud_diagonal moves rows as float4: the block must "
                         "start on 16 bytes at a row pitch of a multiple of "
                         "4 floats")
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


def _check_col_strip(strip: torch.Tensor) -> None:
    if strip.stride(0) % 4 or strip.data_ptr() % 16:
        raise ValueError("the column solve moves a row's floats as float4: "
                         "the (H, bs) strip must start on 16 bytes at a row "
                         "pitch of a multiple of 4 floats")


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
    _check_col_strip(strip)
    _launch("lud_perimeter_col_launch", strip, bs, diag.data_ptr(),
            diag.stride(0), strip.data_ptr(), strip.stride(0), h)
    return strip


def lud_perimeters_cuda(diag: torch.Tensor, row: torch.Tensor,
                        col: torch.Tensor) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Both perimeter solves of one step in place, in one launch on the
    card: the (bs, W) ``row`` strip against ``diag``'s unit lower triangle
    and the (H, bs) ``col`` strip against its upper triangle; returns
    (row, col)."""
    bs, w = row.shape
    h = col.shape[0]
    _check_perimeter(diag, row, bs)
    _check_perimeter(diag, col, col.shape[1])
    if not _on_card("lud_perimeters", diag, row, col):
        row.copy_(lud_perimeter_row_plain(diag, row))
        col.copy_(lud_perimeter_col_plain(diag, col))
        return row, col
    _check_card_bs(bs)
    _check_rows("lud_perimeters", diag, row, col)
    _check_col_strip(col)
    _launch("lud_perimeters_launch", row, bs, diag.data_ptr(),
            diag.stride(0), row.data_ptr(), row.stride(0), w, col.data_ptr(),
            col.stride(0), h)
    return row, col


def _check_internal_shapes(what: str, l: torch.Tensor, u: torch.Tensor,
                           c: torch.Tensor) -> Tuple[int, int, int]:
    """(H, K, W) of C (H, W) -= L (H, K) U (K, W); raises on misfits."""
    (h, k), w = l.shape, u.shape[1]
    if tuple(u.shape) != (k, w) or tuple(c.shape) != (h, w) or \
            min(h, w, k) < 1:
        raise ValueError(f"{what} shapes L {tuple(l.shape)}, U "
                         f"{tuple(u.shape)}, C {tuple(c.shape)} do not fit")
    return h, k, w


def _check_streamed(what: str, l: torch.Tensor, u: torch.Tensor,
                    c: torch.Tensor) -> None:
    _check_rows(what, l, u, c)
    if u.shape[1] % 4 or any(t.stride(0) % 4 or t.data_ptr() % 16
                             for t in (l, u, c)):
        raise ValueError(f"{what} streams its tiles in 16-byte units: W and "
                         f"the row pitches must be multiples of 4 floats and "
                         f"L, U and C must start on 16 bytes")


def _region_args(l: torch.Tensor, u: torch.Tensor, c: torch.Tensor):
    return (l.data_ptr(), l.stride(0), u.data_ptr(), u.stride(0),
            c.data_ptr(), c.stride(0), c.shape[0], c.shape[1])


def lud_internal_cuda(l: torch.Tensor, u: torch.Tensor, c: torch.Tensor, *,
                      spec: PipelineSpec = PipelineSpec()) -> torch.Tensor:
    """C -= L U in place for L (H, K), U (K, W), C (H, W); returns C.

    On the card K = bs (16, 32 or 64) runs the K = bs body on one region,
    which takes min(H, W) <= ``PANEL`` - K, and K = ``PANEL`` the trailing
    update's body, whose L and U slices stream through the strategy's
    ring; any other K or shape raises."""
    spec = as_spec(spec)
    h, k, w = _check_internal_shapes("lud_internal", l, u, c)
    if not _on_card("lud_internal", l, u, c):
        return c.copy_(lud_internal_plain(l, u, c))
    smem = internal_smem(spec, k)                 # raises at any other K
    _check_streamed("lud_internal", l, u, c)
    args = (*_region_args(l, u, c)[:6], h, w, k, smem)
    if k == PANEL:
        strategy, ahead, _, depth = _spec_args(spec)
        _launch("lud_internal_panel_launch", c, strategy, ahead, depth, *args)
        return c
    if min(h, w) > PANEL - k:
        raise ValueError(f"lud_internal at K={k} takes a region with a side "
                         f"of at most PANEL - K = {PANEL - k}, got C "
                         f"{tuple(c.shape)}")
    _launch("lud_internal_launch", c, *_spec_args(spec), *args)
    return c


def lud_internal_pair_cuda(tall: Region, wide: Optional[Region], *,
                           spec: PipelineSpec = PipelineSpec()):
    """Both K = bs updates of a sub-step in place, in one launch on the
    card: ``tall`` = (L (H, K), U (K, w), C (H, w)) with w <= ``PANEL`` - K
    and ``wide`` = (L (h, K), U (K, W), C (h, W)) with h <= ``PANEL`` - K,
    or None; returns (tall's C, wide's C or None).  The two C may not
    overlap each other or any L or U (the sub-step's never do)."""
    spec = as_spec(spec)
    regions = [tall] + ([wide] if wide is not None else [])
    shapes = [_check_internal_shapes("lud_internal_pair", *r) for r in regions]
    k = shapes[0][1]
    if any(s_[1] != k for s_ in shapes):
        raise ValueError(f"lud_internal_pair's regions differ in K: "
                         f"{[s_[1] for s_ in shapes]}")
    if not _on_card("lud_internal_pair", *(t for r in regions for t in r)):
        got = lud_internal_pair_plain(tall, wide)
        for r, c_new in zip(regions, got):
            r[2].copy_(c_new)
        return tall[2], None if wide is None else wide[2]
    _check_card_bs(k)
    smem = internal_smem(spec, k)
    if shapes[0][2] > PANEL - k or (wide is not None and
                                    shapes[1][0] > PANEL - k):
        raise ValueError(f"lud_internal_pair at K={k}: the tall region's "
                         f"width and the wide one's height must be at most "
                         f"PANEL - K = {PANEL - k}, got {shapes}")
    for r in regions:
        _check_streamed("lud_internal_pair", *r)
    args = _region_args(*tall) + (_region_args(*wide) if wide is not None
                                  else (0,) * 8)
    _launch("lud_internal_pair_launch", tall[2], *_spec_args(spec), *args, k,
            smem)
    return tall[2], None if wide is None else wide[2]


def _lud_launch(work: torch.Tensor, bs: int,
                spec: PipelineSpec) -> Tuple[int, ...]:
    """One ``lud_launch`` on the contiguous square ``work``, in place;
    returns the launches it enqueued by kernel."""
    internal_smem(spec, PANEL)                        # raises if too large
    return _launch("lud_launch", work, *_spec_args(spec), work.data_ptr(),
                   work.shape[0], bs, internal_smem(spec, bs))


def lud_cuda(a: torch.Tensor, *, bs: int = 32,
             spec: PipelineSpec = PipelineSpec()) -> torch.Tensor:
    """Blocked LU of the (n, n) ``a`` with n % bs == 0, returned as the
    combined LU matrix (matches ``ref.lud_ref``); ``a`` is not changed."""
    spec = as_spec(spec)
    n = _check_square(a, bs)
    if not _on_card("lud", a):
        return lud_plain(a, bs)
    check_card_config(a.dtype, spec, bs)
    work = a.clone(memory_format=torch.contiguous_format)
    got, want = _lud_launch(work, bs, spec), lud_launches(n, bs)
    if got != want:
        raise RuntimeError(f"lud_launch enqueued {got} launches by kernel, "
                           f"not the {want} of n={n} bs={bs}")
    return work
