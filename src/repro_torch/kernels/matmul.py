"""Tiled matmul, (M, K) @ (K, N) into f32, its K loop under a copy strategy.

The counterpart of ``repro.kernels.matmul`` (``matmul_pallas``).
``matmul_cuda`` launches ``csrc/matmul.cu`` for CUDA tensors and computes
``matmul_plain`` for CPU tensors; nothing else reaches the plain version.
``LAUNCHES`` counts kernel launches by input type.

The card takes the reference's seed blocks bm = bn = 128 only; its own
output tiles are the kernel's business.  Each block streams its K loop in
sub-tiles of ``k_tile(dtype, strategy)`` rows: the reference's bk = 128
would need 64 KB (bf16) or 192 KB (f32) a ring slot, and ``chip_smoke.py``
runs rings of depth 4.  bk stays the K granularity the shape must divide,
and must divide by the sub-tile.  The reference's pipeline has no
write-back ring, so the spec's ``out_depth`` is not used here.

f32 runs on FFMA (the reference's 1e-4 rules out TF32), one block an SM,
in 128 x ``F32_WIDE`` output tiles (8 x 16 sums a thread) and 32-row
sub-tiles: A's 128 rows of 32 floats and B's 32 rows of 256 floats.  The
copies pad every row by 16 bytes, 51,712 bytes a slot; TMA loads A's box
into the 128-byte swizzle (the ring base on ``RING_ALIGN``) and B's box
dense, 49,152 bytes a slot.  The blocks run in groups of 16 row tiles,
all column tiles of a group before the next, so that what a wave of
blocks reads stays in the L2.  When n % 256 == 128 the last 128 columns
are a second launch of 128-wide tiles (``f32_launch_plan``).  DROP_OFF
holds a thread's share of a slot in registers beside its sums, so it runs
128-wide tiles (8 x 8 sums) on every column, in 4-row sub-tiles, two
blocks an SM.  bf16
runs on ``wgmma`` with f32 accumulators in 128 x 128 tiles and 64-row
sub-tiles at every strategy: a row of A's tile is 128 bytes, B's tile is
two 64-column halves of 128-byte rows, each stored in the 128-byte
swizzle, so a slot is 32 KB and starts on 1024 bytes: the ring is
budgeted ``RING_ALIGN`` bytes more for the kernel to round its base up.

``matmul_batched_cuda`` runs a bf16 kernel of its own over a stack of E
independent products, (E, M, K) x (E, K, N) -> f32 (E, M, N), in one
persistent launch (the moe family's expert products, xlstm's headwise
ones); ``matmul_batched_plain`` is its plain version and
``BATCHED_LAUNCHES`` its launch counter.  Its tiles are
``batched_tile_rows(M)`` rows (256 where M % 256 == 0, else 128) by
``batched_tile_cols`` columns (128; 256 under TMA at 128 rows), its slot
``batched_tiles``: A's tile rows of 128 bytes and B's 64 K rows of the
tile's columns, 48 KB but at 128 x 128 (32 KB); under TMA each slot has
two mbarriers (full and empty: a producer warp feeds two consumer
warpgroups), ``batched_smem`` the budget.

Its transposed forms, ``matmul_batched_cuda(..., trans_a=True)`` (dB =
A^T dC, A stored (E, K, M)) and ``trans_b=True`` (dA = dC B^T, B stored
(E, N, K)), are the batched product's backward: the same kernel reading
the stacks where they lie (TMA boxes of the stored layout, wgmma's
transpose bits), under TMA only, at the forward's tiles and K order, so
each is bit-identical to the forward on host-transposed copies.
``BATCHED_T_LAUNCHES`` counts them by form.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import torch

from ..core.async_pipeline import (ALL_STRATEGIES, SMEM_PER_BLOCK,
                                   PipelineSpec, Strategy, as_spec,
                                   smem_budget)
from . import _build

__all__ = ["matmul_cuda", "matmul_plain", "matmul_smem", "k_tile",
           "check_card_config", "bf16_tiles", "f32_tiles", "f32_tile_width",
           "f32_launch_plan", "launches", "LAUNCHES", "BLOCK", "F32_WIDE",
           "RING_ALIGN", "matmul_batched_cuda", "matmul_batched_plain",
           "check_batched_card_config", "batched_tile_rows",
           "batched_tile_cols", "batched_tiles", "batched_smem",
           "BATCHED_LAUNCHES", "BATCHED_T_LAUNCHES", "MAX_BATCH"]

#: kernel launches so far, by input type (the counts chip_smoke.py reads
#: around a run)
LAUNCHES: Dict[str, int] = {"float32": 0, "bfloat16": 0}
#: launches of the batched bf16 kernel (``matmul_batched_cuda``)
BATCHED_LAUNCHES = 0
#: launches of its transposed forms, by form
BATCHED_T_LAUNCHES: Dict[str, int] = {"trans_a": 0, "trans_b": 0}
#: the most products one batched launch takes
MAX_BATCH = 65535

#: the blocks the card takes (bm, bn), and its bf16 output tiles; MM_BM
#: and MM_BN in csrc/matmul.cu
BLOCK = 128
#: columns of the f32 kernel's output tiles (kF32Wide)
F32_WIDE = 256

#: K rows of a ring slot (MmF32Shape::kc and kBf16K in csrc/matmul.cu): (other
#: strategies, DROP_OFF)
_K_TILE = {torch.float32: (32, 4), torch.bfloat16: (64, 64)}
#: f32: bytes the copies add to every row pitch in shared memory (kRowPad)
_ROW_PAD = 16
#: the ring base's alignment of the swizzled slots (bf16, f32 under TMA),
#: budgeted in full (kBf16Align, MmF32Shape::align)
RING_ALIGN = 1024


def k_tile(dtype: torch.dtype, strategy: Strategy) -> int:
    """K rows a ring slot holds on the card for ``dtype`` and ``strategy``."""
    return _K_TILE[dtype][strategy is Strategy.DROP_OFF]


def matmul_plain(a: torch.Tensor, b: torch.Tensor, *,
                 bk: int = 128) -> torch.Tensor:
    """The kernel's function in plain torch: the f32 accumulator summed
    over the K tiles of ``bk`` rows, as the reference's K loop."""
    acc = a.new_zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k0 in range(0, a.shape[1], bk):
        acc += a[:, k0:k0 + bk].float() @ b[k0:k0 + bk].float()
    return acc


def bf16_tiles() -> Tuple[int, int, int]:
    """Bytes of a bf16 slot's three tiles, in slot order: A (BLOCK rows of
    128 bytes) and B's two halves (64 K rows of 128 bytes each)."""
    kc = _K_TILE[torch.bfloat16][0]
    return BLOCK * kc * 2, kc * 128, kc * 128


def f32_tile_width(strategy: Strategy) -> int:
    """Columns of the f32 kernel's widest output tile under ``strategy``:
    DROP_OFF's registers hold a slot's share beside 8 x 8 sums only."""
    return BLOCK if strategy is Strategy.DROP_OFF else F32_WIDE


def f32_tiles(strategy: Strategy) -> Tuple[int, int]:
    """Bytes of an f32 slot's two tiles at the strategy's widest output
    tile (MmF32Shape), in slot order: A (BLOCK rows of kc floats) and B (kc
    rows of the tile's columns); the copies pad every row, TMA's boxes land
    dense."""
    kc = k_tile(torch.float32, strategy)
    pad = 0 if strategy is Strategy.TMA else _ROW_PAD
    return (BLOCK * (kc * 4 + pad),
            kc * (f32_tile_width(strategy) * 4 + pad))


def f32_launch_plan(n: int, strategy: Strategy) -> List[Tuple[int, int, int]]:
    """(first column, columns, tile width) of each launch of one f32 call
    (MatmulF32Launch): 256-wide tiles, then a 128-column strip when n % 256
    == 128; DROP_OFF one launch of 128-wide tiles."""
    width = f32_tile_width(strategy)
    wide = n - n % width
    return [(c0, cols, w) for c0, cols, w in
            ((0, wide, width), (wide, n - wide, BLOCK)) if cols]


def launches(dtype: torch.dtype, strategy: Strategy, n: int) -> int:
    """Kernel launches of one call on the card with N = ``n``."""
    if dtype == torch.float32:
        return len(f32_launch_plan(n, strategy))
    return 1


@functools.lru_cache(maxsize=None)
def matmul_smem(spec: PipelineSpec, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block: run_pipeline's ring (no out
    ring) and TMA's mbarriers, after ``RING_ALIGN`` bytes for the base's
    rounding where the slots are swizzled.  f32: the tiles of
    ``f32_tiles``; bf16: the three of ``bf16_tiles``."""
    if dtype == torch.bfloat16:
        return RING_ALIGN + smem_budget(spec, bf16_tiles(), 0).card
    align = RING_ALIGN if spec.strategy is Strategy.TMA else 0
    return align + smem_budget(spec, f32_tiles(spec.strategy), 0).card


def _check(a: torch.Tensor, b: torch.Tensor, spec: PipelineSpec, bm: int,
           bk: int, bn: int) -> bool:
    """Validate the call; True for CUDA tensors, False for CPU ones."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul takes (M, K) @ (K, N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    (m, k), n = a.shape, b.shape[1]
    if min(bm, bk, bn) < 1 or m % bm or k % bk or n % bn:
        raise ValueError(f"shape {(m, k, n)} not divisible by blocks "
                         f"{(bm, bk, bn)}")
    devices = {a.device, b.device}
    if all(d.type == "cpu" for d in devices):
        return False
    if len(devices) != 1 or a.device.type != "cuda":
        raise ValueError(f"matmul takes tensors on one CPU or CUDA device, "
                         f"got {sorted(map(str, devices))}")
    if a.dtype != b.dtype:
        raise ValueError(f"matmul kernel takes operands of one type, not "
                         f"{a.dtype} and {b.dtype}")
    check_card_config(a.dtype, spec, bm, bk, bn)
    return True


@functools.lru_cache(maxsize=None)
def check_card_config(dtype: torch.dtype, spec: PipelineSpec, bm: int,
                      bk: int, bn: int) -> None:
    """Raise ``ValueError`` for what the card's kernel is not built for:
    another type, blocks other than ``BLOCK``, a bk the K sub-tile does
    not divide, a ring past a block's shared memory."""
    if dtype not in _K_TILE:
        raise ValueError(f"matmul kernel is built for float32 or bfloat16, "
                         f"not {dtype}")
    if (bm, bn) != (BLOCK, BLOCK):
        raise ValueError(f"the card's matmul blocks are {BLOCK} x {BLOCK}, "
                         f"got bm={bm} bn={bn}")
    kc = k_tile(dtype, spec.strategy)
    if bk % kc:
        raise ValueError(f"bk={bk} must divide by the card's K sub-tile "
                         f"{kc} ({dtype}, {spec.strategy.value})")
    smem = matmul_smem(spec, dtype)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"{spec} needs {smem} bytes of shared memory > "
                         f"{SMEM_PER_BLOCK}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and on 16 bytes (the copies move 16-byte units)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def matmul_cuda(a: torch.Tensor, b: torch.Tensor, *,
                spec: PipelineSpec = PipelineSpec(), bm: int = 128,
                bk: int = 128, bn: int = 128) -> torch.Tensor:
    """a (M, K) @ b (K, N) -> f32 (M, N); dims must divide the blocks.
    Invalid shapes and configs raise ``ValueError``; a failed build or
    launch raises ``RuntimeError``."""
    spec = as_spec(spec)
    if not _check(a, b, spec, bm, bk, bn):
        return matmul_plain(a, b, bk=bk)
    a, b = _aligned(a), _aligned(b)
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    lib = _build.library("matmul")
    rc = lib.matmul_launch(
        a.device.index or 0, ALL_STRATEGIES.index(spec.strategy), spec.ahead,
        spec.ring_depth, int(a.dtype == torch.bfloat16), a.data_ptr(),
        b.data_ptr(), out.data_ptr(), m, k, n, matmul_smem(spec, a.dtype),
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(lib, rc, f"matmul kernel launch ({spec})")
    LAUNCHES[str(a.dtype).removeprefix("torch.")] += launches(
        a.dtype, spec.strategy, n)
    return out


# -- the batched launch: E products of three stacks ---------------------------

def matmul_batched_plain(a: torch.Tensor, b: torch.Tensor, *,
                         bk: int = 128, trans_a: bool = False,
                         trans_b: bool = False) -> torch.Tensor:
    """``matmul_plain`` product by product: a (E, M, K) @ b (E, K, N) -> f32
    (E, M, N), the accumulator summed over the K tiles of ``bk`` rows; a
    given as (E, K, M) with ``trans_a``, b as (E, N, K) with ``trans_b``."""
    a = a.transpose(1, 2) if trans_a else a
    b = b.transpose(1, 2) if trans_b else b
    acc = a.new_zeros((a.shape[0], a.shape[1], b.shape[2]),
                      dtype=torch.float32)
    for k0 in range(0, a.shape[2], bk):
        acc += torch.bmm(a[:, :, k0:k0 + bk].float(),
                         b[:, k0:k0 + bk].float())
    return acc


def batched_tile_rows(m: int) -> int:
    """Rows of the batched launch's output tiles for products of ``m``
    rows: 256 where ``m`` divides by 256 (a tile is a prefill expert's
    whole rows, so each of B's sub-tiles crosses from the L2 to an SM
    once), else ``BLOCK`` (BatchedShape in csrc/matmul.cu)."""
    return 2 * BLOCK if m % (2 * BLOCK) == 0 else BLOCK


def batched_tile_cols(m: int, strategy: Strategy) -> int:
    """Columns of the batched launch's output tiles: 256 under TMA at
    128-row tiles (each consumer warpgroup one 128-column strip, so a slot
    holds twice the weights' bytes), else ``BLOCK``."""
    return 2 * BLOCK if strategy is Strategy.TMA and \
        batched_tile_rows(m) == BLOCK else BLOCK


def batched_tiles(m: int, strategy: Strategy) -> Tuple[int, int]:
    """Bytes of a batched slot's two tiles at ``m`` rows, in slot order: A
    (``batched_tile_rows(m)`` rows of 128 bytes) and B (64 K rows of
    ``batched_tile_cols`` columns, in 64-column halves of 128-byte rows)."""
    return (batched_tile_rows(m) * 128,
            k_tile(torch.bfloat16, strategy) * 2
            * batched_tile_cols(m, strategy))


@functools.lru_cache(maxsize=None)
def batched_smem(spec: PipelineSpec, m: int) -> int:
    """Dynamic shared memory of one batched block at ``m`` rows:
    ``RING_ALIGN`` bytes for the ring base's rounding, the ring of
    ``batched_tiles`` slots (SYNC's one staging slot), and under TMA a
    full and an empty mbarrier a slot."""
    spec = as_spec(spec)
    empty = 8 * spec.ring_depth if spec.strategy is Strategy.TMA else 0
    return RING_ALIGN + smem_budget(
        spec, batched_tiles(m, spec.strategy), 0).card + empty


@functools.lru_cache(maxsize=None)
def check_batched_card_config(dtype: torch.dtype, spec: PipelineSpec, e: int,
                              m: int, k: int, n: int, trans_a: bool = False,
                              trans_b: bool = False) -> None:
    """Raise ``ValueError`` for what the batched launch is not built for: a
    type other than bfloat16, M, K or N not a multiple of ``BLOCK``, more
    products than ``MAX_BATCH``, stacks or tiles past 32-bit coordinates,
    and a ring past a block's shared memory at the tile height M gives
    (``batched_smem``).  The transposed forms (``trans_a``, ``trans_b``)
    are built for one flag at a time, under TMA at a ring of 2 slots or
    more, with E N under 2^31 too (B's stacked rows under ``trans_b``)."""
    if trans_a or trans_b:
        if trans_a and trans_b:
            raise ValueError("the batched launch transposes one operand, "
                             "not both")
        if spec.strategy is not Strategy.TMA or spec.ring_depth < 2:
            raise ValueError(f"the batched launch's transposed forms are "
                             f"built for TMA at a ring of 2 slots or more, "
                             f"not {spec}")
    if dtype != torch.bfloat16:
        raise ValueError(f"the batched matmul launch is built for bfloat16, "
                         f"not {dtype}")
    if min(e, m, k, n) < 1 or m % BLOCK or k % BLOCK or n % BLOCK:
        raise ValueError(f"batched matmul takes M, K and N multiples of "
                         f"{BLOCK}, got (E, M, K, N) = {(e, m, k, n)}")
    tiles = e * (m // batched_tile_rows(m)) * (n // BLOCK)
    if e > MAX_BATCH or max(e * m, e * k, e * n if trans_b else 0,
                            tiles) >= 2 ** 31:
        raise ValueError(f"batched matmul: {e} products of {(m, k, n)} pass "
                         f"{MAX_BATCH} products or 2^31 stacked rows or tiles")
    smem = batched_smem(spec, m)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"{spec} at {batched_tile_rows(m)} x "
                         f"{batched_tile_cols(m, spec.strategy)} tiles needs "
                         f"{smem} bytes of shared memory > {SMEM_PER_BLOCK}")


def _batched_dims(a: torch.Tensor, b: torch.Tensor, trans_a: bool,
                  trans_b: bool) -> Tuple[int, int, int, int]:
    """(E, M, K, N) of a batched call, a stored (E, K, M) with ``trans_a``
    and b (E, N, K) with ``trans_b``; ``ValueError`` for other shapes."""
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0]:
        raise ValueError(f"batched matmul takes (E, M, K) @ (E, K, N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    (e, m, k), (kb, n) = a.shape, b.shape[1:]
    if trans_a:
        m, k = k, m
    if trans_b:
        kb, n = n, kb
    if k != kb:
        raise ValueError(f"batched matmul takes (E, M, K) @ (E, K, N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)} (trans_a "
                         f"{trans_a}, trans_b {trans_b})")
    return e, m, k, n


def _check_batched(a: torch.Tensor, b: torch.Tensor, spec: PipelineSpec,
                   trans_a: bool = False, trans_b: bool = False) -> bool:
    """Validate a batched call; True for CUDA tensors, False for CPU ones."""
    e, m, k, n = _batched_dims(a, b, trans_a, trans_b)
    devices = {a.device, b.device}
    if all(d.type == "cpu" for d in devices):
        return False
    if len(devices) != 1 or a.device.type != "cuda":
        raise ValueError(f"batched matmul takes tensors on one CPU or CUDA "
                         f"device, got {sorted(map(str, devices))}")
    if a.dtype != b.dtype:
        raise ValueError(f"batched matmul takes operands of one type, not "
                         f"{a.dtype} and {b.dtype}")
    check_batched_card_config(a.dtype, spec, e, m, k, n, trans_a, trans_b)
    return True


def matmul_batched_cuda(a: torch.Tensor, b: torch.Tensor, *,
                        spec: PipelineSpec = PipelineSpec(),
                        trans_a: bool = False,
                        trans_b: bool = False) -> torch.Tensor:
    """a (E, M, K) @ b (E, K, N) -> f32 (E, M, N), product by product, in
    one launch of the batched bf16 kernel (CPU tensors:
    ``matmul_batched_plain``).  Each row's sums run in the 2-D kernel's K
    order, so a row's bits are the 2-D kernel's at the same strategy.
    ``trans_a``: a is stored (E, K, M) and read as its transpose in place;
    ``trans_b``: b is stored (E, N, K) (the transposed forms, TMA only).
    What the card refuses raises ``ValueError``; a failed build or launch
    ``RuntimeError``."""
    global BATCHED_LAUNCHES
    spec = as_spec(spec)
    if not _check_batched(a, b, spec, trans_a, trans_b):
        return matmul_batched_plain(a, b, trans_a=trans_a, trans_b=trans_b)
    a, b = _aligned(a), _aligned(b)
    e, m, k, n = _batched_dims(a, b, trans_a, trans_b)
    out = torch.empty((e, m, n), dtype=torch.float32, device=a.device)
    lib = _build.library("matmul")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    if trans_a or trans_b:
        rc = lib.matmul_batched_t_launch(
            a.device.index or 0, spec.ring_depth, int(trans_a), int(trans_b),
            a.data_ptr(), b.data_ptr(), out.data_ptr(), e, m, k, n,
            batched_smem(spec, m), stream)
        form = "trans_a" if trans_a else "trans_b"
        _build.check(lib, rc, f"batched matmul kernel launch, {form} ({spec})")
        BATCHED_T_LAUNCHES[form] += 1
        return out
    rc = lib.matmul_batched_launch(
        a.device.index or 0, ALL_STRATEGIES.index(spec.strategy), spec.ahead,
        spec.ring_depth, a.data_ptr(), b.data_ptr(), out.data_ptr(), e, m, k,
        n, batched_smem(spec, m), stream)
    _build.check(lib, rc, f"batched matmul kernel launch ({spec})")
    BATCHED_LAUNCHES += 1
    return out
