"""Flash attention: online-softmax attention with GQA, causal and
sliding-window masks, the KV loop under a copy strategy.

The counterpart of ``repro.kernels.flash_attention``
(``flash_attention_pallas``, with the batch dims ``repro.kernels.ops``
vmaps).  ``flash_attention_cuda`` launches ``csrc/flash_attention.cu`` for
CUDA tensors and computes ``flash_attention_plain`` for CPU tensors;
nothing else reaches the plain version.  ``LAUNCHES`` counts kernel
launches.

On the card one launch covers every leading batch dim: a block is one q
head of the flattened (B * H) and one q block of ``BQ`` = 128 rows (the
reference's seed bq, the only one the card takes), and q head ``qh`` reads
KV head ``qh // (H / KVH)``.  Its KV range is pruned in units of the
reference's bk (``kv_range``) and streams in sub-tiles of ``kv_tile(strategy)``
rows: one K+V slot at bk = 128 and D = 128 is 128 KB, and ``chip_smoke.py``
runs rings of depth 4.  The sub-tiles are 32 rows (33 KB a slot at D = 128;
with the q tile, 196 KB at depth 4); DROP_OFF holds its share of a slot in
registers and takes one mma step, 8 rows.  Both products run on the tensor
cores as 3xTF32 (tests/test_torch_flash_attention.py replays that
arithmetic on the CPU).  The card takes q, k and v all float32 or all
bfloat16 at D in {64, 128}; the output is float32 either way, as the
reference's.  bf16 K and V stay bf16 in the ring (half its bytes); q is
widened and scaled in f32, and since a bf16 value is exact in TF32 each
product takes two of the three TF32 products.  Any other type raises
``ValueError``.  The reference's pipeline has no write-back ring, so the
spec's ``out_depth`` is not used.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.async_pipeline import (ALL_STRATEGIES, SMEM_PER_BLOCK,
                                   PipelineSpec, Strategy, as_spec,
                                   smem_budget)
from . import _build
from .matmul import _aligned

__all__ = ["flash_attention_cuda", "flash_attention_plain", "flash_smem",
           "check_card_config", "kv_range", "kv_tile", "LAUNCHES", "BQ",
           "CARD_D", "CARD_DTYPES"]

#: kernel launches so far (the count chip_smoke.py reads around a run)
LAUNCHES = 0

#: q rows of a block on the card; FA_BQ in csrc/flash_attention.cu
BQ = 128

#: head dims the card's kernel is built for
CARD_D = (64, 128)

#: the reference's masked logit (NEG_INF in its kernel)
NEG_INF = -1e30

#: bytes added to every K and V row pitch in shared memory (kRowPad)
_ROW_PAD = 16


def kv_tile(strategy: Strategy) -> int:
    """KV rows a ring slot holds on the card (fa_kc)."""
    return 8 if strategy is Strategy.DROP_OFF else 32


def kv_range(q0: int, s: int, bq: int, bk: int, causal: bool,
             window: int) -> Tuple[int, int]:
    """The [lo, hi) KV tiles of bk rows the q block at row q0 reads: the
    reference's pruning (flash_attention.py:44-55)."""
    hi = min(-(-(q0 + bq) // bk), s // bk) if causal else s // bk
    lo = max((q0 - window + 1) // bk, 0) if window > 0 else 0
    return lo, hi


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          scale: Optional[float] = None, bq: int = 128,
                          bk: int = 128) -> torch.Tensor:
    """The kernel's function in plain torch: the reference's online softmax
    over the pruned KV tiles, q block by q block, every head at once.
    q (..., H, S, D), k/v (..., KVH, S, D) -> f32 (..., H, S, D)."""
    h, s, d = q.shape[-3:]
    scale = scale if scale is not None else 1.0 / d ** 0.5
    rep = h // k.shape[-3]
    qf = q.float() * scale
    kf, vf = (t.float().repeat_interleave(rep, dim=-3) for t in (k, v))
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    rows = torch.arange(bq, device=q.device)[:, None]
    cols = torch.arange(bk, device=q.device)[None, :]
    for q0 in range(0, s, bq):
        qt = qf[..., q0:q0 + bq, :]
        acc = torch.zeros_like(qt)
        m = torch.full((*qt.shape[:-1], 1), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        lo, hi = kv_range(q0, s, bq, bk, causal, window)
        for t in range(lo, hi):
            kt = kf[..., t * bk:(t + 1) * bk, :]
            vt = vf[..., t * bk:(t + 1) * bk, :]
            logits = qt @ kt.transpose(-1, -2)
            qi, kvi = q0 + rows, t * bk + cols
            mask = torch.ones((bq, bk), dtype=torch.bool, device=q.device)
            if causal:
                mask &= kvi <= qi
            if window > 0:
                mask &= kvi > qi - window
            logits = logits.masked_fill(~mask, NEG_INF)
            m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p @ vt
            m = m_new
        out[..., q0:q0 + bq, :] = acc / l.clamp_min(1e-30)
    return out


#: the input types the card's kernel is built for, with their launchers
CARD_DTYPES = {torch.float32: "flash_attention_launch",
               torch.bfloat16: "flash_attention_bf16_launch"}


def flash_smem(spec: PipelineSpec, d: int,
               dtype: torch.dtype = torch.float32) -> int:
    """Dynamic shared memory of one block: run_pipeline's ring (no out
    ring) of a K and a V sub-tile in ``dtype``, then at the next 16 bytes
    the q tile, f32 in fragment order with no pad (fa_smem)."""
    kc = kv_tile(spec.strategy)
    pitch = d * torch.empty((), dtype=dtype).element_size() + _ROW_PAD
    ring = smem_budget(spec, [kc * pitch, kc * pitch], 0).card
    return (ring + 15) // 16 * 16 + BQ * d * 4


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           spec: PipelineSpec, bq: int, bk: int) -> bool:
    """Validate the call; True for CUDA tensors, False for CPU ones."""
    if q.dim() < 3 or k.shape != v.shape or k.dim() != q.dim() or \
            q.shape[:-3] != k.shape[:-3] or q.shape[-2:] != k.shape[-2:]:
        raise ValueError(f"flash attention takes q (..., H, S, D) and k, v "
                         f"(..., KVH, S, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    h, s, d = q.shape[-3:]
    if k.shape[-3] < 1 or h % k.shape[-3]:
        raise ValueError(f"H={h} q heads must divide by KVH={k.shape[-3]}")
    if bq < 1 or bk < 1 or s % bq or s % bk:
        raise ValueError(f"seq {s} must divide bq={bq}, bk={bk}")
    devices = {q.device, k.device, v.device}
    if all(dev.type == "cpu" for dev in devices):
        return False
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"flash attention takes tensors on one CPU or CUDA "
                         f"device, got {sorted(map(str, devices))}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"the card's flash attention takes q, k and v of "
                         f"one type, got {q.dtype}, {k.dtype}, {v.dtype}")
    check_card_config(d, q.dtype, spec, bq, bk)
    return True


def check_card_config(d: int, dtype: torch.dtype, spec: PipelineSpec,
                      bq: int, bk: int) -> None:
    """Raise ``ValueError`` for what the card's kernel refuses: a type
    outside CARD_DTYPES, a head dim outside CARD_D, bq other than BQ, a bk
    the KV sub-tile does not divide, a ring past a block's shared memory.
    Callable on the CPU."""
    if dtype not in CARD_DTYPES:
        raise ValueError(f"the card's flash attention kernel is built for "
                         f"{sorted(map(str, CARD_DTYPES))}, not {dtype}")
    if d not in CARD_D or bq != BQ:
        raise ValueError(f"the card's flash attention takes D in {CARD_D} "
                         f"and bq={BQ}, got D={d} bq={bq}")
    kc = kv_tile(spec.strategy)
    if bk % kc:
        raise ValueError(f"bk={bk} must divide by the card's KV sub-tile "
                         f"{kc} ({spec.strategy.value})")
    smem = flash_smem(spec, d, dtype)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"{spec} at D={d} needs {smem} bytes of shared "
                         f"memory > {SMEM_PER_BLOCK}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         scale: Optional[float] = None,
                         spec: PipelineSpec = PipelineSpec(), bq: int = 128,
                         bk: int = 128) -> torch.Tensor:
    """q (..., H, S, D), k/v (..., KVH, S, D), all f32 or all bf16 on the
    card -> f32 (..., H, S, D), one launch for all leading dims.  Invalid
    shapes, types and configs raise ``ValueError``; a failed build or
    launch raises ``RuntimeError``."""
    global LAUNCHES
    spec = as_spec(spec)
    if not _check(q, k, v, spec, bq, bk):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, bq=bq, bk=bk)
    h, s, d = q.shape[-3:]
    scale = scale if scale is not None else 1.0 / d ** 0.5
    q, k, v = (_aligned(t) for t in (q, k, v))
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lib = _build.library("flash_attention")
    rc = getattr(lib, CARD_DTYPES[q.dtype])(
        q.device.index or 0, ALL_STRATEGIES.index(spec.strategy), spec.ahead,
        spec.ring_depth, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), q.numel() // (s * d), h, k.shape[-3], s, d, bk,
        int(causal), int(window), float(scale), flash_smem(spec, d, q.dtype),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, f"flash attention kernel launch ({spec})")
    LAUNCHES += 1
    return out
