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
reference's bk (``kv_range``) and streams in sub-tiles of
``kv_tile(strategy, dtype)`` rows: one K+V slot at bk = 128 and D = 128 is
128 KB in f32, and ``chip_smoke.py`` runs rings of depth 4.  The card takes
q, k and v all float32 or all bfloat16 at D in {64, 128}; the output is
float32 either way, as the reference's.  Any other type raises
``ValueError``.  The two types run two designs
(tests/test_torch_flash_attention.py replays each one's arithmetic on the
CPU):

* float32: both products as 3xTF32 ``mma.sync``, 32-row sub-tiles (33 KB
  a slot at D = 128, K and V rows padded by 16 bytes; with the f32 q tile,
  196 KB at depth 4); DROP_OFF holds its share of a slot in registers and
  takes one mma step, 8 rows.
* bfloat16: both products on bf16 ``wgmma``, Q K^T as one product and P V
  as three, one a bf16 term of the f32 P; 64-row sub-tiles of K and V in
  the 128-byte swizzle with no pad (32 KB a slot at D = 128; with the bf16
  q tile and the 1,024 bytes that align the ring, 161 KB at depth 4);
  DROP_OFF takes 16-row slots into registers and runs bf16 ``mma.sync``.

The reference's pipeline has no write-back ring, so the spec's
``out_depth`` is not used.

The backward (``flash_attention_bwd_cuda``, csrc/flash_attention_bwd.cu, a
library of its own; no Pallas counterpart: JAX differentiates ``jnp``)
takes the forward's inputs, its f32 output and that output's gradient and
returns dQ, dK and dV in the input type.  It recomputes each row's softmax
statistics over the forward's KV tiles (the forward writes none), then
runs dK/dV a block of keys (summing a KV head's group in a fixed order,
no atomics) and dQ a block of queries: three launches a call.  Two
designs, as the forward's:

* float32: every product 3xTF32 on ``mma.sync`` m16n8k8 (each operand
  split into tf32 hi and lo as its fragment is loaded: lo hi, hi lo, hi
  hi), 64-row blocks of f32 tiles through two cp.async slots, 8 warps a
  block, each a 16 x 32 share of a 64 x 64 logit block, the logits' and
  dP's accumulators read in place as the A fragments of dV, dK and dQ;
  each step's product is summed from zero before it is added, as the
  tensor core's f32 accumulation is not rounded to nearest
  (tests/test_torch_flash_backward_tf32_replay.py replays it).
* bfloat16: every product on bf16 ``wgmma`` with TMA loads, a producer
  warpgroup and two consumer warpgroups a block.  dO, P and dS are f32
  values, each split into two bf16 terms (hi, and the bf16 of the
  remainder); a product of two split operands keeps hi hi, hi lo and lo
  hi.  One term each misses the card's 3e-3 relative l2 against float64;
  two each sit at the gradients' own bf16 rounding
  (tests/test_torch_flash_backward_replay.py replays the arithmetic).
  prep writes dO's terms beside the row statistics, so the scratch holds
  3 B H S floats and B H S D bf16 twice.

``flash_attention_bwd_plain`` does the same steps tile by tile, and
``FlashAttention`` is the autograd Function over both passes.

``kv_len`` (1 <= kv_len <= S; None: S, the reference's call) is the key
count: keys at index kv_len and past are masked for every query, and the
KV tiles wholly past it are not read.  A caller that zero-pads S up to a
multiple of ``BQ`` passes its true length, so that the padded keys stay
hidden from a non-causal query too (a causal mask hides them from every
real query by itself).
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
           "check_card_config", "check_kv_len", "kv_range", "kv_tile",
           "flash_attention_bwd_cuda", "flash_attention_bwd_plain",
           "FlashAttention", "LAUNCHES", "BWD_LAUNCHES", "BWD_KERNELS", "BQ",
           "CARD_D", "CARD_DTYPES"]

#: kernel launches so far (the count chip_smoke.py reads around a run)
LAUNCHES = 0
#: the backward's kernel launches so far (BWD_KERNELS a call)
BWD_LAUNCHES = 0
#: kernels one backward call launches: prep, dK/dV, dQ
BWD_KERNELS = 3

#: q rows of a block on the card; FA_BQ in csrc/flash_attention.cu
BQ = 128

#: head dims the card's kernel is built for
CARD_D = (64, 128)

#: the reference's masked logit (NEG_INF in its kernel)
NEG_INF = -1e30

#: bytes added to every f32 K and V row pitch in shared memory (kRowPad)
_ROW_PAD = 16

#: bytes the bf16 ring's base is rounded up to (kFa16Align: the 128-byte
#: swizzle's 1,024-byte atoms), budgeted in full
_BF16_ALIGN = 1024


def kv_tile(strategy: Strategy, dtype: torch.dtype = torch.float32) -> int:
    """KV rows a ring slot holds on the card: fa_kc in float32, fa16_kc in
    bfloat16."""
    if dtype == torch.bfloat16:
        return 16 if strategy is Strategy.DROP_OFF else 64
    return 8 if strategy is Strategy.DROP_OFF else 32


def kv_range(q0: int, s: int, bq: int, bk: int, causal: bool,
             window: int, kv_len: Optional[int] = None) -> Tuple[int, int]:
    """The [lo, hi) KV tiles of bk rows the q block at row q0 reads: the
    reference's pruning (flash_attention.py:44-55), then hi cut to the
    tiles that hold a key below ``kv_len`` (None: S), and never below
    lo."""
    hi = min(-(-(q0 + bq) // bk), s // bk) if causal else s // bk
    lo = max((q0 - window + 1) // bk, 0) if window > 0 else 0
    if kv_len is not None:
        hi = max(min(hi, -(-kv_len // bk)), lo)
    return lo, hi


def check_kv_len(kv_len: Optional[int], s: int) -> int:
    """The key count of a call over S rows: ``kv_len``, or S for None;
    outside [1, S] raises ``ValueError``."""
    if kv_len is None:
        return s
    if not 1 <= kv_len <= s:
        raise ValueError(f"kv_len must lie in [1, S = {s}], got {kv_len}")
    return int(kv_len)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          scale: Optional[float] = None, bq: int = 128,
                          bk: int = 128,
                          kv_len: Optional[int] = None) -> torch.Tensor:
    """The kernel's function in plain torch: the reference's online softmax
    over the pruned KV tiles, q block by q block, every head at once, the
    keys at ``kv_len`` and past masked (None: none).
    q (..., H, S, D), k/v (..., KVH, S, D) -> f32 (..., H, S, D)."""
    h, s, d = q.shape[-3:]
    kv_len = check_kv_len(kv_len, s)
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
        lo, hi = kv_range(q0, s, bq, bk, causal, window, kv_len)
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
            if kv_len < s:
                mask &= kvi < kv_len
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
    """Dynamic shared memory of one block (fa_smem, fa16_smem).  float32:
    run_pipeline's ring (no out ring) of a K and a V sub-tile, rows padded
    by 16 bytes, then at the next 16 bytes the f32 q tile with no pad.
    bfloat16: 1,024 bytes to align the ring, the ring of a K and a V
    sub-tile with no pad, then on the next 1,024 bytes the bf16 q tile."""
    kc = kv_tile(spec.strategy, dtype)
    if dtype == torch.bfloat16:
        ring = smem_budget(spec, [2 * kc * d * 2], 0).card
        return _BF16_ALIGN + -(-ring // _BF16_ALIGN) * _BF16_ALIGN + BQ * d * 2
    pitch = d * 4 + _ROW_PAD
    ring = smem_budget(spec, [kc * pitch, kc * pitch], 0).card
    return (ring + 15) // 16 * 16 + BQ * d * 4


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           spec: PipelineSpec, bq: int, bk: int,
           kv_len: Optional[int] = None) -> bool:
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
    check_kv_len(kv_len, s)
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
    the KV sub-tile of ``dtype`` does not divide, a ring past a block's
    shared memory.  Callable on the CPU."""
    if dtype not in CARD_DTYPES:
        raise ValueError(f"the card's flash attention kernel is built for "
                         f"{sorted(map(str, CARD_DTYPES))}, not {dtype}")
    if d not in CARD_D or bq != BQ:
        raise ValueError(f"the card's flash attention takes D in {CARD_D} "
                         f"and bq={BQ}, got D={d} bq={bq}")
    kc = kv_tile(spec.strategy, dtype)
    if bk % kc:
        raise ValueError(f"bk={bk} must divide by the card's KV sub-tile "
                         f"{kc} ({spec.strategy.value}, {dtype})")
    smem = flash_smem(spec, d, dtype)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"{spec} at D={d} in {dtype} needs {smem} bytes of "
                         f"shared memory > {SMEM_PER_BLOCK}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         scale: Optional[float] = None,
                         spec: PipelineSpec = PipelineSpec(), bq: int = 128,
                         bk: int = 128,
                         kv_len: Optional[int] = None) -> torch.Tensor:
    """q (..., H, S, D), k/v (..., KVH, S, D), all f32 or all bf16 on the
    card -> f32 (..., H, S, D), one launch for all leading dims; the keys
    at ``kv_len`` and past masked (None: S).  Invalid shapes, types,
    key counts and configs raise ``ValueError``; a failed build or launch
    raises ``RuntimeError``."""
    global LAUNCHES
    spec = as_spec(spec)
    if not _check(q, k, v, spec, bq, bk, kv_len):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, bq=bq, bk=bk,
                                     kv_len=kv_len)
    h, s, d = q.shape[-3:]
    kv_len = check_kv_len(kv_len, s)
    scale = scale if scale is not None else 1.0 / d ** 0.5
    q, k, v = (_aligned(t) for t in (q, k, v))
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lib = _build.library("flash_attention")
    rc = getattr(lib, CARD_DTYPES[q.dtype])(
        q.device.index or 0, ALL_STRATEGIES.index(spec.strategy), spec.ahead,
        spec.ring_depth, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), q.numel() // (s * d), h, k.shape[-3], s, kv_len,
        d, bk, int(causal), int(window), float(scale),
        flash_smem(spec, d, q.dtype),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, f"flash attention kernel launch ({spec})")
    LAUNCHES += 1
    return out


# -- the backward pass -------------------------------------------------------

def _row_stats(qt, kf, lo, hi, bk, q0, causal, window, kv_len, scale):
    """(m, 1 / l) of each row of the q block ``qt`` over the KV tiles [lo,
    hi), the forward's masking (masked logits NEG_INF), and the masked
    logits of each tile with its mask."""
    rows = torch.arange(qt.shape[-2], device=qt.device)[:, None]
    cols = torch.arange(bk, device=qt.device)[None, :]
    m = torch.full((*qt.shape[:-1], 1), NEG_INF, dtype=qt.dtype,
                   device=qt.device)
    l = torch.zeros_like(m)
    tiles = []
    for t in range(lo, hi):
        kt = kf[..., t * bk:(t + 1) * bk, :]
        qi, kvi = q0 + rows, t * bk + cols
        keep = (kvi < kv_len) & (qi >= 0)               # (bq, bk)
        if causal:
            keep &= kvi <= qi
        if window > 0:
            keep &= kvi > qi - window
        x = (qt @ kt.transpose(-1, -2) * scale).masked_fill(~keep, NEG_INF)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        l = l * torch.exp(m - m_new) + \
            torch.exp(x - m_new).sum(-1, keepdim=True)
        m = m_new
        tiles.append((t, x, keep))
    return m, torch.where(l > 0, 1.0 / l, torch.zeros_like(l)), tiles


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              dout: torch.Tensor, *, causal: bool = True,
                              window: int = 0, scale: Optional[float] = None,
                              bq: int = 128, bk: int = 128,
                              kv_len: Optional[int] = None):
    """The backward kernel's function in plain torch -> (dq, dk, dv) in the
    input's type, computed in f32 (float64 for float64 inputs): Delta =
    rowsum(dout o o); per q block of ``bq`` rows, each row's (m, 1 / l)
    over the forward's KV tiles (``kv_range``), then per tile P = exp(scale
    q k^T - m) / l, dv += P^T dout, dP = dout v^T, dS = P o (dP - Delta)
    (0 where masked), dk += scale dS^T q, dq += scale dS k; dk and dv
    summed over each KV head's group of q heads.  A row whose every key is
    masked weighs its visited keys evenly, as the forward does.
    q, o, dout (..., H, S, D), k/v (..., KVH, S, D)."""
    h, s, d = q.shape[-3:]
    kvh = k.shape[-3]
    kv_len = check_kv_len(kv_len, s)
    scale = scale if scale is not None else 1.0 / d ** 0.5
    ct = torch.promote_types(q.dtype, torch.float32)
    rep = h // kvh
    qf, of, df = (t.to(ct) for t in (q, o, dout))
    kf, vf = (t.to(ct).repeat_interleave(rep, dim=-3) for t in (k, v))
    delta = (df * of).sum(-1, keepdim=True)
    dq, dk, dv = (torch.zeros_like(t) for t in (qf, kf, vf))
    for q0 in range(0, s, bq):
        rows = slice(q0, q0 + bq)
        qt, dt, dl = qf[..., rows, :], df[..., rows, :], delta[..., rows, :]
        lo, hi = kv_range(q0, s, bq, bk, causal, window, kv_len)
        m, rl, tiles = _row_stats(qt, kf, lo, hi, bk, q0, causal, window,
                                  kv_len, scale)
        for t, x, keep in tiles:
            keys = slice(t * bk, (t + 1) * bk)
            p = torch.exp(x - m) * rl
            dp = dt @ vf[..., keys, :].transpose(-1, -2)
            ds = torch.where(keep, p * (dp - dl), torch.zeros_like(p))
            dv[..., keys, :] += p.transpose(-1, -2) @ dt
            dk[..., keys, :] += ds.transpose(-1, -2) @ qt
            dq[..., rows, :] += ds @ kf[..., keys, :]
    dk, dv = (t.unflatten(-3, (kvh, rep)).sum(-3) for t in (dk * scale, dv))
    return (dq * scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             dout: torch.Tensor, *, causal: bool = True,
                             window: int = 0, scale: Optional[float] = None,
                             kv_len: Optional[int] = None):
    """dq, dk, dv of ``flash_attention_cuda(q, k, v)`` = ``o`` for the
    output gradient ``dout``, in the input's type: on the card one call of
    csrc/flash_attention_bwd.cu's three kernels for all leading dims (q, k,
    v all f32 or all bf16 at D in CARD_D, S a multiple of BQ; o and dout
    taken as f32), for CPU tensors ``flash_attention_bwd_plain``.  Invalid
    shapes and types raise ``ValueError``; a failed build or launch raises
    ``RuntimeError``."""
    global BWD_LAUNCHES
    spec = PipelineSpec()
    on_card = _check(q, k, v, spec, BQ, BQ, kv_len)
    if o.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"the backward takes o and dout shaped as q "
                         f"{tuple(q.shape)}, got {tuple(o.shape)}, "
                         f"{tuple(dout.shape)}")
    if not on_card:
        return flash_attention_bwd_plain(q, k, v, o, dout, causal=causal,
                                         window=window, scale=scale,
                                         kv_len=kv_len)
    if o.device != q.device or dout.device != q.device:
        raise ValueError("the backward takes o and dout on q's device")
    h, s, d = q.shape[-3:]
    kv_len = check_kv_len(kv_len, s)
    scale = scale if scale is not None else 1.0 / d ** 0.5
    q, k, v = (_aligned(t) for t in (q, k, v))
    o, dout = (_aligned(t.float()) for t in (o, dout))
    bh = q.numel() // (s * d)
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    # each row's m, 1 / l and Delta; the bf16 design adds dO's two bf16
    # terms (bh s d bf16 each)
    extra = bh * s * d if q.dtype == torch.bfloat16 else 0
    stats = torch.empty(3 * bh * s + extra, dtype=torch.float32,
                        device=q.device)
    lib = _build.library("flash_attention_bwd")
    rc = lib.flash_attention_bwd_launch(
        q.device.index or 0, int(q.dtype == torch.bfloat16), q.data_ptr(),
        k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), bh, h,
        k.shape[-3], s, kv_len, d, int(causal), int(window), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "flash attention backward launch")
    BWD_LAUNCHES += BWD_KERNELS
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention under autograd: ``FlashAttention.apply(q, k, v,
    causal, window, scale, kv_len)`` -> f32 (..., H, S, D).  The forward is
    ``ops.flash_attention`` (the kernel on the card at the configured
    strategy, ``flash_attention_plain`` on the CPU), the backward
    ``flash_attention_bwd_cuda`` (the backward kernel on the card,
    ``flash_attention_bwd_plain`` on the CPU).  The forward's output is kept
    for the backward's Delta."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, kv_len):
        from . import ops
        out = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  scale=scale, kv_len=kv_len)
        ctx.save_for_backward(q, k, v, out)
        ctx.args = dict(causal=causal, window=window, scale=scale,
                        kv_len=kv_len)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, dout, **ctx.args)
        return dq, dk, dv, None, None, None, None
