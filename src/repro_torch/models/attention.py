"""Attention for the model path: projections, the dense and paged KV
caches, and chunked (train / prefill), decode and prefix attention.

The counterpart of ``repro.models.attention``.  ``attend_chunked`` has two
implementations.  ``"chunked"`` is the reference's online-softmax scan over
KV chunks in plain torch, with its bf16 numerics.  ``"flash"`` is the
kernel the reference's docstring names as its fast path: one
``kernels.ops.flash_attention`` launch (the Hopper kernel on CUDA, its plain
version on the CPU) over all batch rows and heads.  Decode, prefix and
paged attention stay plain torch on both devices, as in the reference.

GQA uses the q head -> kv head map ``kv_index_map``, which stays exact
under head padding.  The caches are written in place.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import ArchConfig
from ..kernels import flash_attention as _fa
from ..kernels import ops
from .layers import Linear, linear, linear_init, padded_heads, rope

__all__ = ["NEG", "ATTENTION", "kv_index_map", "Attention", "attn_init",
           "qkv_project",
           "DecodeCache", "init_cache", "update_cache_layer",
           "gather_paged_view", "append_paged_layer", "attend_paged",
           "attend_chunked", "attend_decode", "attend_prefix", "attn_out"]

NEG = -1e30

#: the implementations of attend_chunked
ATTENTION = ("flash", "chunked")


def kv_index_map(n_heads: int, n_kv: int, h_pad: int) -> np.ndarray:
    """q head -> kv head (padded q heads clamp to the last kv head)."""
    group = n_heads // n_kv
    idx = np.minimum(np.arange(h_pad) // group, n_kv - 1)
    return idx.astype(np.int32)


def _grouped(idx_map: np.ndarray, nkv: int) -> bool:
    """Is the map q head h -> kv head h // (H / KV) (no head padding)?"""
    hp = len(idx_map)
    return hp % nkv == 0 and np.array_equal(idx_map,
                                            np.arange(hp) // (hp // nkv))


def _take_heads(x: torch.Tensor, idx_map: np.ndarray) -> torch.Tensor:
    """x (B, W, KV, hd) -> (B, W, len(idx_map), hd): kv head idx_map[h] at
    q head h.  The grouped map repeats heads on the device; any other (head
    padding) gathers by an index sent from the host."""
    if _grouped(idx_map, x.shape[2]):
        return x.repeat_interleave(len(idx_map) // x.shape[2], dim=2)
    return x.index_select(2, torch.as_tensor(idx_map, dtype=torch.long,
                                             device=x.device))


class Attention(nn.ModuleDict):
    """``wq``, ``wk``, ``wv`` (biased with ``cfg.attn.qkv_bias``) and
    ``wo``, in the reference's (d_in, d_out) layout."""

    def __init__(self, cfg: ArchConfig, device=None):
        d, hd, nkv = cfg.d_model, cfg.head_dim_, cfg.n_kv_heads
        hp, bias, dt = padded_heads(cfg), cfg.attn.qkv_bias, cfg.param_dtype
        super().__init__({
            "wq": Linear(d, hp * hd, bias=bias, device=device, dtype=dt),
            "wk": Linear(d, nkv * hd, bias=bias, device=device, dtype=dt),
            "wv": Linear(d, nkv * hd, bias=bias, device=device, dtype=dt),
            "wo": Linear(hp * hd, d, device=device, dtype=dt)})


def attn_init(generator: torch.Generator, cfg: ArchConfig):
    d, hd, nkv = cfg.d_model, cfg.head_dim_, cfg.n_kv_heads
    hp = padded_heads(cfg)
    bias = cfg.attn.qkv_bias
    return {
        "wq": linear_init(generator, d, hp * hd, ("embed", "heads"),
                          bias=bias, dtype=cfg.param_dtype),
        "wk": linear_init(generator, d, nkv * hd, ("embed", "kv"), bias=bias,
                          dtype=cfg.param_dtype),
        "wv": linear_init(generator, d, nkv * hd, ("embed", "kv"), bias=bias,
                          dtype=cfg.param_dtype),
        "wo": linear_init(generator, hp * hd, d, ("heads", "embed"),
                          scale=1.0 / math.sqrt(hp * hd),
                          dtype=cfg.param_dtype),
    }


def qkv_project(p, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
                compute_dtype):
    """x: (B,S,d) -> q (B,S,Hp,hd), k/v (B,S,KV,hd), rope applied."""
    b, s, _ = x.shape
    hd, nkv = cfg.head_dim_, cfg.n_kv_heads
    hp = padded_heads(cfg)
    q = linear(p["wq"], x, compute_dtype).reshape(b, s, hp, hd)
    k = linear(p["wk"], x, compute_dtype).reshape(b, s, nkv, hd)
    v = linear(p["wv"], x, compute_dtype).reshape(b, s, nkv, hd)
    if cfg.attn.rope_theta > 0:
        q = rope(q, positions, cfg.attn.rope_theta)
        k = rope(k, positions, cfg.attn.rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
# Dense KV cache
# ---------------------------------------------------------------------------

class DecodeCache(NamedTuple):
    """Per-layer-stacked KV cache.  ``k``/``v``: (L, B, W, KV, hd); ``pos``:
    (L, B, W) absolute position of each slot (-1 = empty)."""
    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor


def init_cache(cfg: ArchConfig, batch: int, budget: int,
               dtype=torch.bfloat16, n_layers: Optional[int] = None,
               device=None) -> DecodeCache:
    """W is the budget, or the window for sliding-window layers."""
    nkv, hd = cfg.n_kv_heads, cfg.head_dim_
    L = n_layers if n_layers is not None else cfg.n_layers
    w = min(budget, cfg.attn.window) if cfg.attn.window > 0 else budget
    shape = (L, batch, w, nkv, hd)
    return DecodeCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((L, batch, w), -1, dtype=torch.int32, device=device))


def update_cache_layer(k_layer, v_layer, pos_layer, k_new, v_new, positions):
    """Write S new entries at slots positions % W, in place, and return the
    three tensors.  LOCKSTEP, as the reference: every sequence of the batch
    shares its positions, so the S entries land at batch row 0's slots in
    every row (one contiguous run from a scalar start: writes never wrap).
    positions: (B, S) absolute."""
    slots = (positions[0] % k_layer.shape[1]).long()
    k_layer.index_copy_(1, slots, k_new.to(k_layer.dtype))
    v_layer.index_copy_(1, slots, v_new.to(v_layer.dtype))
    pos_layer.index_copy_(1, slots, positions.to(pos_layer.dtype))
    return k_layer, v_layer, pos_layer


# ---------------------------------------------------------------------------
# Paged KV cache (serving): block arena + per-slot block tables.  Block 0 is
# the scratch block that inactive slots write into; table entries < 0
# gather it with their positions forced to -1, so it is never attended.
# ---------------------------------------------------------------------------

def gather_paged_view(k_blocks, v_blocks, pos_blocks, block_table):
    """k/v_blocks: (n_blocks, BL, KV, hd); pos_blocks: (n_blocks, BL);
    block_table: (B, MB) int with -1 marking unused entries.  Returns
    (k, v, pos) shaped (B, MB*BL, KV, hd) / (B, MB*BL); unused entries'
    positions are -1 so ``attend_decode`` masks them."""
    bt = block_table.clamp_min(0).long()
    b, mb = block_table.shape
    bl = pos_blocks.shape[1]
    k, v = k_blocks[bt], v_blocks[bt]                    # (B, MB, BL, KV, hd)
    pos = torch.where((block_table >= 0)[:, :, None], pos_blocks[bt], -1)
    kv, hd = k.shape[-2:]
    return (k.reshape(b, mb * bl, kv, hd), v.reshape(b, mb * bl, kv, hd),
            pos.reshape(b, mb * bl))


def append_paged_layer(k_blocks, v_blocks, k_new, v_new, blk, off):
    """Write each slot's one new KV row into its current block, in place.
    k/v_new: (B, 1, KV, hd); blk/off: (B,) target block id and row within
    it (inactive slots point at the scratch block 0)."""
    blk, off = blk.long(), off.long()
    k_blocks[blk, off] = k_new[:, 0].to(k_blocks.dtype)
    v_blocks[blk, off] = v_new[:, 0].to(v_blocks.dtype)
    return k_blocks, v_blocks


def attend_paged(q, k_blocks, v_blocks, pos_blocks, block_table, idx_map, *,
                 q_position, window: int = 0,
                 scale: Optional[float] = None, global_flag=None):
    """Decode attention over a block arena: gather the slot's block table
    into a dense view, then run the standard masked decode attention."""
    k, v, pos = gather_paged_view(k_blocks, v_blocks, pos_blocks,
                                  block_table)
    return attend_decode(q, k, v, pos, idx_map, q_position=q_position,
                         window=window, scale=scale, global_flag=global_flag)


# ---------------------------------------------------------------------------
# Chunked attention (train / prefill)
# ---------------------------------------------------------------------------

def _scaled(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q * scale with the scale first rounded to q's type, as the reference's
    ``q * jnp.asarray(scale, q.dtype)`` (a bf16 product for bf16 q)."""
    return q * float(torch.tensor(scale).to(q.dtype))


def attend_chunked(q, k, v, idx_map, *, causal: bool, window: int,
                   chunk: int, scale: Optional[float] = None,
                   global_flag=None, impl: str = "chunked"):
    """q: (B,S,Hp,hd); k/v: (B,S,KV,hd) -> (B,S,Hp,hd) in q's type.
    ``impl`` "chunked": the reference's scan over KV chunks of ``chunk``
    rows (the largest divisor of S not above it), carrying (m, l, acc) for
    every query, products at the input type with fp32 sums.  "flash": the
    flash attention kernel (``chunk`` is its own), which takes causal or
    full S % 128 == 0 attention without ``global_flag`` at D in CARD_D on
    the card; other calls raise ``ValueError``."""
    if impl == "flash":
        return _attend_flash(q, k, v, idx_map, causal=causal, window=window,
                             scale=scale, global_flag=global_flag)
    if impl != "chunked":
        raise ValueError(f"attention {impl!r} is not one of {ATTENTION}")
    b, s, hp, hd = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    chunk = min(chunk, s)
    while s % chunk:        # largest divisor of s not exceeding the request
        chunk -= 1
    qf = _scaled(q, scale).float()
    q_pos = torch.arange(s, device=q.device)
    k_rep, v_rep = _take_heads(k, idx_map), _take_heads(v, idx_map)
    m = torch.full((b, hp, s), NEG, device=q.device)
    l = torch.zeros((b, hp, s), device=q.device)
    acc = torch.zeros((b, hp, s, hd), device=q.device)
    for start in range(0, s, chunk):
        k_ch = k_rep[:, start:start + chunk].float()
        v_ch = v_rep[:, start:start + chunk]
        logits = torch.einsum("bqhd,bchd->bhqc", qf, k_ch)   # (B,Hp,S,c)
        kv_pos = start + torch.arange(chunk, device=q.device)
        mask = torch.ones((s, chunk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kv_pos[None, :] <= q_pos[:, None]
        if window > 0:
            wmask = kv_pos[None, :] > q_pos[:, None] - window
            if global_flag is not None:
                wmask = wmask | global_flag
            mask &= wmask
        logits = logits.masked_fill(~mask, NEG)
        m_new = torch.maximum(m, logits.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqc,bchd->bhqd", p.to(v.dtype).float(), v_ch.float())
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)                 # (B,S,Hp,hd)


def _on_card(x: torch.Tensor) -> bool:
    """Does the flash call on ``x`` launch the kernel (and so meet the
    card's contract)?"""
    return x.is_cuda


def _attend_flash(q, k, v, idx_map, *, causal: bool, window: int,
                  scale: Optional[float], global_flag):
    """attend_chunked on the flash kernel: (B, H, S, hd) operands, q head h
    over kv head h // (H / KV) (kv_index_map without head padding; with it,
    kv heads gathered to H), S padded up to a multiple of the kernel's 128
    rows under causal masking (the padded keys follow every real query, so
    the mask hides them) and the result sliced back.  The kernel has no
    backward pass: on the card, a call that autograd would differentiate
    raises."""
    b, s, hp, hd = q.shape
    hint = "; use attention=\"chunked\""
    if global_flag is not None:
        raise ValueError("the flash attention kernel has no per-layer global "
                         "flag" + hint)
    if _on_card(q) and hd not in _fa.CARD_D:
        raise ValueError(f"the card's flash attention takes head dims "
                         f"{_fa.CARD_D}, not {hd}" + hint)
    if _on_card(q) and torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k, v)):
        raise ValueError("the card's flash attention kernel has no backward "
                         "pass; run it under torch.no_grad() or use "
                         "attention=\"chunked\"")
    pad = -s % _fa.BQ
    if pad and not causal:
        raise ValueError(f"non-causal flash attention needs S % {_fa.BQ} == 0,"
                         f" got S = {s}" + hint)
    if not _grouped(idx_map, k.shape[2]):
        k, v = _take_heads(k, idx_map), _take_heads(v, idx_map)
    q, k, v = (F.pad(x.transpose(1, 2), (0, 0, 0, pad)).contiguous()
               for x in (q, k, v))                         # (B, H, S+pad, hd)
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              scale=scale)
    return out[:, :, :s].transpose(1, 2).to(q.dtype)


# ---------------------------------------------------------------------------
# Decode attention (one new token against the cache) and prefix attention
# ---------------------------------------------------------------------------

def _masked_softmax_pv(logits, mask, v_rep, eq):
    """softmax(where(mask, logits, NEG)) in fp32, then P (cast to v's type)
    times v with fp32 sums."""
    p = torch.softmax(logits.masked_fill(~mask, NEG), dim=-1)
    return torch.einsum(eq, p.to(v_rep.dtype).float(), v_rep.float())


def attend_decode(q, k_cache, v_cache, pos_cache, idx_map, *,
                  q_position, window: int = 0,
                  scale: Optional[float] = None, global_flag=None):
    """q: (B,1,Hp,hd); caches: (B,W,KV,hd); pos_cache: (B,W) absolute
    positions (-1 empty).  q_position: (B,) absolute position of the query."""
    hd = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qf = _scaled(q[:, 0], scale)                           # (B,Hp,hd)
    k_rep, v_rep = _take_heads(k_cache, idx_map), _take_heads(v_cache, idx_map)
    logits = torch.einsum("bhd,bwhd->bhw", qf.float(), k_rep.float())
    mask = (pos_cache >= 0) & (pos_cache <= q_position[:, None])
    if window > 0:
        wmask = pos_cache > (q_position[:, None] - window)
        if global_flag is not None:
            wmask = wmask | global_flag
        mask &= wmask
    out = _masked_softmax_pv(logits, mask[:, None, :], v_rep, "bhw,bwhd->bhd")
    return out[:, None].to(q.dtype)                        # (B,1,Hp,hd)


def attend_prefix(q, k_cache, v_cache, pos_cache, idx_map, *,
                  q_positions, window: int = 0,
                  scale: Optional[float] = None, global_flag=None):
    """Prefill-chunk attention: C queries per batch row over a cache view.
    q: (B,C,Hp,hd); caches: (B,W,KV,hd); pos_cache: (B,W); q_positions:
    (B,C).  Row c attends cache rows whose position is in [0,
    q_positions[c]], the chunk's own rows included (written before this
    call).  A full masked softmax per query over the same W however prefill
    was chunked, so each row's output does not depend on the chunking."""
    hd = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qf = _scaled(q, scale)                                 # (B,C,Hp,hd)
    k_rep, v_rep = _take_heads(k_cache, idx_map), _take_heads(v_cache, idx_map)
    logits = torch.einsum("bchd,bwhd->bhcw", qf.float(), k_rep.float())
    mask = (pos_cache[:, None, :] >= 0) \
        & (pos_cache[:, None, :] <= q_positions[:, :, None])  # (B,C,W)
    if window > 0:
        wmask = pos_cache[:, None, :] > (q_positions[:, :, None] - window)
        if global_flag is not None:
            wmask = wmask | global_flag
        mask &= wmask
    out = _masked_softmax_pv(logits, mask[:, None], v_rep,
                             "bhcw,bwhd->bchd")
    return out.to(q.dtype)                                 # (B,C,Hp,hd)


def attn_out(p, attn_heads: torch.Tensor, cfg: ArchConfig, compute_dtype):
    b, s = attn_heads.shape[:2]
    return linear(p["wo"], attn_heads.reshape(b, s, -1), compute_dtype)
