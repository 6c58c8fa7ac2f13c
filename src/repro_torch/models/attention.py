"""Attention for the model path: projections, the dense and paged KV
caches, and chunked (train / prefill), decode and prefix attention.

The counterpart of ``repro.models.attention``.  ``attend_chunked`` has two
implementations.  ``"chunked"`` is the reference's online-softmax scan over
KV chunks in plain torch, with its bf16 numerics.  ``"flash"`` is the
kernel the reference's docstring names as its fast path: one
``kernels.ops.flash_attention`` launch (the Hopper kernel on CUDA, its plain
version on the CPU) over all batch rows and heads, the head dim zero-padded
on the card up to one the kernel takes, under autograd through
``kernels.flash_attention.FlashAttention`` (its backward kernel on CUDA).
Decode, prefix and
paged attention stay plain torch on both devices, as in the reference; on
the card ``attend_decode``'s two products run in float64 (``_sums``), so
that a slot's row does not depend on how many slots share the step.

GQA uses the q head -> kv head map ``kv_index_map``, which stays exact
under head padding.  The caches are written in place.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import ArchConfig
from ..kernels import flash_attention as _fa
from .layers import Linear, linear, linear_init, padded_heads, rope

__all__ = ["NEG", "ATTENTION", "kv_index_map", "Attention",
           "attn_init", "qkv_project",
           "DecodeCache", "init_cache", "update_cache_layer",
           "paged_positions", "gather_blocks", "gather_paged_view",
           "append_paged_layer", "attend_paged",
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


def qkv_project(p, x: torch.Tensor, cfg: ArchConfig, rope_tables,
                compute_dtype):
    """x: (B,S,d) -> q (B,S,Hp,hd), k/v (B,S,KV,hd), rotated by
    ``rope_tables`` (``layers.rope_tables`` of the positions; None without
    rope)."""
    b, s, _ = x.shape
    hd, nkv = cfg.head_dim_, cfg.n_kv_heads
    hp = padded_heads(cfg)
    q = linear(p["wq"], x, compute_dtype).reshape(b, s, hp, hd)
    k = linear(p["wk"], x, compute_dtype).reshape(b, s, nkv, hd)
    v = linear(p["wv"], x, compute_dtype).reshape(b, s, nkv, hd)
    if rope_tables is not None:
        q, k = rope(q, rope_tables), rope(k, rope_tables)
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

def paged_positions(pos_blocks, block_table):
    """(bt, pos): the table's block ids clamped to the scratch block 0, as
    int64, and the gathered positions (B, MB*BL), -1 at unused entries.
    One position plane serves every layer, so a forward gathers it once."""
    bt = block_table.clamp_min(0).long()
    pos = torch.where((block_table >= 0)[:, :, None], pos_blocks[bt], -1)
    return bt, pos.reshape(bt.shape[0], -1)


def gather_blocks(blocks, bt):
    """blocks (n_blocks, BL, KV, hd) gathered by ``bt`` (B, MB) into the
    dense view (B, MB*BL, KV, hd)."""
    return blocks[bt].flatten(1, 2)


def gather_paged_view(k_blocks, v_blocks, pos_blocks, block_table):
    """k/v_blocks: (n_blocks, BL, KV, hd); pos_blocks: (n_blocks, BL);
    block_table: (B, MB) int with -1 marking unused entries.  Returns
    (k, v, pos) shaped (B, MB*BL, KV, hd) / (B, MB*BL); unused entries'
    positions are -1 so ``attend_decode`` masks them."""
    bt, pos = paged_positions(pos_blocks, block_table)
    return gather_blocks(k_blocks, bt), gather_blocks(v_blocks, bt), pos


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

@functools.lru_cache(maxsize=None)
def _rounded(scale: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(scale).to(dtype))


def _scaled(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q * scale with the scale first rounded to q's type, as the reference's
    ``q * jnp.asarray(scale, q.dtype)`` (a bf16 product for bf16 q)."""
    return q * _rounded(float(scale), q.dtype)


def attend_chunked(q, k, v, idx_map, *, causal: bool, window: int,
                   chunk: int, scale: Optional[float] = None,
                   global_flag=None, impl: str = "chunked"):
    """q: (B,S,Hp,hd); k/v: (B,S,KV,hd) -> (B,S,Hp,hd) in q's type.
    ``impl`` "chunked": the reference's scan over KV chunks of ``chunk``
    rows (the largest divisor of S not above it), carrying (m, l, acc) for
    every query, products at the input type with fp32 sums.  "flash": the
    flash attention kernel (``chunk`` is its own), which takes causal or
    full attention at any S without ``global_flag`` (S padded up to its
    128-row blocks, the padded keys masked by its key count), on the card
    at D up to the largest of CARD_D; other calls raise ``ValueError``."""
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
    kv heads gathered to H), S zero-padded up to a multiple of the kernel's
    128 rows with the key count ``kv_len`` = S, so that no query attends a
    padded key, causal or not, and the result sliced back to the S real
    rows.  On the card hd is
    zero-padded up to the least head dim of ``CARD_D`` that holds it, at
    the scale of the true hd: zero columns add exact zeros to Q K^T, and
    v's zero columns are sliced off.  The call runs under autograd as
    ``FlashAttention`` (the backward kernel on the card, its plain version
    on the CPU); the padding and slicing around it differentiate as they
    are (the padded rows and columns get no gradient)."""
    b, s, hp, hd = q.shape
    hint = "; use attention=\"chunked\""
    if global_flag is not None:
        raise ValueError("the flash attention kernel has no per-layer global "
                         "flag" + hint)
    dp = hd
    if _on_card(q):
        dp = next((d for d in _fa.CARD_D if d >= hd), None)
        if dp is None:
            raise ValueError(f"the card's flash attention takes head dims up "
                             f"to {max(_fa.CARD_D)}, not {hd}" + hint)
    pad = -s % _fa.BQ
    if not _grouped(idx_map, k.shape[2]):
        k, v = _take_heads(k, idx_map), _take_heads(v, idx_map)
    scale = scale if scale is not None else 1.0 / hd ** 0.5   # the kernel's
    dtype = q.dtype
    q, k, v = (F.pad(x.transpose(1, 2), (0, dp - hd, 0, pad)).contiguous()
               for x in (q, k, v))                         # (B, H, S+pad, dp)
    out = _fa.FlashAttention.apply(q, k, v, causal, window, scale, s)
    return out[:, :, :s, :hd].transpose(1, 2).to(dtype)


# ---------------------------------------------------------------------------
# Decode attention (one new token against the cache) and prefix attention
# ---------------------------------------------------------------------------

def _sums(x: torch.Tensor, exact: bool) -> torch.Tensor:
    """An einsum operand: f32, or float64 with ``exact``.  cuBLAS picks its
    batched kernel, and with it the order of a row's f32 sums, by the batch
    count: at B = 4 a decode row's logits differ from B = 1's by up to
    7.15e-7 (chip_smoke.py phase 7, layer 0 of qwen2-1.5b, on an NVIDIA
    H100 80GB HBM3 at 700 W).  The operands here are bf16 values (and P
    cast to v's type), whose products are exact in float64 and whose
    float64 sums are exact or within 2^-53 of it whatever their order, so
    the result rounded to f32 does not depend on the order (except at a
    tie after both roundings)."""
    return x.double() if exact else x.float()


def _masked_softmax_pv(logits, mask, v_rep, eq, exact: bool = False):
    """softmax(where(mask, logits, NEG)) in fp32, then P (cast to v's type)
    times v with fp32 sums (``exact``: float64 sums, rounded to f32)."""
    p = torch.softmax(logits.masked_fill(~mask, NEG), dim=-1)
    return torch.einsum(eq, _sums(p.to(v_rep.dtype), exact),
                        _sums(v_rep, exact)).float()


def attend_decode(q, k_cache, v_cache, pos_cache, idx_map, *,
                  q_position, window: int = 0,
                  scale: Optional[float] = None, global_flag=None):
    """q: (B,1,Hp,hd); caches: (B,W,KV,hd); pos_cache: (B,W) absolute
    positions (-1 empty).  q_position: (B,) absolute position of the query.
    On the card both products sum in float64 (``_sums``): a row's result
    does not depend on B."""
    hd = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    exact = q.is_cuda
    qf = _scaled(q[:, 0], scale)                           # (B,Hp,hd)
    k_rep, v_rep = _take_heads(k_cache, idx_map), _take_heads(v_cache, idx_map)
    logits = torch.einsum("bhd,bwhd->bhw", _sums(qf, exact),
                          _sums(k_rep, exact)).float()
    mask = (pos_cache >= 0) & (pos_cache <= q_position[:, None])
    if window > 0:
        wmask = pos_cache > (q_position[:, None] - window)
        if global_flag is not None:
            wmask = wmask | global_flag
        mask &= wmask
    out = _masked_softmax_pv(logits, mask[:, None, :], v_rep, "bhw,bwhd->bhd",
                             exact)
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
