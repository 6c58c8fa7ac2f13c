"""Recurrent and state-space blocks: xLSTM (mLSTM and sLSTM) and Mamba.

The counterpart of ``repro.models.ssm``.  Each block comes in two forms:

  * chunkwise-parallel (train / prefill): a Python loop over chunks of
    the sequence, products inside a chunk (the reference scans them);
  * stepwise (decode): the O(1)-state recurrence for one new token.

mLSTM is the stabilised exponential-gating form of the xLSTM paper
(log-space gate cumulants and a running max ``m``); sLSTM is a time loop
over its cell (the reference scans it with ``unroll=32``; here a Python
loop over S with the same arithmetic); Mamba is the selective SSM with a
scalar decay a channel, its production chunk the Mamba-2 SSD form
(``_mamba_ssd_chunk``) and the associative scan (``_mamba_scan_chunk``)
kept as its plain cross-check, as there.  The causal convolutions are
omitted, as in the reference.

Dtypes as there: the projections in the compute type (``linear``, the
matmul kernel on the card), mLSTM's headwise q, k and v products as one
batched launch over the heads (``layers.expert_product``; under
autograd its backward on the batched kernel's transposed forms), its gate
products ``w_i`` and ``w_f`` in f32 (the f32 kernel on the card), and the
gates, cumulants, carries and states in f32.  On the card the decode
forms' contractions (mLSTM's ``q C`` and ``q n``, the sLSTM recurrence,
Mamba's ``C s``) and the sLSTM recurrence of a prefill sum in float64
(``attention._sums``): cuBLAS picks its batched kernel, and with it a
row's order of f32 sums, by the batch count, and a float64 sum of these
f32 products rounds to the same f32 whatever the order, so a row's bits
do not depend on the batch.  No recurrence runs on a hand-written kernel:
the reference's are ``jnp`` code outside any Pallas kernel.

The ``nn.Module``s (``MLSTM``, ``SLSTM``, ``Mamba``) hold the parameters
under the reference's leaf names, so that weights map by tree path.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from ..core.config import ArchConfig
from ..distributed.sharding import Param
from .attention import _sums
from .layers import (Linear, MixedDict, _empty, expert_product, linear,
                     linear_init)

__all__ = ["NEG", "MLSTMState", "mlstm_init", "mlstm_state_init",
           "mlstm_seq", "mlstm_step", "mlstm_block", "SLSTMState",
           "slstm_init", "slstm_state_init", "slstm_block", "MambaState",
           "mamba_init", "mamba_state_init", "mamba_apply", "MLSTM", "SLSTM",
           "Mamba"]

#: the stabilisers' start and the masked log weights, as the reference's
NEG = -1e30


def _largest_divisor(s: int, chunk: int) -> int:
    """The largest divisor of ``s`` not above ``chunk``."""
    chunk = min(chunk, s)
    while s % chunk:
        chunk -= 1
    return chunk


def _normal(generator: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=generator,
                       device=generator.device) * scale


# ===========================================================================
# mLSTM (matrix memory)
# ===========================================================================

class MLSTMState(NamedTuple):
    c: torch.Tensor      # (B, H, dk, dv) matrix memory
    n: torch.Tensor      # (B, H, dk)     normalizer
    m: torch.Tensor      # (B, H)         stabilizer (log-space running max)


def mlstm_init(generator: torch.Generator, cfg: ArchConfig, d_inner: int,
               n_heads: int):
    """The reference's distributions in its order: w_up and w_z at 1 /
    sqrt(d), the headwise w_q, w_k, w_v (H, dh, dh) at 1 / sqrt(dh), the
    gate products w_i, w_f at 1 / sqrt(d_inner), b_i 0, b_f 3, w_down."""
    d, dh = cfg.d_model, d_inner // n_heads
    si = 1.0 / math.sqrt(d_inner)
    p = {"w_up": linear_init(generator, d, d_inner, ("embed", "heads")),
         "w_z": linear_init(generator, d, d_inner, ("embed", "heads"))}
    for name in ("w_q", "w_k", "w_v"):
        p[name] = Param(_normal(generator, (n_heads, dh, dh),
                                1.0 / math.sqrt(dh)), (None, None, None))
    for name in ("w_i", "w_f"):
        p[name] = Param(_normal(generator, (d_inner, n_heads), si),
                        ("heads", None))
    dev = generator.device
    p["b_i"] = Param(torch.zeros(n_heads, device=dev), (None,))
    p["b_f"] = Param(torch.full((n_heads,), 3.0, device=dev), (None,))
    p["w_down"] = linear_init(generator, d_inner, d, ("heads", "embed"))
    return p


def mlstm_state_init(batch: int, n_heads: int, dh: int,
                     device=None) -> MLSTMState:
    return MLSTMState(
        c=torch.zeros(batch, n_heads, dh, dh, device=device),
        n=torch.zeros(batch, n_heads, dh, device=device),
        m=torch.full((batch, n_heads), NEG, device=device))


def _chunk_terms(q, k, i_raw, f_raw, chunk: int):
    """What the reference's ``_mlstm_chunk`` computes without its carry,
    for every chunk at once (so that the sequential loop keeps only the
    carry's work).  q, k: (B, H, S, dh), k pre-scaled by 1 / sqrt(dh);
    i_raw, f_raw: (B, H, S).  -> per chunk (axis 2 of nc), the cumulated
    log forget gates ``bcum`` (B, H, nc, L), the masked intra-chunk log
    weights ``w`` (B, H, nc, L, L) (W[t, s] = b_t - b_s + a_s for s <= t,
    -1e30 above) and their row max, q k^T ``sc`` (B, H, nc, L, L), the
    decay-to-end log weights ``g`` = b_L - b_s + a_s (B, H, nc, L) and
    their max."""
    b, h, s, dh = q.shape
    nc = s // chunk

    def cut(x):
        return x.reshape(b, h, nc, chunk, *x.shape[3:])
    a = cut(i_raw)
    bcum = torch.cumsum(F.logsigmoid(cut(f_raw)), dim=-1)       # b_t
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=q.device).tril()
    w = (bcum[..., :, None] - bcum[..., None, :] + a[..., None, :]
         ).masked_fill(~tri, NEG)
    sc = cut(q) @ cut(k).transpose(-1, -2)
    g = bcum[..., -1:] - bcum + a
    return bcum, w, w.amax(-1), sc, g, g.amax(-1)


def _mlstm_chunk(carry: MLSTMState, q, k, v, bcum, w, w_max, sc, g, g_max):
    """One chunk given its carry-free terms (``_chunk_terms``, one chunk's
    slice): q, k, v (B, H, L, dh).  -> (new carry, h (B, H, L, dh))."""
    c0, n0, m0 = carry
    db = bcum + m0[..., None]                          # inter decay + carry m
    m_t = torch.maximum(w_max, db)                     # (B,H,L)
    s_mat = sc * torch.exp(w - m_t[..., None])
    inter_w = torch.exp(db - m_t)                      # (B,H,L)
    num = s_mat @ v + inter_w[..., None] * (q @ c0)    # q through carry C
    qn = s_mat.sum(-1) + inter_w * (q @ n0[..., None])[..., 0]
    denom = torch.maximum(qn.abs(), torch.exp(-m_t))
    h_out = num / denom[..., None]                     # (B,H,L,dh)
    # the carry
    b_L = bcum[..., -1]                                # (B,H)
    m_new = torch.maximum(m0 + b_L, g_max)
    gw = torch.exp(g - m_new[..., None])
    decay = torch.exp(m0 + b_L - m_new)
    c_new = decay[..., None, None] * c0 + (gw[..., None] * k).transpose(
        -1, -2) @ v
    n_new = decay[..., None] * n0 + (gw[..., None, :] @ k)[..., 0, :]
    return MLSTMState(c_new, n_new, m_new), h_out


def mlstm_seq(q, k, v, i_raw, f_raw, state: MLSTMState, chunk: int):
    """q, k, v: (B, S, H, dh) f32; gates (B, S, H).  Chunks of the largest
    divisor of S not above ``chunk``, run in order from ``state``.  ->
    (h (B, S, H, dh), new state)."""
    b, s, h, dh = q.shape
    chunk = _largest_divisor(s, chunk)
    # (B, S, H, ...) -> (B, H, S, ...), cut into chunks along S
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    terms = _chunk_terms(qt, kt, i_raw.transpose(1, 2),
                         f_raw.transpose(1, 2), chunk)
    split = [x.reshape(b, h, s // chunk, chunk, dh).unbind(2)
             for x in (qt, kt, vt)]
    outs = []
    for per in zip(*split, *(t.unbind(2) for t in terms)):
        state, h_c = _mlstm_chunk(state, *per)
        outs.append(h_c)
    return torch.cat(outs, dim=2).transpose(1, 2), state


def mlstm_step(q, k, v, i_raw, f_raw, state: MLSTMState):
    """One token: q, k, v (B, H, dh), k pre-scaled; gates (B, H).  On the
    card ``q C`` and ``q n`` sum in float64 (the module docstring)."""
    c0, n0, m0 = state
    exact = q.is_cuda
    lf = F.logsigmoid(f_raw)
    m_new = torch.maximum(lf + m0, i_raw)
    fw = torch.exp(lf + m0 - m_new)[..., None]
    iw = torch.exp(i_raw - m_new)[..., None]
    c = fw[..., None] * c0 + iw[..., None] * (k[..., :, None] * v[..., None, :])
    n = fw * n0 + iw * k
    num = torch.einsum("bhd,bhde->bhe", _sums(q, exact), _sums(c, exact))
    qn = torch.einsum("bhd,bhd->bh", _sums(q, exact), _sums(n, exact))
    denom = torch.maximum(qn.float().abs(), torch.exp(-m_new))
    return num.float() / denom[..., None], MLSTMState(c, n, m_new)


def _headwise(up_h: torch.Tensor, w: torch.Tensor, compute_dtype):
    """up_h (B, S, H, dh) through the block-diagonal w (H, dh, dh), the
    reference's ``einsum("bshd,hde->bshe")`` in the compute type: one
    product a head, all in one batched launch on the card."""
    b, s, h, dh = up_h.shape
    a = up_h.permute(2, 0, 1, 3).reshape(h, b * s, dh)
    out = expert_product(a, w, compute_dtype)              # (H, B S, dh)
    return out.reshape(h, b, s, -1).permute(1, 2, 0, 3)


def mlstm_block(p, x, cfg: ArchConfig, state: MLSTMState, *, mode: str,
                n_heads: int, compute_dtype=torch.bfloat16):
    """Up-projection, heads, the cell, the gated down-projection.
    x: (B, S, d); in decode mode S == 1.  -> (out (B, S, d), new state)."""
    b, s, d = x.shape
    up = linear(p["w_up"], x, compute_dtype)
    z = linear(p["w_z"], x, compute_dtype)
    d_inner = up.shape[-1]
    dh = d_inner // n_heads
    up_h = up.reshape(b, s, n_heads, dh)
    q = _headwise(up_h, p["w_q"], compute_dtype).float()
    k = _headwise(up_h, p["w_k"], compute_dtype).float() / math.sqrt(dh)
    v = _headwise(up_h, p["w_v"], compute_dtype).float()
    upf = up.float()
    i_raw = linear({"w": p["w_i"]}, upf, torch.float32) + p["b_i"]
    f_raw = linear({"w": p["w_f"]}, upf, torch.float32) + p["b_f"]
    if mode == "decode":
        h, state = mlstm_step(q[:, 0], k[:, 0], v[:, 0], i_raw[:, 0],
                              f_raw[:, 0], state)
        h = h[:, None]
    else:
        h, state = mlstm_seq(q, k, v, i_raw, f_raw, state, cfg.ssm.chunk)
    h = h.reshape(b, s, d_inner).to(compute_dtype) * F.silu(z)
    return linear(p["w_down"], h, compute_dtype), state


class MLSTM(MixedDict):
    """``w_up``, ``w_z``, ``w_down`` (Linear) and ``w_q``, ``w_k``, ``w_v``
    (H, dh, dh), ``w_i``, ``w_f`` (d_inner, H), ``b_i``, ``b_f`` (H,)."""

    def __init__(self, cfg: ArchConfig, d_inner: int, n_heads: int,
                 device=None):
        d, dh = cfg.d_model, d_inner // n_heads
        super().__init__({"w_up": Linear(d, d_inner, device=device),
                          "w_z": Linear(d, d_inner, device=device),
                          "w_down": Linear(d_inner, d, device=device)})
        for name in ("w_q", "w_k", "w_v"):
            setattr(self, name, _empty(n_heads, dh, dh, device=device))
        for name in ("w_i", "w_f"):
            setattr(self, name, _empty(d_inner, n_heads, device=device))
        for name in ("b_i", "b_f"):
            setattr(self, name, _empty(n_heads, device=device))


# ===========================================================================
# sLSTM (scalar memory, exponential gating, block-diagonal recurrence)
# ===========================================================================

class SLSTMState(NamedTuple):
    c: torch.Tensor     # (B, H, dh)
    n: torch.Tensor     # (B, H, dh)
    m: torch.Tensor     # (B, H, dh)
    h: torch.Tensor     # (B, H, dh)


def slstm_init(generator: torch.Generator, cfg: ArchConfig, n_heads: int):
    """w_x (d, 4d), the recurrence r (4, H, dh, dh) at 1 / sqrt(dh), the
    bias b (zeros, the forget gate's quarter at 3), w_up (d, 2d), w_down."""
    d = cfg.d_model
    dh = d // n_heads
    dev = generator.device
    return {
        "w_x": linear_init(generator, d, 4 * d, ("embed", "heads")),
        "r": Param(_normal(generator, (4, n_heads, dh, dh),
                           1.0 / math.sqrt(dh)),
                   (None, "heads", None, None)),
        "b": Param(torch.cat([torch.zeros(2 * d, device=dev),
                              torch.full((d,), 3.0, device=dev),
                              torch.zeros(d, device=dev)]), ("heads",)),
        "w_up": linear_init(generator, d, 2 * d, ("embed", "mlp")),
        "w_down": linear_init(generator, d, d, ("mlp", "embed")),
    }


def slstm_state_init(batch: int, n_heads: int, dh: int,
                     device=None) -> SLSTMState:
    z = torch.zeros(batch, n_heads, dh, device=device)
    return SLSTMState(z, z.clone(), torch.full_like(z, NEG), z.clone())


def _slstm_cell(state: SLSTMState, xw, r, exact: bool):
    """xw: (B, 4, H, dh) pre-activations from the input; r: (4, H, dh, dh)
    (float64 with ``exact``, the recurrence's sums then float64)."""
    c0, n0, m0, h0 = state
    rec = torch.einsum("bhd,ghde->bghe", _sums(h0, exact), r).float()
    zi, ii, fi, oi = (xw + rec).unbind(1)
    m_new = torch.maximum(fi + m0, ii)
    fw = torch.exp(fi + m0 - m_new)
    iw = torch.exp(ii - m_new)
    c = fw * c0 + iw * torch.tanh(zi)
    n = fw * n0 + iw
    h = torch.sigmoid(oi) * c / n.clamp_min(1e-6)
    return SLSTMState(c, n, m_new, h)


def slstm_block(p, x, cfg: ArchConfig, state: SLSTMState, *, mode: str,
                n_heads: int, compute_dtype=torch.bfloat16):
    """x: (B, S, d) -> (out (B, S, d), new state): the cell over the
    sequence, one step at a time, then the post-cell GEGLU feed-forward."""
    b, s, d = x.shape
    dh = d // n_heads
    exact = x.is_cuda
    xw = (linear(p["w_x"], x, compute_dtype).float()
          + p["b"]).reshape(b, s, 4, n_heads, dh)
    r = _sums(p["r"], exact)
    hs = []
    for t in range(s):
        state = _slstm_cell(state, xw[:, t], r, exact)
        hs.append(state.h)
    hs = torch.stack(hs, 1).reshape(b, s, d).to(compute_dtype)
    u1, u2 = linear(p["w_up"], hs, compute_dtype).chunk(2, dim=-1)
    out = linear(p["w_down"], F.gelu(u1, approximate="tanh") * u2,
                 compute_dtype)
    return out, state


class SLSTM(MixedDict):
    """``w_x``, ``w_up``, ``w_down`` (Linear), ``r`` (4, H, dh, dh) and
    ``b`` (4d,)."""

    def __init__(self, cfg: ArchConfig, n_heads: int, device=None):
        d = cfg.d_model
        super().__init__({"w_x": Linear(d, 4 * d, device=device),
                          "w_up": Linear(d, 2 * d, device=device),
                          "w_down": Linear(d, d, device=device)})
        self.r = _empty(4, n_heads, d // n_heads, d // n_heads,
                        device=device)
        self.b = _empty(4 * d, device=device)


# ===========================================================================
# Mamba (selective SSM), hymba's parallel head
# ===========================================================================

class MambaState(NamedTuple):
    s: torch.Tensor     # (B, d_inner, N)


def _dt_rank(cfg: ArchConfig) -> int:
    return max(cfg.d_model // 16, 8)


def mamba_init(generator: torch.Generator, cfg: ArchConfig, d_inner: int):
    """w_in, w_z (d, d_inner), w_bc (d, 2N), w_dt1 (d, dt_rank), w_dt2,
    dt_bias the inverse softplus of a log-uniform draw on [1e-3, 1e-1]
    (clipped to [1e-4, 1e-1]), a_log log(linspace(1, N, d_inner)), d_skip
    ones, w_out."""
    d, n, r = cfg.d_model, cfg.ssm.d_state, _dt_rank(cfg)
    dev = generator.device
    p = {"w_in": linear_init(generator, d, d_inner, ("embed", "heads")),
         "w_z": linear_init(generator, d, d_inner, ("embed", "heads")),
         "w_bc": linear_init(generator, d, 2 * n, ("embed", None)),
         "w_dt1": linear_init(generator, d, r, ("embed", None)),
         "w_dt2": linear_init(generator, r, d_inner, (None, "heads"))}
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand(d_inner, generator=generator, device=dev) * (hi - lo) + lo
    dt = torch.exp(u).clamp(1e-4, 1e-1)
    p["dt_bias"] = Param(torch.log(torch.expm1(dt)), ("heads",))
    # Mamba-2 style scalar decay a channel (the SSD chunk form)
    p["a_log"] = Param(torch.log(torch.linspace(1.0, float(n), d_inner,
                                                device=dev)), ("heads",))
    p["d_skip"] = Param(torch.ones(d_inner, device=dev), ("heads",))
    p["w_out"] = linear_init(generator, d_inner, d, ("heads", "embed"))
    return p


def mamba_state_init(batch: int, d_inner: int, n: int,
                     device=None) -> MambaState:
    return MambaState(torch.zeros(batch, d_inner, n, device=device))


def _mamba_scan_chunk(carry, a_bar, bx):
    """The associative scan inside a chunk, the SSD chunk's plain
    cross-check: a_bar, bx (B, L, D, N), every step's state materialised at
    every level of the ladder (log2 L levels of the combine (a1, b1) then
    (a2, b2) -> (a1 a2, a2 b1 + b2), each element with the one ``step``
    before it).  -> (new carry (B, D, N), every state (B, L, D, N))."""
    a_cum, b_cum = a_bar, bx
    step = 1
    while step < a_bar.shape[1]:
        a_cum, b_cum = (
            torch.cat([a_cum[:, :step], a_cum[:, step:] * a_cum[:, :-step]], 1),
            torch.cat([b_cum[:, :step],
                       a_cum[:, step:] * b_cum[:, :-step] + b_cum[:, step:]],
                      1))
        step *= 2
    s = b_cum + a_cum * carry[:, None]                 # (B,L,D,N)
    return s[:, -1], s


def _mamba_ssd_chunk(carry, la, du, b_t, c_t):
    """Mamba-2 SSD chunk: y through the (L, L) segment-sum decay matrix,
    with no step's state materialised.  la: (B, L, D) log-decay; du:
    (B, L, D) dt * u; b_t, c_t: (B, L, N); carry: (B, D, N).
    -> (new carry, y (B, L, D))."""
    cum = torch.cumsum(la, dim=1)                      # (B,L,D) inclusive
    # segment decay M[t,s] = exp(cum_t - cum_s) for s <= t (log args <= 0)
    diff = cum[:, :, None, :] - cum[:, None, :, :]     # (B,T,S,D)
    L = la.shape[1]
    tri = torch.ones(L, L, dtype=torch.bool, device=la.device).tril()
    m = torch.where(tri[None, :, :, None], torch.exp(diff), 0.0)
    cb = torch.einsum("btn,bsn->bts", c_t, b_t)        # (B,T,S)
    y = torch.einsum("btsd,bsd->btd", m * cb[..., None], du)
    # inter-chunk: y += C_t . (exp(cum_t) * s0)
    y = y + torch.einsum("btn,bdn->btd", c_t, carry) * torch.exp(cum)
    # the carry: sum_s exp(cum_L - cum_s) du_s B_s + exp(cum_L) s0
    w_end = torch.exp(cum[:, -1:, :] - cum)            # (B,L,D)
    s_new = torch.einsum("bld,bln->bdn", w_end * du, b_t) \
        + torch.exp(cum[:, -1])[..., None] * carry
    return s_new, y


def mamba_apply(p, x, cfg: ArchConfig, state: MambaState, *, mode: str,
                compute_dtype=torch.bfloat16):
    """x: (B, S, d) -> ((B, S, d), new state).  On the card the decode
    step's ``C s`` sums in float64 (the module docstring)."""
    b, s, d = x.shape
    u = linear(p["w_in"], x, compute_dtype).float()    # (B,S,D)
    z = linear(p["w_z"], x, compute_dtype)
    bc = linear(p["w_bc"], x, compute_dtype).float()
    b_t, c_t = bc.chunk(2, dim=-1)                     # (B,S,N)
    dt = F.softplus(
        linear(p["w_dt2"], linear(p["w_dt1"], x, compute_dtype),
               compute_dtype).float() + p["dt_bias"])  # (B,S,D)
    a = -torch.exp(p["a_log"])                         # (D,) scalar decay
    la = dt * a                                        # (B,S,D) log decay
    du = dt * u                                        # (B,S,D)
    if mode == "decode":
        exact = x.is_cuda
        a_bar = torch.exp(la[:, 0])                    # (B,D)
        new_s = a_bar[..., None] * state.s \
            + du[:, 0][..., None] * b_t[:, 0][:, None, :]
        y = torch.einsum("bdn,bn->bd", _sums(new_s, exact),
                         _sums(c_t[:, 0], exact)).float()[:, None]
        carry = new_s
    else:
        chunk = _largest_divisor(s, cfg.ssm.chunk)
        carry, ys = state.s, []
        for lo in range(0, s, chunk):
            sl = slice(lo, lo + chunk)
            carry, y_c = _mamba_ssd_chunk(carry, la[:, sl], du[:, sl],
                                          b_t[:, sl], c_t[:, sl])
            ys.append(y_c)
        y = torch.cat(ys, dim=1)
    y = y + p["d_skip"] * u
    y = y.to(compute_dtype) * F.silu(z)
    return linear(p["w_out"], y, compute_dtype), MambaState(carry)


class Mamba(MixedDict):
    """``w_in``, ``w_z``, ``w_bc``, ``w_dt1``, ``w_dt2``, ``w_out``
    (Linear) and ``dt_bias``, ``a_log``, ``d_skip`` (d_inner,)."""

    def __init__(self, cfg: ArchConfig, d_inner: int, device=None):
        d, n, r = cfg.d_model, cfg.ssm.d_state, _dt_rank(cfg)
        super().__init__({"w_in": Linear(d, d_inner, device=device),
                          "w_z": Linear(d, d_inner, device=device),
                          "w_bc": Linear(d, 2 * n, device=device),
                          "w_dt1": Linear(d, r, device=device),
                          "w_dt2": Linear(r, d_inner, device=device),
                          "w_out": Linear(d_inner, d, device=device)})
        for name in ("dt_bias", "a_log", "d_skip"):
            setattr(self, name, _empty(d_inner, device=device))
