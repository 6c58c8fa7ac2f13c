"""Encoder-decoder (whisper-medium backbone).

The counterpart of ``repro.models.encdec``.  The audio conv frontend is a
stub, as there: the batch supplies precomputed frame embeddings (B, T, d).
Encoder layers are bidirectional self-attention and a GELU MLP with
layernorm; decoder layers add causal self-attention (KV-cached at decode)
and cross-attention to the encoder output, whose K and V are made once at
prefill and carried in the state: a decode step reads them from there.
Positions are sinusoidal.  The reference scans stacked layers; here each
layer is a module in an ``nn.ModuleList`` and a Python loop runs them.

Prefill and forward attend through ``attend_chunked`` (the flash kernel by
default: the encoder and the cross-attention non-causal, the decoder's
self-attention causal); decode through ``attend_decode``, the
cross-attention at the reference's query position 2**30 over the frames'
positions 0 .. T_enc - 1.  As in the reference, prefill and forward need
as many frames as tokens (its ``attend_chunked`` cuts K into chunks of the
queries' length); any other length raises ``ValueError``.  The self-attention
cache is written in place.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ..core.config import ArchConfig
from . import attention as attn
from . import transformer as tfm
from .layers import (MLP, Embed, Linear, Norm, embed_init, linear,
                     linear_init, mlp_init, norm_init, padded_heads,
                     padded_vocab)

__all__ = ["EncDecState", "EncoderLayer", "DecoderLayer", "EncDec",
           "LAYER_LISTS", "init_pieces", "check_lengths", "encode",
           "decoder", "encdec_state_init"]


class EncDecState(NamedTuple):
    """``k``/``v`` (L, B, W, KV, hd) the decoder's self-attention cache,
    ``kpos`` (L, B, W) each slot's absolute position (-1 empty), ``xk``/
    ``xv`` (L, B, T_enc, KV, hd) the cross-attention's keys and values,
    ``pos`` (B,) the next absolute position."""
    k: torch.Tensor
    v: torch.Tensor
    kpos: torch.Tensor
    xk: torch.Tensor
    xv: torch.Tensor
    pos: torch.Tensor


class EncoderLayer(nn.ModuleDict):
    """``ln_attn``, ``attn``, ``ln_mlp`` and ``mlp``."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__({"ln_attn": Norm(cfg.d_model, cfg.norm, device),
                          "attn": attn.Attention(cfg, device),
                          "ln_mlp": Norm(cfg.d_model, cfg.norm, device),
                          "mlp": MLP(cfg, device=device)})


class DecoderLayer(nn.ModuleDict):
    """``ln_self``, ``self`` (causal self-attention), ``ln_cross``,
    ``cross`` (attention to the encoder output), ``ln_mlp`` and ``mlp``."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__({"ln_self": Norm(cfg.d_model, cfg.norm, device),
                          "self": attn.Attention(cfg, device),
                          "ln_cross": Norm(cfg.d_model, cfg.norm, device),
                          "cross": attn.Attention(cfg, device),
                          "ln_mlp": Norm(cfg.d_model, cfg.norm, device),
                          "mlp": MLP(cfg, device=device)})


class EncDec(nn.ModuleDict):
    """``embed``, ``enc_layers``, ``dec_layers``, ``ln_enc``, ``ln_f`` and
    ``unembed``: the reference's parameter tree, its stacks lists."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__({
            "embed": Embed(padded_vocab(cfg), cfg.d_model, device),
            "enc_layers": nn.ModuleList(EncoderLayer(cfg, device)
                                        for _ in range(cfg.n_enc_layers)),
            "dec_layers": nn.ModuleList(DecoderLayer(cfg, device)
                                        for _ in range(cfg.n_layers)),
            "ln_enc": Norm(cfg.d_model, cfg.norm, device),
            "ln_f": Norm(cfg.d_model, cfg.norm, device),
            "unembed": Linear(cfg.d_model, padded_vocab(cfg), device=device)})
        self.cfg = cfg


#: the children that are lists of layers
LAYER_LISTS = ("enc_layers", "dec_layers")


def init_pieces(generator: torch.Generator, cfg: ArchConfig):
    """The Param trees of an EncDec's children in the reference's draw
    order (``encdec_init``), one at a time: ("embed", tree), ("enc_layers",
    tree) once an encoder layer (attn, then mlp), ("dec_layers", tree) once
    a decoder layer (self, cross, then mlp), ("ln_enc", tree), ("ln_f",
    tree), ("unembed", tree), on ``generator``'s device."""
    dev, d = generator.device, cfg.d_model
    yield "embed", embed_init(generator, padded_vocab(cfg), d)
    for _ in range(cfg.n_enc_layers):
        yield "enc_layers", {"ln_attn": norm_init(d, cfg.norm, dev),
                             "attn": attn.attn_init(generator, cfg),
                             "ln_mlp": norm_init(d, cfg.norm, dev),
                             "mlp": mlp_init(generator, cfg)}
    for _ in range(cfg.n_layers):
        yield "dec_layers", {"ln_self": norm_init(d, cfg.norm, dev),
                             "self": attn.attn_init(generator, cfg),
                             "ln_cross": norm_init(d, cfg.norm, dev),
                             "cross": attn.attn_init(generator, cfg),
                             "ln_mlp": norm_init(d, cfg.norm, dev),
                             "mlp": mlp_init(generator, cfg)}
    yield "ln_enc", norm_init(d, cfg.norm, dev)
    yield "ln_f", norm_init(d, cfg.norm, dev)
    yield "unembed", linear_init(generator, d, padded_vocab(cfg),
                                 ("embed", "vocab"))


def _idx(cfg: ArchConfig):
    return attn.kv_index_map(cfg.n_heads, cfg.n_kv_heads, padded_heads(cfg))


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def check_lengths(frames: torch.Tensor, tokens: torch.Tensor) -> None:
    """Prefill and forward take as many frames as tokens (the reference's
    cross-attention cuts K into chunks of the queries' length)."""
    if frames.shape[1] != tokens.shape[1]:
        raise ValueError(
            f"encdec prefill and forward take as many frames as tokens, got "
            f"{frames.shape[1]} frames for {tokens.shape[1]} tokens")


def encode(net: EncDec, frames: torch.Tensor,
           attention: str = "flash") -> torch.Tensor:
    """frames: (B, T, d) stub embeddings -> (B, T, d) in the compute type:
    the sinusoid added, every encoder layer (non-causal self-attention
    through ``attend_chunked``), then ``ln_enc``."""
    cfg = net.cfg
    cdt = tfm._cdt(cfg)
    b, t, _ = frames.shape
    positions = _positions(b, t, frames.device)
    x = frames.to(cdt) + tfm.sinusoid(positions, cfg.d_model).to(cdt)
    tables, idx = tfm._rope(cfg, positions), _idx(cfg)
    for layer in net["enc_layers"]:
        q, k, v = attn.qkv_project(layer["attn"], layer["ln_attn"](x), cfg,
                                   tables, cdt)
        o = attn.attend_chunked(q, k, v, idx, causal=False, window=0,
                                chunk=cfg.attn.chunk, impl=attention)
        x = x + attn.attn_out(layer["attn"], o, cfg, cdt)
        x = x + layer["mlp"](layer["ln_mlp"](x), cdt)
    return net["ln_enc"](x)


def encdec_state_init(cfg: ArchConfig, batch: int, budget: int, t_enc: int,
                      dtype=torch.bfloat16, device=None) -> EncDecState:
    """A fresh decode state: ``budget`` self-attention slots a layer and
    ``t_enc`` cross-attention rows, all zero (positions -1)."""
    L, nkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim_

    def z(w):
        return torch.zeros((L, batch, w, nkv, hd), dtype=dtype, device=device)
    return EncDecState(
        k=z(budget), v=z(budget),
        kpos=torch.full((L, batch, budget), -1, dtype=torch.int32,
                        device=device),
        xk=z(t_enc), xv=z(t_enc),
        pos=torch.zeros(batch, dtype=torch.int32, device=device))


def decoder(net: EncDec, tokens: torch.Tensor,
            enc_out: Optional[torch.Tensor], *, mode: str,
            state: Optional[EncDecState] = None,
            budget: Optional[int] = None,
            attention: str = "flash"):
    """The reference's ``_decoder`` up to the final norm: -> (hidden (B, S,
    d), the new state; None in train).  train: no cache; prefill: a fresh
    state of max(budget, S) slots, the prompt's K/V and the cross K/V of
    ``enc_out`` written into it; decode: one token a row against
    ``state`` (its cross K/V read, never made again), its self-attention
    cache written in place."""
    cfg = net.cfg
    cdt = tfm._cdt(cfg)
    b = tokens.shape[0]
    idx = _idx(cfg)
    hp, nkv, hd = padded_heads(cfg), cfg.n_kv_heads, cfg.head_dim_
    if mode == "decode":
        positions = state.pos[:, None]                   # (B, 1)
    else:
        positions = _positions(b, tokens.shape[1], tokens.device)
        if mode == "prefill":
            state = encdec_state_init(
                cfg, b, max(budget or 0, tokens.shape[1]), enc_out.shape[1],
                cdt, tokens.device)
    x = tfm._embed_inputs(net, tokens, None, positions, cdt)
    tables = tfm._rope(cfg, positions)
    s = x.shape[1]
    if mode == "decode":
        t_enc = state.xk.shape[2]
        xpos = _positions(b, t_enc, tokens.device)
        far = torch.full((b,), 2 ** 30, dtype=torch.int32,
                         device=tokens.device)
    for i, layer in enumerate(net["dec_layers"]):
        # causal self-attention (and its cache)
        q, k, v = attn.qkv_project(layer["self"], layer["ln_self"](x), cfg,
                                   tables, cdt)
        if mode == "decode":
            ck, cv, cp = attn.update_cache_layer(
                state.k[i], state.v[i], state.kpos[i], k, v, positions)
            o = attn.attend_decode(q, ck, cv, cp, idx,
                                   q_position=positions[:, 0])
        else:
            o = attn.attend_chunked(q, k, v, idx, causal=True, window=0,
                                    chunk=cfg.attn.chunk, impl=attention)
            if mode == "prefill":
                attn.update_cache_layer(state.k[i], state.v[i],
                                        state.kpos[i], k, v, positions)
        x = x + attn.attn_out(layer["self"], o, cfg, cdt)
        # cross-attention to the encoder output
        cross = layer["cross"]
        qx = linear(cross["wq"], layer["ln_cross"](x), cdt).reshape(
            b, s, hp, hd)
        if mode == "decode":
            o = attn.attend_decode(qx, state.xk[i], state.xv[i], xpos, idx,
                                   q_position=far)
        else:
            t_enc = enc_out.shape[1]
            xk = linear(cross["wk"], enc_out, cdt).reshape(b, t_enc, nkv, hd)
            xv = linear(cross["wv"], enc_out, cdt).reshape(b, t_enc, nkv, hd)
            if mode == "prefill":
                state.xk[i].copy_(xk)
                state.xv[i].copy_(xv)
            o = attn.attend_chunked(qx, xk, xv, idx, causal=False, window=0,
                                    chunk=cfg.attn.chunk, impl=attention)
        x = x + attn.attn_out(cross, o, cfg, cdt)
        x = x + layer["mlp"](layer["ln_mlp"](x), cdt)
    if mode == "train":
        return x, None
    return x, state._replace(pos=positions[:, -1] + 1)
