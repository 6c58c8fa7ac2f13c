"""Decoder-only transformer of the dense family: init, the forward pass in
train, prefill and decode mode over a dense KV cache, and paged decode and
chunked prefill over a block-arena KV cache.

The counterpart of ``repro.models.transformer`` for ``family="dense"``
(qwen2, deepseek, phi3, command-r with its parallel residual).  The
reference scans one stacked layer; here each layer is a ``DecoderLayer``
module in an ``nn.ModuleList`` and a Python loop runs them.  A layer
computes its q, k and v and hands them to the mode's attention, which
writes the KV cache in place.  The other families (moe, ssm, hybrid, vlm,
encdec) raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from ..core.config import ArchConfig
from . import attention as attn
from .layers import (MLP, Embed, Linear, Norm, embed_init, linear_init,
                     mlp_init, norm_init, padded_heads, padded_vocab)

__all__ = ["FAMILIES", "check_family", "DecoderLayer", "Transformer",
           "State", "init_state", "init_pieces", "transformer_init",
           "load_tree",
           "forward", "run_layers", "unembed", "PagedState",
           "init_paged_state", "forward_paged_decode", "forward_paged_chunk"]

#: the families the port's models cover so far
FAMILIES = ("dense",)


def check_family(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port does not run
    yet, rather than run it as dense."""
    family = "encdec" if cfg.is_encdec else cfg.family
    if family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {family} family is not ported yet (the port's "
            f"models cover {FAMILIES}; ROADMAP queue 1 item 3)")


def _cdt(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Modules and init
# ---------------------------------------------------------------------------

class DecoderLayer(nn.ModuleDict):
    """``ln_attn``, ``attn``, ``ln_mlp`` (not with a parallel residual) and
    ``mlp``."""

    def __init__(self, cfg: ArchConfig, device=None):
        mods = {"ln_attn": Norm(cfg.d_model, cfg.norm, device),
                "attn": attn.Attention(cfg, device),
                "mlp": MLP(cfg, device=device)}
        if not cfg.parallel_residual:
            mods["ln_mlp"] = Norm(cfg.d_model, cfg.norm, device)
        super().__init__(mods)
        self.cfg = cfg

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                attend: Callable) -> torch.Tensor:
        """``attend(q, k, v)`` -> (B, S, Hp, hd): the mode's attention, which
        also writes the layer's KV cache."""
        cfg, cdt = self.cfg, _cdt(self.cfg)
        h = self["ln_attn"](x)
        q, k, v = attn.qkv_project(self["attn"], h, cfg, positions, cdt)
        attn_o = attn.attn_out(self["attn"], attend(q, k, v), cfg, cdt)
        # the residual and the FFN; a parallel residual (command-r) feeds
        # the pre-attention normed input to both branches
        if cfg.parallel_residual:
            return x + attn_o + self["mlp"](h, cdt)
        x = x + attn_o
        return x + self["mlp"](self["ln_mlp"](x), cdt)


class Transformer(nn.ModuleDict):
    """``embed``, ``layers`` (one DecoderLayer each), ``ln_f`` and, untied,
    ``unembed``: the reference's parameter tree, its layer axis a list."""

    def __init__(self, cfg: ArchConfig, device=None):
        check_family(cfg)
        mods = {"embed": Embed(padded_vocab(cfg), cfg.d_model, device),
                "layers": nn.ModuleList(DecoderLayer(cfg, device)
                                        for _ in range(cfg.n_layers)),
                "ln_f": Norm(cfg.d_model, cfg.norm, device)}
        if not cfg.tie_embeddings:
            mods["unembed"] = Linear(cfg.d_model, padded_vocab(cfg),
                                     device=device)
        super().__init__(mods)
        self.cfg = cfg


def _layer_init(generator: torch.Generator, cfg: ArchConfig):
    p = {"ln_attn": norm_init(cfg.d_model, cfg.norm, generator.device),
         "attn": attn.attn_init(generator, cfg),
         "mlp": mlp_init(generator, cfg)}
    if not cfg.parallel_residual:
        p["ln_mlp"] = norm_init(cfg.d_model, cfg.norm, generator.device)
    return p


def init_pieces(generator: torch.Generator, cfg: ArchConfig):
    """The Param trees of a Transformer's children in draw order, one at a
    time: ("embed", tree), ("layers", tree) once a layer, ("ln_f", tree)
    and, untied, ("unembed", tree).  The reference's distributions
    (normal / sqrt(d_in), ``wo`` at 1 / sqrt(hp * hd), the embedding at
    0.02, zero biases, unit norm scales) on ``generator``'s device."""
    check_family(cfg)
    yield "embed", embed_init(generator, padded_vocab(cfg), cfg.d_model)
    for _ in range(cfg.n_layers):
        yield "layers", _layer_init(generator, cfg)
    yield "ln_f", norm_init(cfg.d_model, cfg.norm, generator.device)
    if not cfg.tie_embeddings:
        yield "unembed", linear_init(generator, cfg.d_model,
                                     padded_vocab(cfg), ("embed", "vocab"))


def transformer_init(generator: torch.Generator, cfg: ArchConfig):
    """The whole Param tree of a Transformer (``init_pieces`` gathered, the
    layers a list)."""
    p = {"layers": []}
    for name, tree in init_pieces(generator, cfg):
        if name == "layers":
            p["layers"].append(tree)
        else:
            p[name] = tree
    return p


def _flat(tree, prefix: str = ""):
    """Nested dicts and lists of tensors -> {dotted path: tensor}."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        path = f"{prefix}{k}"
        out.update(_flat(v, path + ".") if isinstance(v, (dict, list))
                   else {path: v})
    return out


@torch.no_grad()
def load_tree(module: nn.Module, values) -> None:
    """Copy a value tree (the structure ``transformer_init``, or one of
    ``init_pieces``, gives for ``module``) into its parameters; every
    parameter must be given, at its shape."""
    module.load_state_dict(_flat(values), strict=True)


# ---------------------------------------------------------------------------
# Layer pieces
# ---------------------------------------------------------------------------

def _attn_block(q, k, v, cfg: ArchConfig, positions, mode: str, cache,
                attention: str):
    """The dense-cache attention of one layer.  train: attend_chunked;
    prefill: attend_chunked, then the prompt's K/V (its last W rows) into
    ``cache`` = (k, v, kpos) of the layer; decode: the new K/V into the
    cache, then attend_decode over it."""
    window = cfg.attn.window
    idx_map = attn.kv_index_map(cfg.n_heads, cfg.n_kv_heads,
                                padded_heads(cfg))
    if mode == "decode":
        ck, cv, cpos = attn.update_cache_layer(*cache, k, v, positions)
        return attn.attend_decode(q, ck, cv, cpos, idx_map,
                                  q_position=positions[:, 0], window=window)
    out = attn.attend_chunked(q, k, v, idx_map,
                              causal=cfg.attn.kind != "none", window=window,
                              chunk=cfg.attn.chunk, impl=attention)
    if mode == "prefill":
        tail = slice(max(k.shape[1] - cache[0].shape[1], 0), None)
        attn.update_cache_layer(*cache, k[:, tail], v[:, tail],
                                positions[:, tail])
    return out


# ---------------------------------------------------------------------------
# Decode state and the forward pass
# ---------------------------------------------------------------------------

class State(NamedTuple):
    """Stacked-over-layers decode state: ``k``/``v`` (L, B, W, KV, hd),
    ``kpos`` (L, B, W) absolute position of each slot (-1 empty), ``pos``
    (B,) the next absolute position."""
    k: torch.Tensor
    v: torch.Tensor
    kpos: torch.Tensor
    pos: torch.Tensor


def init_state(cfg: ArchConfig, batch: int, budget: int,
               dtype=torch.bfloat16, device=None) -> State:
    """``budget`` slots a layer (as the reference's, not cut to a window)."""
    check_family(cfg)
    shape = (cfg.n_layers, batch, budget, cfg.n_kv_heads, cfg.head_dim_)
    return State(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        kpos=torch.full(shape[:3], -1, dtype=torch.int32, device=device),
        pos=torch.zeros(batch, dtype=torch.int32, device=device))


def sinusoid(positions, d: int):
    half = d // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _embed_inputs(net: Transformer, tokens, positions, cdt):
    x = net["embed"](tokens, cdt)
    if net.cfg.attn.rope_theta == 0:
        x = x + sinusoid(positions, net.cfg.d_model).to(cdt)
    return x


def unembed(net: Transformer, x: torch.Tensor) -> torch.Tensor:
    """Final norm and the vocab projection in fp32; vocab-padding slots are
    masked to -1e30."""
    cfg = net.cfg
    xf = net["ln_f"](x).float()
    if cfg.tie_embeddings:
        logits = torch.matmul(xf, net["embed"]["emb"].float().t())
    else:
        logits = torch.matmul(xf, net["unembed"]["w"].float())
    vp = logits.shape[-1]
    if vp != cfg.vocab:
        keep = torch.arange(vp, device=logits.device) < cfg.vocab
        logits = logits.masked_fill(~keep, -1e30)
    return logits


def run_layers(net: Transformer, tokens: torch.Tensor, *, mode: str = "train",
               state: Optional[State] = None, budget: Optional[int] = None,
               attention: str = "flash"):
    """The embedding and every layer -> (hidden (B, S, d), new state or
    None).  train: no cache; prefill: a fresh cache of ``budget`` (>= the
    prompt) slots unless ``state`` is given; decode: one token a row
    against ``state``, written in place."""
    cfg = net.cfg
    cdt = _cdt(cfg)
    b = tokens.shape[0]
    if mode == "decode":
        positions = state.pos[:, None]                   # (B, 1)
    else:
        s = tokens.shape[1]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
        if mode == "prefill" and state is None:
            state = init_state(cfg, b, max(budget or 0, s), cdt,
                               tokens.device)
    x = _embed_inputs(net, tokens, positions, cdt)
    for i, layer in enumerate(net["layers"]):
        cache = None if mode == "train" else \
            (state.k[i], state.v[i], state.kpos[i])
        x = layer(x, positions, lambda q, k, v: _attn_block(
            q, k, v, cfg, positions, mode, cache, attention))
    if mode == "train":
        return x, None
    return x, state._replace(pos=positions[:, -1] + 1)


def forward(net: Transformer, tokens: torch.Tensor, *, mode: str = "train",
            state: Optional[State] = None, budget: Optional[int] = None,
            attention: str = "flash"):
    """-> (logits (B, S, Vp) fp32, new state or None)."""
    x, state = run_layers(net, tokens, mode=mode, state=state, budget=budget,
                          attention=attention)
    return unembed(net, x), state


# ---------------------------------------------------------------------------
# Paged decode and chunked prefill over a block-arena KV cache
# ---------------------------------------------------------------------------

class PagedState(NamedTuple):
    """Block-arena KV cache shared by all batch slots.  ``k``/``v``:
    (L, n_blocks, block_len, KV, hd); ``pos``: (n_blocks, block_len)
    absolute position of each row (-1 = empty), one plane for every layer.
    Block 0 is the scratch block inactive slots write into."""
    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor


def init_paged_state(cfg: ArchConfig, n_blocks: int, block_len: int,
                     dtype=None, device=None) -> PagedState:
    check_family(cfg)
    dtype = _cdt(cfg) if dtype is None else dtype
    shape = (cfg.n_layers, n_blocks, block_len, cfg.n_kv_heads,
             cfg.head_dim_)
    return PagedState(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((n_blocks, block_len), -1, dtype=torch.int32,
                       device=device))


def forward_paged_decode(net: Transformer, tokens, paged: PagedState,
                         block_table, slot_pos):
    """One decode step for B independent slots over the block arena.
    tokens: (B, 1) each slot's previous token; block_table: (B, MB) block
    ids, -1 = unused; slot_pos: (B,) each slot's next absolute position.
    Slots need not share a position: each writes at its own (block, row)
    and attends the rows whose gathered position is in [0, its own].
    Returns (last-token logits (B, Vp), ``paged`` written in place)."""
    cfg = net.cfg
    cdt = _cdt(cfg)
    bl = paged.pos.shape[1]
    positions = slot_pos[:, None]                        # (B, 1)
    x = _embed_inputs(net, tokens, positions, cdt)
    # this step's write target per slot; inactive slots (table entry -1)
    # clamp to the scratch block 0, whose rows are never attended
    blk = torch.gather(block_table, 1,
                       (slot_pos // bl)[:, None].long())[:, 0].clamp_min(0)
    off = slot_pos % bl
    paged.pos[blk.long(), off.long()] = slot_pos.to(paged.pos.dtype)
    idx_map = attn.kv_index_map(cfg.n_heads, cfg.n_kv_heads,
                                padded_heads(cfg))

    def attend(i, q, k, v):
        attn.append_paged_layer(paged.k[i], paged.v[i], k, v, blk, off)
        return attn.attend_paged(q, paged.k[i], paged.v[i], paged.pos,
                                 block_table, idx_map, q_position=slot_pos,
                                 window=cfg.attn.window)

    for i, layer in enumerate(net["layers"]):
        x = layer(x, positions, lambda q, k, v: attend(i, q, k, v))
    return unembed(net, x)[:, -1], paged


def forward_paged_chunk(net: Transformer, tokens, paged: PagedState,
                        block_table, start: int, n_real: int):
    """One prefill chunk for a single slot over the block arena.
    tokens: (1, C), rows [0, n_real) the real chunk, the rest padding;
    block_table: (1, MB) the slot's table (-1 = unused); start: the
    chunk's first absolute row; 1 <= n_real <= C.  Writes the real rows'
    K/V into the slot's blocks (pad rows land in scratch block 0 with
    position -1, never attended) and returns (logits of row start + n_real
    - 1, shape (1, Vp), ``paged`` written in place).  Attention is
    ``attend_prefix``'s full masked softmax over the gathered view, so row
    values do not depend on how the prompt was chunked."""
    cfg = net.cfg
    cdt = _cdt(cfg)
    start, n_real = int(start), int(n_real)
    c = tokens.shape[1]
    bl, mb = paged.pos.shape[1], block_table.shape[1]
    offs = torch.arange(c, dtype=torch.int32, device=tokens.device)
    positions = start + offs                             # (C,)
    valid = offs < n_real
    pos_q = positions[None, :]                           # (1, C)
    x = _embed_inputs(net, tokens, pos_q, cdt)
    bidx = (positions // bl).clamp(0, mb - 1).long()
    blk = torch.where(valid, block_table[0][bidx].clamp_min(0), 0).long()
    off = torch.where(valid, positions % bl, 0).long()
    paged.pos[blk, off] = torch.where(valid, positions, -1).to(paged.pos.dtype)
    idx_map = attn.kv_index_map(cfg.n_heads, cfg.n_kv_heads,
                                padded_heads(cfg))

    def attend(i, q, k, v):
        k_l, v_l = paged.k[i], paged.v[i]
        k_l[blk, off] = k[0].to(k_l.dtype)
        v_l[blk, off] = v[0].to(v_l.dtype)
        kd, vd, pd = attn.gather_paged_view(k_l, v_l, paged.pos, block_table)
        return attn.attend_prefix(q, kd, vd, pd, idx_map, q_positions=pos_q,
                                  window=cfg.attn.window)

    for i, layer in enumerate(net["layers"]):
        x = layer(x, pos_q, lambda q, k, v: attend(i, q, k, v))
    x_last = x[:, max(n_real - 1, 0):max(n_real, 1)]      # (1, 1, d)
    return unembed(net, x_last)[:, -1], paged
