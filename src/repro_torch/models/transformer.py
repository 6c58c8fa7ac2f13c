"""Decoder-only transformer of the dense, moe, vlm, ssm and hybrid
families: init, the forward pass in train, prefill and decode mode over a
dense decode state, and paged decode and chunked prefill over a
block-arena KV cache.

The counterpart of ``repro.models.transformer`` for ``family="dense"``
(qwen2, deepseek, phi3, command-r with its parallel residual),
``family="moe"`` (qwen2-moe, qwen3-moe: the MLP replaced by ``moe.MoE``,
whose router aux loss is summed over the layers), ``family="vlm"``
(phi-3-vision: patch embeddings through ``patch_proj`` prepended to the
tokens, positions over both), ``family="ssm"`` (xlstm: groups of
``slstm_every - 1`` mLSTM layers, then one sLSTM layer, each a residual
block with its own norm) and ``family="hybrid"`` (hymba: attention and a
Mamba head on the same normed input, averaged, then the MLP; sliding-window
attention but on the global layers ``layer_flags`` names).  The reference
scans one stacked layer; here each layer is a module in an
``nn.ModuleList`` and a Python loop runs them.  A layer computes its q, k
and v and hands them to the mode's attention, which writes the KV cache in
place; the recurrent states are written in place too.  encdec has its own
stack, ``models.encdec``, which reuses ``sinusoid``, ``unembed`` and the
embedding here; this module's stack and states refuse it.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.config import ArchConfig
from . import attention as attn
from . import ssm as ssm_mod
from .moe import MoE, moe_init
from . import layers
from .layers import (MLP, Embed, Linear, Norm, embed_init, kernel_linear,
                     linear, linear_init, mlp_init, norm_init, padded_heads,
                     padded_vocab, rope_tables)

__all__ = ["FAMILIES", "PAGED_FAMILIES", "check_family",
           "ssm_layer_counts", "layer_flags", "DecoderLayer", "MLSTMLayer",
           "SLSTMLayer", "Transformer", "LAYER_LISTS", "State", "init_state",
           "init_pieces", "transformer_init", "load_tree",
           "forward", "run_layers", "unembed", "PagedState",
           "init_paged_state", "forward_paged_decode", "forward_paged_chunk"]

#: the families the port's models cover (every family of the reference)
FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")
#: families the paged decode path supports (an attention-only decode
#: state; the recurrent families carry per-layer state a block arena does
#: not hold)
PAGED_FAMILIES = ("dense", "moe", "vlm")


def check_family(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port does not know,
    rather than run it as another."""
    family = "encdec" if cfg.is_encdec else cfg.family
    if family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the port's models cover the families {FAMILIES}, "
            f"not {family!r}")


def _decoder_only(cfg: ArchConfig) -> None:
    """This module's stack and states are the decoder-only families';
    encdec raises ``ValueError`` (its stack is ``models.encdec``)."""
    check_family(cfg)
    if cfg.is_encdec:
        raise ValueError(f"{cfg.name} is an encoder-decoder: its stack and "
                         f"state are models.encdec's")


def _check_paged(cfg: ArchConfig, what: str) -> None:
    if cfg.family not in PAGED_FAMILIES:
        raise NotImplementedError(
            f"{what} supports families {PAGED_FAMILIES}, not {cfg.family!r}")


def _cdt(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def ssm_layer_counts(cfg: ArchConfig) -> Tuple[int, int]:
    """(n_mlstm, n_slstm) for the xLSTM 7:1-style interleave."""
    L = cfg.n_layers
    if cfg.family != "ssm" or cfg.ssm.slstm_every <= 0:
        return L, 0
    n_s = L // cfg.ssm.slstm_every
    return L - n_s, n_s


def layer_flags(cfg: ArchConfig) -> Dict[str, np.ndarray]:
    """Static per-layer flags: hymba's ``global_attn``, full attention on
    the first, middle and last layer."""
    flags: Dict[str, np.ndarray] = {}
    if cfg.family == "hybrid":
        L = cfg.n_layers
        g = np.zeros((L,), np.bool_)
        g[[0, L // 2, L - 1]] = True
        flags["global_attn"] = g
    return flags


# ---------------------------------------------------------------------------
# Modules and init
# ---------------------------------------------------------------------------

class DecoderLayer(nn.ModuleDict):
    """``ln_attn``, ``attn``, ``ln_mlp`` (not with a parallel residual) and
    ``mlp``, or ``moe`` where ``cfg.moe.enabled``; hybrid adds ``mamba``."""

    def __init__(self, cfg: ArchConfig, device=None):
        mods = {"ln_attn": Norm(cfg.d_model, cfg.norm, device),
                "attn": attn.Attention(cfg, device)}
        if cfg.moe.enabled:
            mods["moe"] = MoE(cfg, device)
        else:
            mods["mlp"] = MLP(cfg, device=device)
        if not cfg.parallel_residual:
            mods["ln_mlp"] = Norm(cfg.d_model, cfg.norm, device)
        if cfg.family == "hybrid":
            mods["mamba"] = ssm_mod.Mamba(cfg, cfg.ssm.expand * cfg.d_model,
                                          device)
        super().__init__(mods)
        self.cfg = cfg

    def ffn(self, h: torch.Tensor):
        """-> (the FFN of ``h``, the router aux loss or None (dense))."""
        if "moe" in self:
            return self["moe"](h, _cdt(self.cfg))
        return self["mlp"](h, _cdt(self.cfg)), None

    def forward(self, x: torch.Tensor, tables, attend: Callable,
                mamba: Optional[Callable] = None):
        """``tables``: the forward's rope tables (``_rope``); ``attend(q, k,
        v)`` -> (B, S, Hp, hd): the mode's attention, which also writes the
        layer's KV cache; hybrid: ``mamba(p, h)`` -> (B, S, d), the Mamba
        head on the same normed input, which also writes its state.
        -> (x, aux loss or None): the reference's ``_ffn_residual``, or its
        hybrid branch."""
        cfg, cdt = self.cfg, _cdt(self.cfg)
        h = self["ln_attn"](x)
        q, k, v = attn.qkv_project(self["attn"], h, cfg, tables, cdt)
        attn_o = attn.attn_out(self["attn"], attend(q, k, v), cfg, cdt)
        if "mamba" in self:
            x = x + (attn_o + mamba(self["mamba"], h)) * 0.5
            return x + self["mlp"](self["ln_mlp"](x), cdt), None
        # the residual and the FFN; a parallel residual (command-r) feeds
        # the pre-attention normed input to both branches
        if cfg.parallel_residual:
            ff, aux = self.ffn(h)
            return x + attn_o + ff, aux
        x = x + attn_o
        ff, aux = self.ffn(self["ln_mlp"](x))
        return x + ff, aux


class MLSTMLayer(nn.ModuleDict):
    """xlstm's mLSTM layer: ``ln`` and ``mlstm``, a residual block."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__({"ln": Norm(cfg.d_model, cfg.norm, device),
                          "mlstm": ssm_mod.MLSTM(
                              cfg, cfg.ssm.expand * cfg.d_model, cfg.n_heads,
                              device)})


class SLSTMLayer(nn.ModuleDict):
    """xlstm's sLSTM layer: ``ln_s`` and ``slstm``, a residual block."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__({"ln_s": Norm(cfg.d_model, cfg.norm, device),
                          "slstm": ssm_mod.SLSTM(cfg, cfg.n_heads, device)})


class Transformer(nn.ModuleDict):
    """``embed``, ``layers`` (one DecoderLayer each; ssm: one MLSTMLayer
    each, and ``slstm_layers``), ``ln_f``, untied, ``unembed`` and, with
    patches, ``patch_proj``: the reference's parameter tree, its layer axes
    lists."""

    def __init__(self, cfg: ArchConfig, device=None):
        _decoder_only(cfg)
        n_m, n_s = ssm_layer_counts(cfg)
        layer = MLSTMLayer if cfg.family == "ssm" else DecoderLayer
        mods = {"embed": Embed(padded_vocab(cfg), cfg.d_model, device),
                "layers": nn.ModuleList(layer(cfg, device)
                                        for _ in range(n_m)),
                "ln_f": Norm(cfg.d_model, cfg.norm, device)}
        if n_s > 0:
            mods["slstm_layers"] = nn.ModuleList(SLSTMLayer(cfg, device)
                                                 for _ in range(n_s))
        if not cfg.tie_embeddings:
            mods["unembed"] = Linear(cfg.d_model, padded_vocab(cfg),
                                     device=device)
        if cfg.n_patches > 0:
            mods["patch_proj"] = Linear(cfg.d_model, cfg.d_model,
                                        device=device)
        super().__init__(mods)
        self.cfg = cfg


def _layer_init(generator: torch.Generator, cfg: ArchConfig):
    dev = generator.device
    if cfg.family == "ssm":
        return {"ln": norm_init(cfg.d_model, cfg.norm, dev),
                "mlstm": ssm_mod.mlstm_init(
                    generator, cfg, cfg.ssm.expand * cfg.d_model,
                    cfg.n_heads)}
    p = {"ln_attn": norm_init(cfg.d_model, cfg.norm, dev),
         "attn": attn.attn_init(generator, cfg)}
    if cfg.moe.enabled:
        p["moe"] = moe_init(generator, cfg)
    else:
        p["mlp"] = mlp_init(generator, cfg)
    if not cfg.parallel_residual:
        p["ln_mlp"] = norm_init(cfg.d_model, cfg.norm, dev)
    if cfg.family == "hybrid":
        p["mamba"] = ssm_mod.mamba_init(generator, cfg,
                                        cfg.ssm.expand * cfg.d_model)
    return p


def _slstm_layer_init(generator: torch.Generator, cfg: ArchConfig):
    return {"ln_s": norm_init(cfg.d_model, cfg.norm, generator.device),
            "slstm": ssm_mod.slstm_init(generator, cfg, cfg.n_heads)}


#: the children that are lists of layers
LAYER_LISTS = ("layers", "slstm_layers")


def init_pieces(generator: torch.Generator, cfg: ArchConfig):
    """The Param trees of a Transformer's children in draw order, one at a
    time: ("embed", tree), ("layers", tree) once a layer, ("slstm_layers",
    tree) once an sLSTM layer, ("ln_f", tree), untied ("unembed", tree)
    and, with patches, ("patch_proj", tree).  The reference's distributions
    (normal / sqrt(d_in), ``wo`` at 1 / sqrt(hp * hd), the embedding at
    0.02, zero biases, unit norm scales, and the recurrent blocks' own:
    ``ssm``) on ``generator``'s device."""
    _decoder_only(cfg)
    n_m, n_s = ssm_layer_counts(cfg)
    yield "embed", embed_init(generator, padded_vocab(cfg), cfg.d_model)
    for _ in range(n_m):
        yield "layers", _layer_init(generator, cfg)
    for _ in range(n_s):
        yield "slstm_layers", _slstm_layer_init(generator, cfg)
    yield "ln_f", norm_init(cfg.d_model, cfg.norm, generator.device)
    if not cfg.tie_embeddings:
        yield "unembed", linear_init(generator, cfg.d_model,
                                     padded_vocab(cfg), ("embed", "vocab"))
    if cfg.n_patches > 0:
        yield "patch_proj", linear_init(generator, cfg.d_model, cfg.d_model,
                                        ("embed", "embed2"))


def transformer_init(generator: torch.Generator, cfg: ArchConfig):
    """The whole Param tree of a Transformer (``init_pieces`` gathered, the
    layers lists)."""
    p = {}
    for name, tree in init_pieces(generator, cfg):
        if name in LAYER_LISTS:
            p.setdefault(name, []).append(tree)
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
                attention: str, global_attn: Optional[bool] = None):
    """The dense-cache attention of one layer.  train: attend_chunked;
    prefill: attend_chunked, then the prompt's K/V (its last W rows) into
    ``cache`` = (k, v, kpos) of the layer; decode: the new K/V into the
    cache, then attend_decode over it.  ``global_attn``: hymba's flag of
    the layer (None elsewhere).  A global layer's train and prefill run at
    window 0, so that the flash kernel runs full causal attention there
    (the reference's ``global_flag`` mask admits every causal key, which is
    window 0); decode keeps the reference's mask with the flag."""
    window = cfg.attn.window
    idx_map = attn.kv_index_map(cfg.n_heads, cfg.n_kv_heads,
                                padded_heads(cfg))
    if mode == "decode":
        ck, cv, cpos = attn.update_cache_layer(*cache, k, v, positions)
        return attn.attend_decode(q, ck, cv, cpos, idx_map,
                                  q_position=positions[:, 0], window=window,
                                  global_flag=global_attn)
    out = attn.attend_chunked(q, k, v, idx_map,
                              causal=cfg.attn.kind != "none",
                              window=0 if global_attn else window,
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
    ``kpos`` (L, B, W) absolute position of each slot (-1 empty); the
    recurrent states, each of size 0 where the family has none:
    ``mlstm_c`` (n_m, B, H, dh, dh), ``mlstm_n`` (n_m, B, H, dh),
    ``mlstm_m`` (n_m, B, H), ``slstm`` (4, n_s, B, H, dh) (c, n, m, h),
    ``mamba`` (L, B, D, N); ``pos`` (B,) the next absolute position."""
    k: torch.Tensor
    v: torch.Tensor
    kpos: torch.Tensor
    mlstm_c: torch.Tensor
    mlstm_n: torch.Tensor
    mlstm_m: torch.Tensor
    slstm: torch.Tensor
    mamba: torch.Tensor
    pos: torch.Tensor


def init_state(cfg: ArchConfig, batch: int, budget: int,
               dtype=torch.bfloat16, device=None) -> State:
    """``budget`` slots a layer (as the reference's, not cut to a window;
    none without attention), the recurrent states zero with their
    stabilisers at -1e30."""
    _decoder_only(cfg)
    L, d, h = cfg.n_layers, cfg.d_model, cfg.n_heads

    def z(*shape):
        return torch.zeros(shape, device=device)
    if cfg.family == "ssm":
        n_m, n_s = ssm_layer_counts(cfg)
        dh = cfg.ssm.expand * d // h
        ml = (z(n_m, batch, h, dh, dh), z(n_m, batch, h, dh),
              torch.full((n_m, batch, h), ssm_mod.NEG, device=device))
        sl = z(4, n_s, batch, h, d // h)
        sl[2] = ssm_mod.NEG
    else:
        ml, sl = (z(L, 0, 0, 0, 0), z(L, 0, 0), z(L, 0, 0)), z(4, L, 0, 0, 0)
    mam = z(L, batch, cfg.ssm.expand * d, cfg.ssm.d_state) \
        if cfg.family == "hybrid" else z(L, 0, 0, 0)
    w = 0 if cfg.family == "ssm" else budget
    shape = (L, batch, w, cfg.n_kv_heads, cfg.head_dim_)
    return State(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        kpos=torch.full(shape[:3], -1, dtype=torch.int32, device=device),
        mlstm_c=ml[0], mlstm_n=ml[1], mlstm_m=ml[2], slstm=sl, mamba=mam,
        pos=torch.zeros(batch, dtype=torch.int32, device=device))


def sinusoid(positions, d: int):
    half = d // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _rope(cfg: ArchConfig, positions):
    """The rope tables of ``positions`` (B, S), made once a forward for
    every layer, or None for a model without rope."""
    if cfg.attn.rope_theta == 0:
        return None
    return rope_tables(positions, cfg.head_dim_, cfg.attn.rope_theta)


def _embed_inputs(net: Transformer, tokens, patches, positions, cdt):
    """The token embeddings, after the patch rows (``patch_proj`` of
    ``patches`` (B, P, d) in the compute type) where the model takes
    patches and is given them, plus the sinusoid without rope."""
    x = net["embed"](tokens, cdt)
    if net.cfg.n_patches > 0 and patches is not None:
        pe = linear(net["patch_proj"], patches.to(cdt), cdt)
        x = torch.cat([pe, x], dim=1)
    if net.cfg.attn.rope_theta == 0:
        x = x + sinusoid(positions, net.cfg.d_model).to(cdt)
    return x


def unembed(net: Transformer, x: torch.Tensor) -> torch.Tensor:
    """Final norm and the vocab projection in fp32; vocab-padding slots are
    masked to -1e30.  On the card the product runs on the f32 matmul
    kernel, forward and backward (``layers.kernel_linear``); with tied
    embeddings its (d, Vp) operand is ``emb``'s transpose, kept beside
    ``emb`` and made again when ``emb`` changes (``layers.kernel_operand``:
    0.93 GB at qwen2-1.5b's width), and under autograd the logits' gradient
    reaches ``emb`` through the kernel's backward (dY^T X)."""
    cfg = net.cfg
    xf = net["ln_f"](x).float()
    w, tied = ((net["embed"]["emb"], True) if cfg.tie_embeddings
               else (net["unembed"]["w"], False))
    if layers._on_card(xf):
        logits = kernel_linear(xf.reshape(-1, xf.shape[-1]), w,
                               torch.float32, transposed=tied)
        logits = logits.reshape(*xf.shape[:-1], logits.shape[-1])
    else:
        logits = torch.matmul(xf, w.float().t() if tied else w.float())
    vp = logits.shape[-1]
    if vp != cfg.vocab:
        keep = torch.arange(vp, device=logits.device) < cfg.vocab
        logits = logits.masked_fill(~keep, -1e30)
    return logits


def _ssm_layers(net: Transformer, x: torch.Tensor, state: State,
                mode: str, remat: bool = False) -> torch.Tensor:
    """xlstm's stack, the reference's ``_ssm_forward``: groups of
    ``slstm_every - 1`` mLSTM layers, then one sLSTM layer (all mLSTM
    layers without sLSTM), each a residual block.  The states are read
    from ``state`` and, outside train, written back in place.  ``remat``
    in train mode under autograd runs each block under
    ``torch.utils.checkpoint``, as the reference checkpoints each layer."""
    cfg = net.cfg
    cdt = _cdt(cfg)
    n_m, n_s = ssm_layer_counts(cfg)
    per_g = cfg.ssm.slstm_every - 1 if n_s else n_m
    write = mode != "train"
    ckpt = remat and mode == "train" and torch.is_grad_enabled()

    def block(fn, x, held, p, ln):
        def run(x):
            out, new = fn(p, ln(x), cfg, held, mode=mode,
                          n_heads=cfg.n_heads, compute_dtype=cdt)
            return x + out, new
        return checkpoint(run, x, use_reentrant=False) if ckpt else run(x)
    for g in range(max(n_s, 1)):
        for i in range(g * per_g, (g + 1) * per_g):
            layer = net["layers"][i]
            held = (state.mlstm_c[i], state.mlstm_n[i], state.mlstm_m[i])
            x, new = block(ssm_mod.mlstm_block, x, ssm_mod.MLSTMState(*held),
                           layer["mlstm"], layer["ln"])
            if write:
                for dst, src in zip(held, new):
                    dst.copy_(src)
        if n_s:
            layer = net["slstm_layers"][g]
            x, new = block(ssm_mod.slstm_block, x, ssm_mod.SLSTMState(
                *state.slstm[:, g].unbind(0)), layer["slstm"], layer["ln_s"])
            if write:
                state.slstm[:, g].copy_(torch.stack(new))
    return x


def _mamba_head(p, h, cfg: ArchConfig, state: State, i: int, mode: str):
    """Layer ``i``'s Mamba head on ``h``, its state read from ``state`` and,
    outside train, written back in place."""
    out, new = ssm_mod.mamba_apply(p, h, cfg, ssm_mod.MambaState(
        state.mamba[i]), mode=mode, compute_dtype=_cdt(cfg))
    if mode != "train":
        state.mamba[i].copy_(new.s)
    return out


def run_layers(net: Transformer, tokens: torch.Tensor, *,
               patches: Optional[torch.Tensor] = None, mode: str = "train",
               state: Optional[State] = None, budget: Optional[int] = None,
               attention: str = "flash", with_aux: bool = False,
               remat: bool = False):
    """The embedding (after the patch rows, where the model takes
    ``patches`` and is given them) and every layer -> (hidden (B, S, d),
    new state or None), and with ``with_aux`` the router aux loss summed
    over the layers (f32, 0 outside moe) after them.  train: no cache (the
    recurrent families start from zero states); prefill: a fresh state of
    ``budget`` (>= the sequence, patch rows included) KV slots unless
    ``state`` is given; decode: one token a row against ``state``, written
    in place.  ``remat`` in train mode under autograd runs each decoder
    layer under ``torch.utils.checkpoint`` (its activations made again in
    the backward pass: the reference's ``jax.checkpoint`` of a layer)."""
    cfg = net.cfg
    cdt = _cdt(cfg)
    b = tokens.shape[0]
    if mode == "decode":
        positions = state.pos[:, None]                   # (B, 1)
        patches = None
    else:
        s = tokens.shape[1]
        if cfg.n_patches > 0 and patches is not None:
            s += cfg.n_patches
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
        if state is None and (mode == "prefill"
                              or cfg.family in ("ssm", "hybrid")):
            state = init_state(cfg, b, 0 if mode == "train" else
                               max(budget or 0, s), cdt, tokens.device)
    x = _embed_inputs(net, tokens, patches, positions, cdt)
    aux = torch.zeros((), device=x.device) if with_aux else None
    if cfg.family == "ssm":
        x = _ssm_layers(net, x, state, mode, remat)
    else:
        tables = _rope(cfg, positions)
        flags = layer_flags(cfg).get("global_attn")
        ckpt = remat and mode == "train" and torch.is_grad_enabled()
        for i, layer in enumerate(net["layers"]):
            cache = None if mode == "train" else \
                (state.k[i], state.v[i], state.kpos[i])
            glob = None if flags is None else bool(flags[i])
            args = (x, tables, lambda q, k, v, cache=cache, glob=glob:
                    _attn_block(q, k, v, cfg, positions, mode, cache,
                                attention, glob),
                    lambda p, h, i=i: _mamba_head(p, h, cfg, state, i, mode))
            x, layer_aux = checkpoint(layer, *args, use_reentrant=False) \
                if ckpt else layer(*args)
            if with_aux and layer_aux is not None:
                aux = aux + layer_aux
    state = None if mode == "train" else \
        state._replace(pos=positions[:, -1] + 1)
    return (x, state, aux) if with_aux else (x, state)


def forward(net: Transformer, tokens: torch.Tensor, *,
            patches: Optional[torch.Tensor] = None, mode: str = "train",
            state: Optional[State] = None, budget: Optional[int] = None,
            attention: str = "flash", with_aux: bool = False,
            remat: bool = False):
    """-> (logits (B, S, Vp) fp32, patch rows first, new state or None),
    and with ``with_aux`` the router aux loss summed over the layers after
    them.  ``remat``: ``run_layers``'."""
    x, *rest = run_layers(net, tokens, patches=patches, mode=mode,
                          state=state, budget=budget, attention=attention,
                          with_aux=with_aux, remat=remat)
    return (unembed(net, x), *rest)


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
    _check_paged(cfg, "paged decode")
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
    _check_paged(cfg, "paged decode")
    cdt = _cdt(cfg)
    bl = paged.pos.shape[1]
    positions = slot_pos[:, None]                        # (B, 1)
    x = _embed_inputs(net, tokens, None, positions, cdt)
    # this step's write target per slot; inactive slots (table entry -1)
    # clamp to the scratch block 0, whose rows are never attended
    blk = torch.gather(block_table, 1, (slot_pos // bl)[:, None].long()
                       )[:, 0].clamp_min(0).long()
    off = (slot_pos % bl).long()
    paged.pos[blk, off] = slot_pos.to(paged.pos.dtype)
    idx_map = attn.kv_index_map(cfg.n_heads, cfg.n_kv_heads,
                                padded_heads(cfg))
    # attend_paged with the position plane gathered once for every layer
    bt, pos = attn.paged_positions(paged.pos, block_table)

    def attend(i, q, k, v):
        attn.append_paged_layer(paged.k[i], paged.v[i], k, v, blk, off)
        return attn.attend_decode(
            q, attn.gather_blocks(paged.k[i], bt),
            attn.gather_blocks(paged.v[i], bt), pos, idx_map,
            q_position=slot_pos, window=cfg.attn.window)

    tables = _rope(cfg, positions)
    for i, layer in enumerate(net["layers"]):
        x, _ = layer(x, tables, lambda q, k, v: attend(i, q, k, v))
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
    _check_paged(cfg, "paged chunk prefill")
    cdt = _cdt(cfg)
    start, n_real = int(start), int(n_real)
    c = tokens.shape[1]
    bl, mb = paged.pos.shape[1], block_table.shape[1]
    offs = torch.arange(c, dtype=torch.int32, device=tokens.device)
    positions = start + offs                             # (C,)
    valid = offs < n_real
    pos_q = positions[None, :]                           # (1, C)
    x = _embed_inputs(net, tokens, None, pos_q, cdt)
    bidx = (positions // bl).clamp(0, mb - 1).long()
    blk = torch.where(valid, block_table[0][bidx].clamp_min(0), 0).long()
    off = torch.where(valid, positions % bl, 0).long()
    paged.pos[blk, off] = torch.where(valid, positions, -1).to(paged.pos.dtype)
    idx_map = attn.kv_index_map(cfg.n_heads, cfg.n_kv_heads,
                                padded_heads(cfg))
    bt, pd = attn.paged_positions(paged.pos, block_table)

    def attend(i, q, k, v):
        k_l, v_l = paged.k[i], paged.v[i]
        k_l[blk, off] = k[0].to(k_l.dtype)
        v_l[blk, off] = v[0].to(v_l.dtype)
        return attn.attend_prefix(q, attn.gather_blocks(k_l, bt),
                                  attn.gather_blocks(v_l, bt), pd, idx_map,
                                  q_positions=pos_q, window=cfg.attn.window)

    tables = _rope(cfg, pos_q)
    for i, layer in enumerate(net["layers"]):
        x, _ = layer(x, tables, lambda q, k, v: attend(i, q, k, v))
    x_last = x[:, max(n_real - 1, 0):max(n_real, 1)]      # (1, 1, d)
    return unembed(net, x_last)[:, -1], paged
