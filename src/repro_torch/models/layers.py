"""Building blocks shared by every architecture: linear, norm, embed, rope
and the MLP, their initializers and their modules.

The counterpart of ``repro.models.layers``.  Initializers return trees
whose leaves are ``Param(value, logical_axes)``; apply functions take any
mapping of tensors with the reference's keys, the modules here included
(each is an ``nn.ParameterDict`` or ``nn.ModuleDict`` under those keys, so
``state_dict`` paths are the reference's tree paths).  Weights keep the
reference's (d_in, d_out) layout and fp32; compute runs in ``cfg.dtype``
(bf16 by default), cast at each call as there, with fp32 norms.  The
products go to ``torch.matmul``: the reference computes them outside any
Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import ArchConfig
from ..distributed.sharding import Param

__all__ = ["pad_to", "padded_heads", "padded_vocab", "linear_init", "linear",
           "norm_init", "norm", "embed_init", "embed", "rope", "mlp_init",
           "mlp", "Linear", "Norm", "Embed", "MLP"]


def pad_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def padded_heads(cfg: ArchConfig, tp: int = 1) -> int:
    """q heads padded up to a multiple of the TP degree ``tp`` (padded
    heads' out-projection rows are sliced off the result).  One card: 1."""
    return pad_to(cfg.n_heads, tp) if tp > 1 else cfg.n_heads


def padded_vocab(cfg: ArchConfig, tp: int = 1) -> int:
    return pad_to(cfg.vocab, tp * 128) if tp > 1 else pad_to(cfg.vocab, 128)


# ---------------------------------------------------------------------------
# Initializers: the reference's distributions from an explicit generator
# ---------------------------------------------------------------------------

def _normal(generator: torch.Generator, shape, scale: float,
            dtype: str = "float32") -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=getattr(torch, dtype)) * scale


def linear_init(generator: torch.Generator, d_in: int, d_out: int,
                axes: Tuple, *, bias: bool = False,
                scale: Optional[float] = None, dtype: str = "float32"):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": Param(_normal(generator, (d_in, d_out), scale, dtype), axes)}
    if bias:
        p["b"] = Param(torch.zeros(d_out, device=generator.device,
                                   dtype=getattr(torch, dtype)), (axes[-1],))
    return p


def norm_init(d: int, kind: str = "rmsnorm", device=None):
    p = {"scale": Param(torch.ones(d, device=device), ("embed",))}
    if kind == "layernorm":
        p["bias"] = Param(torch.zeros(d, device=device), ("embed",))
    return p


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype: str = "float32"):
    # GPT-style 0.02 std: keeps tied-unembedding logits O(1) at init
    return {"emb": Param(_normal(generator, (vocab, d), 0.02, dtype),
                         ("vocab", "embed"))}


def mlp_init(generator: torch.Generator, cfg: ArchConfig,
             d_ff: Optional[int] = None):
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    p = {"down": linear_init(generator, ff, d, ("mlp", "embed"),
                             dtype=cfg.param_dtype)}
    if cfg.act == "swiglu":
        p["gate"] = linear_init(generator, d, ff, ("embed", "mlp"),
                                dtype=cfg.param_dtype)
    p["up"] = linear_init(generator, d, ff, ("embed", "mlp"),
                          dtype=cfg.param_dtype)
    return p


# ---------------------------------------------------------------------------
# Apply functions
# ---------------------------------------------------------------------------

def linear(p, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    out = torch.matmul(x.to(compute_dtype), p["w"].to(compute_dtype))
    if "b" in p:
        out = out + p["b"].to(compute_dtype)
    return out


def norm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if "bias" in p:  # layernorm
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:  # rmsnorm
        ms = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"]
    return out.to(x.dtype)


def embed(p, tokens: torch.Tensor, compute_dtype=torch.bfloat16):
    emb = p["emb"]
    rows = torch.index_select(emb, 0, tokens.reshape(-1))
    return rows.reshape(*tokens.shape, emb.shape[1]).to(compute_dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int."""
    half = x.shape[-1] // 2
    freq = torch.pow(theta, -torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half)
    ang = positions[..., None].float() * freq                 # (B, S, half)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def mlp(p, x: torch.Tensor, act: str = "swiglu",
        compute_dtype=torch.bfloat16) -> torch.Tensor:
    if act == "swiglu":
        h = F.silu(linear(p["gate"], x, compute_dtype)) * \
            linear(p["up"], x, compute_dtype)
    elif act == "gelu":    # jax.nn.gelu's default: the tanh approximation
        h = F.gelu(linear(p["up"], x, compute_dtype), approximate="tanh")
    else:
        h = F.relu(linear(p["up"], x, compute_dtype))
    return linear(p["down"], h, compute_dtype)


# ---------------------------------------------------------------------------
# Modules: the parameters under the reference's keys, shaped as the
# initializers make them; Model.init fills them
# ---------------------------------------------------------------------------

def _empty(*shape, device=None, dtype: str = "float32") -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device,
                                    dtype=getattr(torch, dtype)))


class _Params(nn.ParameterDict):
    """A mapping of parameters that is also called as a module
    (``nn.ParameterDict`` refuses calls)."""
    __call__ = nn.Module.__call__


class Linear(nn.ParameterDict):
    """``w`` (d_in, d_out) and, with ``bias``, ``b`` (d_out,), applied by
    ``linear``."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 device=None, dtype: str = "float32"):
        super().__init__({"w": _empty(d_in, d_out, device=device,
                                      dtype=dtype)})
        if bias:
            self["b"] = _empty(d_out, device=device, dtype=dtype)


class Norm(_Params):
    """RMSNorm (``scale``), or LayerNorm (``scale`` and ``bias``)."""

    def __init__(self, d: int, kind: str = "rmsnorm", device=None):
        super().__init__({"scale": _empty(d, device=device)})
        if kind == "layernorm":
            self["bias"] = _empty(d, device=device)

    def forward(self, x):
        return norm(self, x)


class Embed(_Params):
    """``emb`` (vocab, d)."""

    def __init__(self, vocab: int, d: int, device=None):
        super().__init__({"emb": _empty(vocab, d, device=device)})

    def forward(self, tokens, compute_dtype=torch.bfloat16):
        return embed(self, tokens, compute_dtype)


class MLP(nn.ModuleDict):
    """``gate`` (swiglu only), ``up`` and ``down``."""

    def __init__(self, cfg: ArchConfig, d_ff: Optional[int] = None,
                 device=None):
        d, ff = cfg.d_model, d_ff or cfg.d_ff
        mods = {"down": Linear(ff, d, device=device, dtype=cfg.param_dtype),
                "up": Linear(d, ff, device=device, dtype=cfg.param_dtype)}
        if cfg.act == "swiglu":
            mods["gate"] = Linear(d, ff, device=device, dtype=cfg.param_dtype)
        super().__init__(mods)
        self.act = cfg.act

    def forward(self, x, compute_dtype=torch.bfloat16):
        return mlp(self, x, self.act, compute_dtype)
