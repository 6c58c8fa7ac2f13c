"""Building blocks shared by every architecture: linear, norm, embed, rope
and the MLP, their initializers and their modules.

The counterpart of ``repro.models.layers``.  Initializers return trees
whose leaves are ``Param(value, logical_axes)``; apply functions take any
mapping of tensors with the reference's keys, the modules here included
(each is an ``nn.ParameterDict`` or ``nn.ModuleDict`` under those keys, so
``state_dict`` paths are the reference's tree paths).  Weights keep the
reference's (d_in, d_out) layout and fp32; compute runs in ``cfg.dtype``
(bf16 by default), cast at each call as there, with fp32 norms.

The products (``linear``, ``expert_product`` and ``transformer.unembed``)
run on the port's matmul kernel on the card (``kernel_linear``, whose
backward runs the same kernel on transposed operands; the batched launch
for the expert stacks, ``ExpertProduct``, whose backward runs the batched
kernel's transposed forms on the stacks where they lie): one pipeline
(``MODEL_MATMUL_SPEC``), no tuning registry, f32 sums in a K order that
does not depend on how many rows share the call, so a row gets the same
bits at M = 1, 4, 64 or 128 (cuBLAS picks its kernel by the shape, and
with it the order).  On the CPU they stay ``torch.matmul``, the plain
version.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.weak import WeakIdKeyDictionary

from ..core.async_pipeline import PipelineSpec, Strategy
from ..core.config import ArchConfig
from ..distributed.sharding import Param
from ..kernels import matmul as _mm

__all__ = ["pad_to", "padded_heads", "padded_vocab", "linear_init", "linear",
           "MODEL_MATMUL_SPEC", "kernel_product", "kernel_operand",
           "KernelLinear", "kernel_linear",
           "batched_kernel_product", "ExpertProduct", "expert_product",
           "norm_init", "norm", "embed_init", "embed", "rope_tables", "rope",
           "mlp_init",
           "mlp", "MixedDict", "Linear", "Norm", "Embed", "MLP"]


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

#: the one pipeline the model's products run on the card, read from no
#: tuning registry: TMA at ring depth 2, the fastest bf16 and f32 matmul
#: of the kernel table at qwen2-1.5b's widths (PERF.md section 6, row 9)
MODEL_MATMUL_SPEC = PipelineSpec(strategy=Strategy.TMA, depth=2)

#: weight -> {(type, transpose): (its version counter, (K, N) operand
#: padded to the kernel's blocks)}: each operand is made again when the
#: weight changes, and a weight keeps its forward and backward operands
#: side by side
_OPERANDS = WeakIdKeyDictionary()


def _padded(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``t`` (r, c) with zero rows and columns up to (rows, cols)."""
    r, c = t.shape
    return t if (r, c) == (rows, cols) else F.pad(t, (0, cols - c,
                                                      0, rows - r))


def _padded_rows(a: torch.Tensor, cols: int, dtype) -> torch.Tensor:
    """``a`` (M, K) in ``dtype`` with zero rows up to the kernel's 128-row
    tile and zero columns up to ``cols``: the left operand as the matmul
    kernel takes it."""
    return _padded(a.to(dtype), pad_to(max(a.shape[0], 1), _mm.BLOCK), cols)


@torch.no_grad()
def _kept(w: torch.Tensor, key: tuple, make) -> torch.Tensor:
    """``make()``, kept beside ``w`` under ``key`` and made again when
    ``w``'s version counter moves (an in-place write, ``load_state_dict``
    and the optimizer's update included).  A ``make()`` that is ``w``
    itself is not kept (the entry would keep ``w`` alive)."""
    held = _OPERANDS.get(w)
    if held is None:
        held = _OPERANDS[w] = {}
    hit = held.get(key)
    if hit is None or hit[0] != w._version:
        made = make()
        if made is w:
            return made
        hit = held[key] = (w._version, made)
    return hit[1]


def kernel_operand(w: torch.Tensor, dtype: torch.dtype,
                   transpose: bool = False) -> torch.Tensor:
    """The (K, N) operand the matmul kernel reads for weight ``w`` (``w.t()``
    with ``transpose``): in ``dtype``, contiguous, K and N zero-padded to
    multiples of the kernel's 128-wide blocks (zero padding is exact),
    kept beside the weight (``_kept``), so a call casts no weight."""
    def make():
        src = w.t() if transpose else w
        k, n = src.shape
        return _padded(src.to(dtype), pad_to(k, _mm.BLOCK),
                       pad_to(n, _mm.BLOCK)).contiguous()
    return _kept(w, (dtype, transpose), make)


def kernel_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (Kp, Np) -> f32 (M, Np) on the matmul kernel, ``b`` a
    ``kernel_operand`` (Kp >= K, zero rows past K): the rows of ``a``
    zero-padded up to the kernel's 128-row tile and its columns up to Kp,
    the padding rows sliced off.  Each row's sums run in the kernel's own K
    order whatever M is.  A shape or type the kernel refuses raises
    ``ValueError``; there is no other route."""
    m, k = a.shape
    kp = b.shape[0]
    if k > kp:
        raise ValueError(f"kernel_product: {k} columns past the operand's "
                         f"{kp} rows")
    return _mm.matmul_cuda(_padded_rows(a, kp, b.dtype), b,
                           spec=MODEL_MATMUL_SPEC)[:m]


def _blocks(t: torch.Tensor) -> torch.Tensor:
    """``t`` (E, r, c) with zero rows and columns up to multiples of the
    kernel's 128-wide blocks (zero padding is exact)."""
    r, c = t.shape[1:]
    rp, cp = pad_to(max(r, 1), _mm.BLOCK), pad_to(max(c, 1), _mm.BLOCK)
    return t if (r, c) == (rp, cp) else F.pad(t, (0, cp - c, 0, rp - r))


def _batched_kernel(a: torch.Tensor, b: torch.Tensor,
                    **trans: bool) -> torch.Tensor:
    return _mm.matmul_batched_cuda(a, b, spec=MODEL_MATMUL_SPEC, **trans)


def batched_kernel_product(a: torch.Tensor, w: torch.Tensor, *,
                           trans_a: bool = False, trans_b: bool = False,
                           product=None) -> torch.Tensor:
    """a (E, C, K) @ w (E, K, N) -> f32 (E, C, N), product by product, in
    one launch of the batched matmul kernel (``product``: the plain version
    in the CPU tests); with ``trans_a`` a is (E, K, C) and with ``trans_b``
    w is (E, N, K), each read transposed where it lies (the kernel's
    transposed forms).  Each stored operand zero-padded to multiples of
    the kernel's 128-wide blocks (exact), the padding sliced off.  Each
    row's sums run in the 2-D kernel's K order whatever C or E is.  A
    shape or type the kernel refuses raises ``ValueError``."""
    c = a.shape[2] if trans_a else a.shape[1]
    n = w.shape[1] if trans_b else w.shape[2]
    return (product or _batched_kernel)(_blocks(a), _blocks(w),
                                        trans_a=trans_a,
                                        trans_b=trans_b)[:, :c, :n]


def _on_card(x: torch.Tensor) -> bool:
    """Do ``linear``, ``expert_product`` and ``transformer.unembed`` on
    ``x`` take the kernel route (``kernel_linear``, ``ExpertProduct``)?"""
    return x.is_cuda


class KernelLinear(torch.autograd.Function):
    """out = x @ w (``x @ w.t()`` with ``transposed``) -> f32 (M, N), on the
    product ``product`` (``kernel_product`` on the card; the CPU tests pass
    ``kernels.matmul.matmul_plain``) with every operand padded to the
    kernel's blocks: rows of the left operand to 128, the contraction and
    the columns to multiples of 128 with zeros (exact), the padding sliced
    off.  x (M, K) in ``dtype``, the compute type.

    The backward runs the same product on transposed operands:
    dX = dY w^T on ``kernel_operand(w, dtype, transpose=not transposed)``,
    kept beside the weight as the forward's operand is, and dW = X^T dY
    (dY^T X for the transposed weight) with dY as the right operand; dY is
    the gradient of the f32 result in ``dtype`` (exact for the bf16 result
    a ``linear`` rounds to), dX comes back in x's type and dW is rounded to
    ``dtype``, then cast to the weight's type, as the reference's gradient
    of ``w.astype(dtype)`` is."""

    @staticmethod
    def forward(ctx, x, w, dtype, transposed, product):
        op = kernel_operand(w, dtype, transpose=transposed)
        n = w.shape[0] if transposed else w.shape[1]
        out = product(_padded_rows(x, op.shape[0], dtype), op)
        ctx.save_for_backward(x, w)
        ctx.dtype, ctx.transposed, ctx.product = dtype, transposed, product
        return out[:x.shape[0], :n]

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dtype, transposed, product = ctx.dtype, ctx.transposed, ctx.product
        m, k = x.shape
        dy = dy.to(dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            op = kernel_operand(w, dtype, transpose=not transposed)
            dx = product(_padded_rows(dy, op.shape[0], dtype),
                         op)[:m, :k].to(x.dtype)
        if ctx.needs_input_grad[1]:
            mp = pad_to(max(m, 1), _mm.BLOCK)
            # (N, M) @ (M, K) for the transposed weight, else (K, M) @ (M, N)
            a, b = (dy.t(), x) if transposed else (x.t(), dy)
            b = _padded(b.to(dtype), mp, pad_to(b.shape[1], _mm.BLOCK))
            dw = product(_padded_rows(a, mp, dtype), b)[:a.shape[0],
                                                         :w.shape[1]]
            dw = dw.to(dtype).to(w.dtype)
        return dx, dw, None, None, None


def kernel_linear(x: torch.Tensor, w: torch.Tensor, dtype,
                  transposed: bool = False, product=None) -> torch.Tensor:
    """x (M, K) @ w (w.t() with ``transposed``) in ``dtype`` -> f32 (M, N)
    on the matmul kernel, forward and backward (``KernelLinear``)."""
    return KernelLinear.apply(x.to(dtype), w, dtype, transposed,
                              product or kernel_product)


class ExpertProduct(torch.autograd.Function):
    """out = a @ w product by product -> f32 (E, C, N), a (E, C, K) and w
    (E, K, N) in the compute type, on ``batched_kernel_product`` with the
    product ``product`` (the batched launch on the card; the CPU tests
    pass ``kernels.matmul.matmul_batched_plain``), every operand padded to
    the kernel's blocks (exact).

    The backward runs the kernel's transposed forms on the operands where
    they lie: dA = dY w^T on w as stored (``trans_b``) and dW = a^T dY on a
    as stored (``trans_a``), no transposed copy of a stack.  dY is the
    gradient of the f32 result in the compute type (exact for the bf16
    result ``expert_product`` rounds to); dA and dW are rounded to the
    inputs' type, so that the cast before the call hands an f32 master the
    reference's gradient of ``w.astype(bf16)``."""

    @staticmethod
    def forward(ctx, a, w, product):
        ctx.save_for_backward(a, w)
        ctx.product = product
        return batched_kernel_product(a, w, product=product)

    @staticmethod
    def backward(ctx, dy):
        a, w = ctx.saved_tensors
        dy = _blocks(dy.to(a.dtype))
        da = dw = None
        if ctx.needs_input_grad[0]:
            da = batched_kernel_product(dy, w, trans_b=True,
                                        product=ctx.product)
            da = da[:, :a.shape[1]].to(a.dtype)
        if ctx.needs_input_grad[1]:
            dw = batched_kernel_product(a, dy, trans_a=True,
                                        product=ctx.product)
            dw = dw[:, :, :w.shape[2]].to(w.dtype)
        return da, dw, None


def expert_product(a: torch.Tensor, w: torch.Tensor,
                   compute_dtype=torch.bfloat16) -> torch.Tensor:
    """a (E, C, K) @ w (E, K, N) product by product -> (E, C, N) in
    ``compute_dtype`` (f32 sums, the result rounded), the moe family's
    expert products and xlstm's headwise ones.  On the card
    (``_on_card``): in bf16 (the batched launch's one type) one launch
    over the experts, ``ExpertProduct``, under autograd its backward
    too; in f32 the f32 kernel a product (``kernel_linear``, forward and
    backward); elsewhere ``torch.bmm``, the plain version."""
    a, w = a.to(compute_dtype), w.to(compute_dtype)
    if not _on_card(a):
        return torch.bmm(a, w)
    if compute_dtype == torch.float32:
        return torch.stack([kernel_linear(a_, w_, compute_dtype)
                            for a_, w_ in zip(a, w)])
    return ExpertProduct.apply(a, w, None).to(compute_dtype)


def linear(p, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x (..., d_in) @ w in ``compute_dtype`` (f32 sums, the result rounded
    to ``compute_dtype``), plus the bias after.  On the card: the matmul
    kernel (``kernel_linear``) on the cached operand, under autograd its
    backward too."""
    w = p["w"]
    card = _on_card(x)
    if card:
        lead, d_out = x.shape[:-1], w.shape[1]
        out = kernel_linear(x.reshape(-1, x.shape[-1]), w, compute_dtype)
        out = out.to(compute_dtype).reshape(*lead, d_out)
    else:
        out = torch.matmul(x.to(compute_dtype), w.to(compute_dtype))
    if "b" in p:
        b = p["b"]
        # the kept copy carries no gradient: under autograd the bias is
        # cast at the call
        kept = card and not (torch.is_grad_enabled() and b.requires_grad)
        out = out + (_kept(b, (compute_dtype,), lambda: b.to(compute_dtype))
                     if kept else b.to(compute_dtype))
    return out


def norm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm (``bias`` in ``p``) or RMSNorm of x's last axis in f32,
    the result in x's type.  On the card a row's mean (and variance) sums
    in float64, rounded to f32: PyTorch's f32 row mean gives a row other
    bits when another number of rows shares the call (a decode row's
    layernorm at B = 4 against 1 flipped a bf16 value at layer 21 of
    whisper-medium: chip_smoke phase 11 on an NVIDIA H100 80GB HBM3 at
    700 W); float64 sums of f32 values round to one f32 whatever their
    order (``attention._sums``)."""
    xf = x.float()
    acc = xf.double() if x.is_cuda else xf
    if "bias" in p:  # layernorm
        mu = acc.mean(-1, keepdim=True)
        var = (acc - mu).square().mean(-1, keepdim=True).float()
        mu = mu.float()
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:  # rmsnorm
        ms = acc.square().mean(-1, keepdim=True).float()
        out = xf * torch.rsqrt(ms + eps) * p["scale"]
    return out.to(x.dtype)


def embed(p, tokens: torch.Tensor, compute_dtype=torch.bfloat16):
    emb = p["emb"]
    rows = torch.index_select(emb, 0, tokens.reshape(-1))
    return rows.reshape(*tokens.shape, emb.shape[1]).to(compute_dtype)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0):
    """(cos, sin), each (B, S, 1, head_dim), for ``positions`` (B, S) int:
    cos twice, and -sin then sin.  Every layer of a forward (and q and k in
    each) rotates by the same positions, so a forward makes them once and
    passes them to ``rope``."""
    half = head_dim // 2
    freq = torch.pow(theta, -torch.arange(0, half, dtype=torch.float32,
                                          device=positions.device) / half)
    ang = positions[..., None].float() * freq                 # (B, S, half)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    return torch.cat([cos, cos], -1), torch.cat([-sin, sin], -1)


def rope(x: torch.Tensor, tables) -> torch.Tensor:
    """x: (B, S, H, D) rotated by ``tables``, ``rope_tables`` of its
    positions at D.  The reference's [x1 cos - x2 sin, x2 cos + x1 sin] as
    x cos + [x2, x1] [-sin, sin]: the same products and sums (a - b is
    a + (-b) in IEEE arithmetic), in fewer ops."""
    half = x.shape[-1] // 2
    cos, sin = tables
    xf = x.float()
    rot = torch.cat([xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos + rot * sin).to(x.dtype)


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


class MixedDict(nn.ModuleDict):
    """Modules as children and the other leaves as this module's own
    parameters: ``p[name]`` reads either, as the apply functions do, and
    ``state_dict`` paths are the reference's tree paths."""

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        return super().__getitem__(key)


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
