"""Mixture-of-Experts: token-choice top-k routing with a capacity and the
Switch load-balance loss, sort-based dispatch, swiglu experts, and
qwen2-moe's shared experts behind a sigmoid gate.

The counterpart of ``repro.models.moe`` on one card.  The reference's
``moe_apply`` has two branches: the single-device one, and a
``shard_map`` over an expert-parallel mesh when its sharding rules map the
"experts" axis.  The port has no rules (``distributed.sharding``), so
there is no branch to take: ``moe_apply`` is the single-device branch, and
the sharded one waits for the distributed port.

Dtypes step by step, as there: the router's product and softmax in f32
over ``x`` cast to f32; the expert stacks (fp32 masters) cast to the
compute type at each call; the expert products rounded to it; the combine
weights in it; the shared experts' gate computed in f32, then cast.  On
the card every product runs on the matmul kernel: the router and the
gate on the f32 kernel (``linear`` at f32), the shared experts on the
bf16 kernel (``linear``), and each of the three expert products as one
batched launch over the experts (``layers.expert_product``), whose
backward under autograd runs the batched kernel's transposed forms on the
bf16 stacks as the call cast them (``layers.ExpertProduct``); the
dispatch gather and the combine differentiate as they are.  The stacks
keep no cast copy beside them: at qwen2-moe-a2.7b's widths that would be
24.9 GB more than the 80 GB card holds beside the masters.

Capacity makes a token's output depend on the other tokens of its call
(cap = max(ceil(T k / E x capacity_factor), 4) rows an expert, the
assignments past it dropped in token order), as in the reference.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import ArchConfig
from ..distributed.sharding import Param, axis_size
from .layers import (Linear, MixedDict, _empty, expert_product, linear,
                     linear_init)

__all__ = ["moe_init", "padded_experts", "capacity", "moe_apply", "MoE"]


def padded_experts(cfg: ArchConfig) -> int:
    """The expert count padded to the EP degree (qwen2-moe: 60 -> 64 on TP
    = 16); padded experts are masked to -1e30 router logits.  One card: no
    padding."""
    ep = axis_size("experts")
    n = cfg.moe.n_experts
    return ((n + ep - 1) // ep) * ep if ep > 1 else n


def capacity(cfg: ArchConfig, t: int) -> int:
    """Rows an expert takes from a call of ``t`` tokens."""
    e = cfg.moe
    return max(int(math.ceil(t * e.top_k / e.n_experts * e.capacity_factor)),
               4)


def moe_init(generator: torch.Generator, cfg: ArchConfig):
    """The reference's distributions, drawn in its order: the router and
    the gate and up stacks at 1 / sqrt(d), the down stack at 1 / sqrt(ff),
    then the shared experts' gate, up, down and sigmoid gate (linear_init).
    All fp32 whatever ``cfg.param_dtype`` says, as the reference
    hard-codes."""
    d, e = cfg.d_model, cfg.moe
    n_e, ff = padded_experts(cfg), e.d_ff_expert
    dev = generator.device

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=dev) * scale

    scale = 1.0 / math.sqrt(d)
    p = {"router": {"w": Param(normal((d, n_e), scale), ("embed", None))},
         "w_gate": Param(normal((n_e, d, ff), scale),
                         ("experts", "embed", "expert_shard")),
         "w_up": Param(normal((n_e, d, ff), scale),
                       ("experts", "embed", "expert_shard")),
         "w_down": Param(normal((n_e, ff, d), 1.0 / math.sqrt(ff)),
                         ("experts", "expert_shard", "embed"))}
    if e.n_shared > 0:
        ff_shared = e.n_shared * ff
        p["shared"] = {
            "gate": linear_init(generator, d, ff_shared, ("embed", "mlp")),
            "up": linear_init(generator, d, ff_shared, ("embed", "mlp")),
            "down": linear_init(generator, ff_shared, d, ("mlp", "embed")),
            "sgate": linear_init(generator, d, 1, ("embed", None))}
    return p


def _route(x_flat: torch.Tensor, router, cfg: ArchConfig, n_total: int):
    """-> (probs (T, E) f32, top_p (T, k) renormalised, top_ids (T, k)):
    the router's f32 product (the f32 kernel on the card), padded experts
    masked, softmax, top-k."""
    logits = linear(router, x_flat.float(), torch.float32)
    valid = torch.arange(n_total, device=x_flat.device) < cfg.moe.n_experts
    logits = torch.where(valid[None, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_ids = torch.topk(probs, cfg.moe.top_k, dim=-1)
    return probs, top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9), top_ids


def _counts(flat_e: torch.Tensor, n: int) -> torch.Tensor:
    """Assignments an expert, (n,) int64 (``bincount`` without its host
    sync on the card)."""
    return torch.zeros(n, dtype=torch.long, device=flat_e.device) \
        .scatter_add_(0, flat_e, torch.ones_like(flat_e))


def _slots(flat_e: torch.Tensor, cap: int, e_local: int, lo: int):
    """Sort-based dispatch of the T k assignments ``flat_e`` (expert ids in
    token order): each one's place among its expert's (a stable sort, so
    in token order), kept where it is local and under ``cap``.  -> (kept,
    slot): the row of the (e_local cap) dispatch buffer each kept
    assignment lands in, e_local cap (past the buffer) for the others."""
    n = flat_e.shape[0]
    ar = torch.arange(n, device=flat_e.device)
    order = torch.argsort(flat_e, stable=True)
    counts = _counts(flat_e, lo + e_local)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(ar).scatter_(0, order, ar - starts[flat_e[order]])
    kept = (flat_e >= lo) & (flat_e < lo + e_local) & (pos < cap)
    slot = torch.where(kept, (flat_e - lo) * cap + pos, e_local * cap)
    return kept, slot


def _local_moe(x_flat: torch.Tensor, router, w_gate, w_up, w_down, *,
               cfg: ArchConfig, n_experts_total: int, e_local: int, lo: int,
               compute_dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch, compute and combine for the experts [lo, lo + e_local).
    x_flat: (T, d).  -> (partial out (T, d), aux loss scalar)."""
    e = cfg.moe
    t, d = x_flat.shape
    k = e.top_k
    probs, top_p, top_ids = _route(x_flat, router, cfg, n_experts_total)

    # the aux load-balance loss (Switch): E * sum_e f_e * P_e
    flat_e = top_ids.reshape(-1)
    f = _counts(flat_e, n_experts_total).float() / (t * k)
    aux = e.n_experts * torch.sum(f * probs.mean(dim=0))

    # sort-based dispatch with capacity: token ids scattered into the
    # buffer's rows (T past the tokens: the zero row), then one gather
    cap = capacity(cfg, t)
    kept, slot = _slots(flat_e, cap, e_local, lo)
    flat_tok = torch.arange(t * k, device=x_flat.device) // k
    slot_src = torch.full((e_local * cap + 1,), t, dtype=torch.long,
                          device=x_flat.device).scatter_(0, slot, flat_tok)
    x_pad = torch.cat([x_flat.to(compute_dtype),
                       x_flat.new_zeros((1, d), dtype=compute_dtype)])
    buf = x_pad[slot_src[:-1]].reshape(e_local, cap, d)

    # the swiglu experts: one batched product each
    h = F.silu(expert_product(buf, w_gate, compute_dtype)) * \
        expert_product(buf, w_up, compute_dtype)
    y = expert_product(h, w_down, compute_dtype)               # (El, C, d)

    # the combine, over the k assignments in order (a sentinel zero row for
    # the dropped ones)
    y_pad = torch.cat([y.reshape(e_local * cap, d),
                       y.new_zeros((1, d))])
    w_tk = torch.where(kept, top_p.reshape(-1), 0.0).to(
        compute_dtype).reshape(t, k)
    slot_tk = slot.reshape(t, k)
    out = torch.zeros_like(x_flat)
    for j in range(k):
        out = out + y_pad[slot_tk[:, j]] * w_tk[:, j:j + 1]
    return out, aux


def moe_apply(p, x: torch.Tensor, cfg: ArchConfig,
              compute_dtype=torch.bfloat16):
    """x: (B, S, d) -> (out (B, S, d), aux loss scalar f32).  ``p``: any
    mapping with the reference's keys (an ``MoE`` module included)."""
    b, s, d = x.shape
    n_total = p["w_gate"].shape[0]
    out, aux = _local_moe(
        x.reshape(-1, d), p["router"], p["w_gate"].to(compute_dtype),
        p["w_up"].to(compute_dtype), p["w_down"].to(compute_dtype), cfg=cfg,
        n_experts_total=n_total, e_local=n_total, lo=0,
        compute_dtype=compute_dtype)
    out = out.reshape(b, s, d)
    if cfg.moe.n_shared > 0:
        sh = p["shared"]
        hidden = F.silu(linear(sh["gate"], x, compute_dtype)) * \
            linear(sh["up"], x, compute_dtype)
        shared_out = linear(sh["down"], hidden, compute_dtype)
        sgate = torch.sigmoid(linear(sh["sgate"], x, torch.float32))
        out = out + shared_out * sgate.to(compute_dtype)
    return out, aux


class MoE(MixedDict):
    """``router`` and, with shared experts, ``shared`` (``gate``, ``up``,
    ``down``, ``sgate``) as modules, and the stacks ``w_gate``, ``w_up``
    (E, d, ff) and ``w_down`` (E, ff, d) as this module's own parameters:
    ``state_dict`` paths are the reference's tree paths, all fp32.
    ``p["w_gate"]`` reads a stack as the apply functions do."""

    def __init__(self, cfg: ArchConfig, device=None):
        d, e = cfg.d_model, cfg.moe
        n_e, ff = padded_experts(cfg), e.d_ff_expert
        mods = {"router": Linear(d, n_e, device=device)}
        if e.n_shared > 0:
            ff_shared = e.n_shared * ff
            mods["shared"] = nn.ModuleDict({
                "gate": Linear(d, ff_shared, device=device),
                "up": Linear(d, ff_shared, device=device),
                "down": Linear(ff_shared, d, device=device),
                "sgate": Linear(d, 1, device=device)})
        super().__init__(mods)
        self.w_gate = _empty(n_e, d, ff, device=device)
        self.w_up = _empty(n_e, d, ff, device=device)
        self.w_down = _empty(n_e, ff, d, device=device)
        self.cfg = cfg

    def forward(self, x, compute_dtype=torch.bfloat16):
        return moe_apply(self, x, self.cfg, compute_dtype)
