"""AdamW with global-norm clipping, updating the parameters in place.

The counterpart of ``repro.optim.adamw`` (``adamw_init``, ``global_norm``,
``adamw_update``, ``lr_schedule``) with its constants: b1 0.9, b2 0.95,
eps 1e-8, weight decay on every leaf, clipping by the global norm, bias
correction.  Trees are dicts of tensors keyed by parameter name
(``Module.named_parameters()``).

The reference returns new parameters; here ``adamw_update`` writes them in
place under ``torch.no_grad()`` and never rebinds ``.data``.  That is what
keeps the card's products right: ``layers._kept`` makes a weight's cached
kernel operand again only when the weight's ``_version`` moves, which an
in-place write does and a rebinding would not (every product would then
run on the previous step's weights).  The moments are updated in place
too.  ZeRO-1's moment shardings (``zero1_spec``, ``moment_shardings``) wait
for the distributed slice; on one card with no sharding rules the
reference's train step skips them as well.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

__all__ = ["AdamWState", "adamw_init", "global_norm", "adamw_update",
           "lr_schedule"]

Tree = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    #: updates taken so far, an int32 scalar tensor on the CPU
    step: torch.Tensor
    #: first and second moments, f32, keyed as the parameters
    m: Tree
    v: Tree


def adamw_init(params: Tree) -> AdamWState:
    """Zero moments in f32 beside each parameter, step 0."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32,
                                memory_format=torch.contiguous_format)
    return AdamWState(step=torch.zeros((), dtype=torch.int32),
                      m={k: zeros(p) for k, p in params.items()},
                      v={k: zeros(p) for k, p in params.items()})


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over the leaves of their squares, in f32 (a scalar
    tensor on the leaves' device)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tree.values()))


@torch.no_grad()
def adamw_update(grads: Tree, state: AdamWState, params: Tree, *, lr: float,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0
                 ) -> Tuple[AdamWState, torch.Tensor]:
    """One AdamW step: ``params`` and the moments written in place ->
    (the state at step + 1, the gradients' global norm before clipping).
    ``lr`` is the schedule's value for this step (``lr_schedule``)."""
    step = int(state.step) + 1
    gn = global_norm(grads)
    scale = None
    if clip_norm > 0:
        scale = torch.clamp(clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    # the reference's b ** step in f32
    c1 = 1.0 - float(torch.tensor(b1) ** torch.tensor(float(step)))
    c2 = 1.0 - float(torch.tensor(b2) ** torch.tensor(float(step)))
    for name, p in params.items():
        g = grads[name].float()
        if scale is not None:
            g = g * scale
        m, v = state.m[name], state.v[name]
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g.square() * (1 - b2))
        upd = (m / c1) / (torch.sqrt(v / c2) + eps) + weight_decay * p.float()
        p.copy_(p.float() - lr * upd)
    return AdamWState(torch.tensor(step, dtype=torch.int32), state.m,
                      state.v), gn


def lr_schedule(step, *, lr: float, warmup: int, total: int,
                min_ratio: float = 0.1) -> float:
    """Linear warmup then cosine decay to min_ratio * lr, in f32 as the
    reference evaluates it, returned as a float."""
    s = torch.as_tensor(step, dtype=torch.float32)
    warm = lr * s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = lr * (min_ratio + (1 - min_ratio) * 0.5 *
                (1 + torch.cos(math.pi * prog)))
    return float(torch.where(s < warmup, warm, cos))
