"""Public model API: ``build_model(cfg) -> Model``.

The counterpart of ``repro.models.model``.  The reference's Model is a
namespace of pure functions over a parameter pytree; here a ``Model`` holds
its ``Transformer`` module (the weights) and the attention implementation
its prefill and forward passes run (``"flash"``, the kernel, by default):

  init(generator)                            fill the weights
  loss(batch)                                -> (scalar loss, metrics)
  forward(batch)                             -> logits (B, S, Vp) fp32
  prefill(batch, budget=None)                -> (last-token logits, State)
  decode_step(state, tokens)                 -> (logits, State)
  decode_paged(paged, tokens, table, pos)    -> (logits, PagedState)
  prefill_chunk(paged, tokens, table, start, n_real) -> (logits, PagedState)

``batch`` is a dict: tokens (B, S) int, labels (B, S) int (-1 = masked).
The serving calls run without autograd and write their caches in place.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..core.config import ArchConfig
from ..distributed.sharding import split_tree
from . import transformer as tfm
from .attention import ATTENTION

__all__ = ["Model", "build_model", "cross_entropy"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab: int):
    """logits: (B,S,Vp) fp32; labels: (B,S) with -1 masked.
    Returns (sum_loss, n_tokens)."""
    lmax = logits.amax(-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits - lmax).sum(-1)) + lmax[..., 0]
    lbl = torch.gather(logits, -1, labels.clamp_min(0).long()[..., None])
    mask = (labels >= 0) & (labels < vocab)
    losses = torch.where(mask, lse - lbl[..., 0], 0.0)
    return losses.sum(), mask.sum()


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    net: tfm.Transformer
    #: attend_chunked's implementation: "flash" (the kernel) or "chunked"
    attention: str = "flash"

    def init(self, generator: torch.Generator) -> None:
        """Draw every weight from ``generator`` (on the model's device) with
        the reference's distributions, one child module at a time (so at
        most one child's weights are held twice)."""
        layers = iter(self.net["layers"])
        for name, tree in tfm.init_pieces(generator, self.cfg):
            module = next(layers) if name == "layers" else self.net[name]
            tfm.load_tree(module, split_tree(tree)[0])

    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits = self.forward(batch)
        total, n = cross_entropy(logits, batch["labels"], self.cfg.vocab)
        ce = total / n.clamp_min(1)
        return ce, {"ce": ce, "aux": torch.zeros((), device=ce.device),
                    "tokens": n}

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        logits, _ = tfm.forward(self.net, batch["tokens"], mode="train",
                                attention=self.attention)
        return logits

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor],
                budget: Optional[int] = None):
        """Only the last position is unembedded: the reference's logits[:,
        -1] without the (B, S, Vp) logits."""
        x, state = tfm.run_layers(self.net, batch["tokens"], mode="prefill",
                                  budget=budget, attention=self.attention)
        return tfm.unembed(self.net, x[:, -1:])[:, -1], state

    @torch.no_grad()
    def decode_step(self, state: tfm.State, tokens: torch.Tensor):
        """tokens: (B, 1) -> (logits (B, Vp), state written in place)."""
        logits, state = tfm.forward(self.net, tokens, mode="decode",
                                    state=state)
        return logits[:, -1], state

    @torch.no_grad()
    def decode_paged(self, paged: tfm.PagedState, tokens: torch.Tensor,
                     block_table: torch.Tensor, slot_pos: torch.Tensor):
        """tokens: (B, 1); block_table: (B, MB); slot_pos: (B,) ->
        (logits (B, Vp), ``paged`` written in place)."""
        return tfm.forward_paged_decode(self.net, tokens, paged, block_table,
                                        slot_pos)

    @torch.no_grad()
    def prefill_chunk(self, paged: tfm.PagedState, tokens: torch.Tensor,
                      block_table: torch.Tensor, start: int, n_real: int):
        """tokens: (1, C); block_table: (1, MB) -> (logits (1, Vp),
        ``paged`` written in place)."""
        return tfm.forward_paged_chunk(self.net, tokens, paged, block_table,
                                       start, n_real)

    def with_attention(self, attention: str) -> "Model":
        """The same weights under another attend_chunked implementation."""
        return dataclasses.replace(self, attention=_check(attention))


def _check(attention: str) -> str:
    if attention not in ATTENTION:
        raise ValueError(f"attention {attention!r} is not one of {ATTENTION}")
    return attention


def build_model(cfg: ArchConfig, *, attention: str = "flash",
                device=None) -> Model:
    """A Model of ``cfg`` with uninitialised weights on ``device`` (CUDA
    unless given; call ``init``).  Families the port does not run yet raise
    ``NotImplementedError``."""
    tfm.check_family(cfg)
    net = tfm.Transformer(cfg, torch.device(device or "cuda"))
    return Model(cfg=cfg, net=net, attention=_check(attention))
