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

``decode_paged`` is None for the families whose decode state a block arena
cannot hold (ssm, hybrid, encdec), and ``prefill_chunk`` also for a model
with patch rows (vlm), as in the reference: serving falls back on what is
None.

``batch`` is a dict: tokens (B, S) int, labels (B, S) int (-1 = masked);
for vlm, patches (B, P, d): the patch embeddings, prepended to the token
rows (the logits then hold P patch rows first, and the loss pads the
labels with -1 over them); for encdec, frames (B, S, d): the encoder's
stub frame embeddings, as many as tokens (``models.encdec``; the state is
an ``EncDecState``).  The serving calls run without autograd and write
their caches in place.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from ..core.config import ArchConfig
from ..distributed.sharding import split_tree
from . import encdec, layers
from . import transformer as tfm
from .attention import ATTENTION

__all__ = ["Model", "build_model", "cross_entropy", "CARD_TRAINING_WAITS"]

#: the families whose training on the card waits for a later slice, and
#: what each waits for (dense, moe and ssm train there)
CARD_TRAINING_WAITS = {
    "hybrid": "flash attention's per-layer global flag under autograd",
    "vlm": "the vlm and encdec training slice",
    "encdec": "the vlm and encdec training slice",
}


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
    #: the weights: a ``Transformer``, or for encdec an ``encdec.EncDec``
    net: tfm.Transformer
    #: attend_chunked's implementation: "flash" (the kernel) or "chunked"
    attention: str = "flash"
    #: paged decode over a block-arena KV cache: (paged, tokens (B, 1),
    #: block_table (B, MB), slot_pos (B,)) -> (logits (B, Vp), ``paged``
    #: written in place).  None where the decode state is not attention
    #: alone (ssm, hybrid)
    decode_paged: Optional[Callable] = None
    #: one prefill chunk for a single slot over the block arena: (paged,
    #: tokens (1, C), block_table (1, MB), start, n_real) -> (logits (1,
    #: Vp), ``paged`` written in place).  None wherever decode_paged is, and
    #: with patch rows (they cannot be chunk-aligned)
    prefill_chunk: Optional[Callable] = None

    def init(self, generator: torch.Generator) -> None:
        """Draw every weight from ``generator`` (on the model's device) with
        the reference's distributions, one child module at a time (so at
        most one child's weights are held twice)."""
        mod = encdec if self.cfg.is_encdec else tfm
        lists = {name: iter(self.net[name]) for name in mod.LAYER_LISTS
                 if name in self.net}
        for name, tree in mod.init_pieces(generator, self.cfg):
            module = next(lists[name]) if name in lists else self.net[name]
            tfm.load_tree(module, split_tree(tree)[0])

    def _labels(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The labels, padded with -1 over the patch rows (which carry no
        LM loss) where the batch has patches."""
        labels = batch["labels"]
        if batch.get("patches") is not None and self.cfg.n_patches > 0:
            pad = labels.new_full((labels.shape[0], self.cfg.n_patches), -1)
            labels = torch.cat([pad, labels], dim=1)
        return labels

    def _encdec(self, batch: Dict[str, torch.Tensor], mode: str,
                budget: Optional[int] = None):
        """encdec: the frames encoded, then the decoder over the tokens ->
        (hidden (B, S, d), state or None)."""
        encdec.check_lengths(batch["frames"], batch["tokens"])
        enc_out = encdec.encode(self.net, batch["frames"], self.attention)
        return encdec.decoder(self.net, batch["tokens"], enc_out, mode=mode,
                              budget=budget, attention=self.attention)

    def loss(self, batch: Dict[str, torch.Tensor], *, remat: bool = True
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """ce + router_aux_weight x aux (the moe router's load-balance loss
        summed over the layers; 0 for the other families).  ``remat``:
        under autograd each decoder layer's activations are made again in
        the backward pass (``transformer.run_layers``).  On the card under
        autograd the dense, moe and ssm families train: the others raise
        ``ValueError`` before any launch (``CARD_TRAINING_WAITS``)."""
        family = "encdec" if self.cfg.is_encdec else self.cfg.family
        if family in CARD_TRAINING_WAITS and torch.is_grad_enabled() and \
                layers._on_card(batch["tokens"]) and any(
                    p.requires_grad for p in self.net.parameters()):
            raise ValueError(
                f"training the {family} family on the card waits for "
                f"{CARD_TRAINING_WAITS[family]}: its backward pass on the "
                f"kernels is not ported; run Model.loss under "
                f"torch.no_grad() on the card (the dense, moe and ssm "
                f"families train)")
        if self.cfg.is_encdec:
            x, _ = self._encdec(batch, "train")
            logits = tfm.unembed(self.net, x)
            aux = torch.zeros((), device=logits.device)
        else:
            logits, _, aux = tfm.forward(
                self.net, batch["tokens"], patches=batch.get("patches"),
                mode="train", attention=self.attention, with_aux=True,
                remat=remat)
        total, n = cross_entropy(logits, self._labels(batch), self.cfg.vocab)
        ce = total / n.clamp_min(1)
        moe = self.cfg.moe
        aux_w = moe.router_aux_weight if moe.enabled else 0.0
        return ce + aux_w * aux, {"ce": ce, "aux": aux, "tokens": n}

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if self.cfg.is_encdec:
            return tfm.unembed(self.net, self._encdec(batch, "train")[0])
        logits, _ = tfm.forward(self.net, batch["tokens"],
                                patches=batch.get("patches"), mode="train",
                                attention=self.attention)
        return logits

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor],
                budget: Optional[int] = None):
        """Only the last position is unembedded: the reference's logits[:,
        -1] without the (B, S, Vp) logits."""
        if self.cfg.is_encdec:
            x, state = self._encdec(batch, "prefill", budget)
        else:
            x, state = tfm.run_layers(self.net, batch["tokens"],
                                      patches=batch.get("patches"),
                                      mode="prefill", budget=budget,
                                      attention=self.attention)
        return tfm.unembed(self.net, x[:, -1:])[:, -1], state

    @torch.no_grad()
    def decode_step(self, state, tokens: torch.Tensor):
        """tokens: (B, 1) -> (logits (B, Vp), state written in place): a
        ``State``, or for encdec an ``EncDecState``."""
        if self.cfg.is_encdec:
            x, state = encdec.decoder(self.net, tokens, None, mode="decode",
                                      state=state)
            return tfm.unembed(self.net, x)[:, -1], state
        logits, state = tfm.forward(self.net, tokens, mode="decode",
                                    state=state)
        return logits[:, -1], state

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
    unless given; call ``init``).  encdec has neither paged path: serving
    falls back to the cohort scheduler."""
    tfm.check_family(cfg)
    dev = torch.device(device or "cuda")
    net = encdec.EncDec(cfg, dev) if cfg.is_encdec else \
        tfm.Transformer(cfg, dev)
    decode_paged = prefill_chunk = None
    if cfg.family in tfm.PAGED_FAMILIES:
        @torch.no_grad()
        def decode_paged(paged: tfm.PagedState, tokens: torch.Tensor,
                         block_table: torch.Tensor, slot_pos: torch.Tensor):
            return tfm.forward_paged_decode(net, tokens, paged, block_table,
                                            slot_pos)

        if cfg.n_patches == 0:
            @torch.no_grad()
            def prefill_chunk(paged: tfm.PagedState, tokens: torch.Tensor,
                              block_table: torch.Tensor, start: int,
                              n_real: int):
                return tfm.forward_paged_chunk(net, tokens, paged,
                                               block_table, start, n_real)

    return Model(cfg=cfg, net=net, attention=_check(attention),
                 decode_paged=decode_paged, prefill_chunk=prefill_chunk)
