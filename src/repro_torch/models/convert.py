"""Weights carried across from the reference: the JAX package's parameter
tree (``split_tree(model.init(key))[0]``, as nested numpy arrays, layers
stacked on a leading axis) into a port Model, so that both compute with
the same weights.  Every leaf maps by its tree path: the moe family's
``moe.router.w``, expert stacks ``moe.w_gate`` / ``moe.w_up`` (E, d, ff)
and ``moe.w_down`` (E, ff, d) and ``moe.shared.*.w``; vlm's
``patch_proj.w``; ssm's ``layers`` (stacked over its n_m mLSTM layers:
``ln``, ``mlstm.*``) and ``slstm_layers`` (over its n_s sLSTM layers:
``ln_s``, ``slstm.*``); hybrid's ``mamba.*``; encdec's ``enc_layers`` and
``dec_layers`` (each stacked over its layers), ``ln_enc``, ``ln_f``,
``embed`` and ``unembed``."""
from __future__ import annotations

import numpy as np
import torch

from . import encdec
from .model import Model
from .transformer import LAYER_LISTS, load_tree

__all__ = ["load_reference_params"]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _unstack(tree):
    """A tree stacked on a leading axis -> a list of trees, one a layer."""
    n = next(_leaves(tree)).shape[0]
    return [_map(lambda t: t[i], tree) for i in range(n)]


def load_reference_params(model: Model, tree) -> None:
    """Copy the reference's value tree into ``model``: the leading axis of
    each stacked list (``layers``, ``slstm_layers``, ``enc_layers``,
    ``dec_layers``) unstacked into the layer list, every leaf to the
    parameter's device and type.  Every leaf must be used and every
    parameter given (``load_tree`` is strict)."""
    tree = _map(lambda a: torch.from_numpy(np.array(a)), tree)
    stacks = LAYER_LISTS + encdec.LAYER_LISTS
    load_tree(model.net, {k: _unstack(v) if k in stacks else v
                          for k, v in tree.items()})
