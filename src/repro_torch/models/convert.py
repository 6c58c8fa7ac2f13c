"""Weights carried across from the reference: the JAX package's parameter
tree (``split_tree(model.init(key))[0]``, as nested numpy arrays, layers
stacked on a leading L axis) into a port Model, so that both compute with
the same weights.  Every leaf maps by its tree path, the moe family's
too: ``moe.router.w``, the expert stacks ``moe.w_gate`` / ``moe.w_up``
(E, d, ff) and ``moe.w_down`` (E, ff, d), ``moe.shared.*.w``."""
from __future__ import annotations

import numpy as np
import torch

from .model import Model
from .transformer import load_tree

__all__ = ["load_reference_params"]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def load_reference_params(model: Model, tree) -> None:
    """Copy the reference's value tree into ``model``: the leading L axis
    of ``layers`` unstacked into the layer list, every leaf to the
    parameter's device and type."""
    tree = _map(lambda a: torch.from_numpy(np.array(a)), tree)
    n_layers = model.cfg.n_layers
    layers = [_map(lambda t: t[i], tree["layers"]) for i in range(n_layers)]
    load_tree(model.net, dict(tree, layers=layers))
