"""Param annotation: initializers return ``Param(value, logical_axes)``
leaves; ``split_tree`` splits such a tree into (values, axes).

The part of ``repro.distributed.sharding`` the models use
(``Param``, ``is_param``, ``split_tree``).  The port runs on one card, so
the logical-axis rules and the mesh are not ported; the axes stay on each
parameter for the sharded port to read.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

__all__ = ["Param", "is_param", "split_tree"]


class Param(NamedTuple):
    value: torch.Tensor
    axes: Tuple[Optional[str], ...]


def is_param(x) -> bool:
    return isinstance(x, Param)


def _map(fn: Callable[[Param], Any], tree):
    """``fn`` over the Param leaves of nested dicts, lists and tuples."""
    if is_param(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    raise TypeError(f"a parameter tree holds Param leaves, not "
                    f"{type(tree).__name__}")


def split_tree(tree):
    """-> (value_tree, axes_tree)."""
    return _map(lambda p: p.value, tree), _map(lambda p: p.axes, tree)
