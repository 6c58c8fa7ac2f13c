"""Param annotation: initializers return ``Param(value, logical_axes)``
leaves; ``split_tree`` splits such a tree into (values, axes).

The part of ``repro.distributed.sharding`` the models use
(``Param``, ``is_param``, ``split_tree``, ``axis_size``).  The port runs on
one card, so the logical-axis rules and the mesh are not ported: outside
the reference's rules context every logical axis has size 1
(``axis_size``), and the models take their single-device branches.  The
axes stay on each parameter for the sharded port to read.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

__all__ = ["Param", "is_param", "split_tree", "axis_size"]


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


def axis_size(name: str) -> int:
    """Devices the logical axis ``name`` is split over: 1 for every axis on
    one card (the reference's ``axis_size`` with no rules in force), so
    the moe family's experts pad to no EP degree."""
    return 1
