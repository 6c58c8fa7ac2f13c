"""Parameter annotation shared by the models (the rest of
``repro.distributed`` is still to port)."""
from .sharding import Param, is_param, split_tree

__all__ = ["Param", "is_param", "split_tree"]
