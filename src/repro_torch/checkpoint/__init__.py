"""The trainer's checkpoints (``repro.checkpoint``'s counterpart)."""
from .checkpoint import Checkpointer

__all__ = ["Checkpointer"]
