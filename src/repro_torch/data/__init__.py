"""The trainer's data (``repro.data``'s counterpart)."""
from .pipeline import Prefetcher, synth_batch

__all__ = ["Prefetcher", "synth_batch"]
