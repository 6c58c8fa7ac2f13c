"""Model stack of the port: the dense family of ``repro.models`` (the
other families are still to port: ROADMAP queue 1 item 3)."""
from .model import Model, build_model, cross_entropy

__all__ = ["Model", "build_model", "cross_entropy"]
