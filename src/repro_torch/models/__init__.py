"""Model stack of the port: the dense, moe, vlm, ssm and hybrid families of
``repro.models`` (encdec is still to port: ROADMAP queue 1 item 3)."""
from .model import Model, build_model, cross_entropy

__all__ = ["Model", "build_model", "cross_entropy"]
