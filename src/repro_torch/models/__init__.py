"""Model stack of the port: the dense, moe, vlm, ssm, hybrid and encdec
families of ``repro.models``."""
from .model import Model, build_model, cross_entropy

__all__ = ["Model", "build_model", "cross_entropy"]
