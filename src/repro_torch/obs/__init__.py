"""Observability for the port: span tracing (a copy of ``repro.obs.trace``)."""
from . import trace                                         # noqa: F401

__all__ = ["trace"]
