"""Pipeline spec (host side of the five copy strategies) and chip catalog."""
from . import async_pipeline, hardware                      # noqa: F401
from .async_pipeline import (ALL_STRATEGIES, PipelineSpec, SmemBudget,
                             Strategy, as_spec, parse_strategy, smem_budget)

__all__ = ["ALL_STRATEGIES", "PipelineSpec", "SmemBudget", "Strategy",
           "as_spec", "async_pipeline", "hardware", "parse_strategy",
           "smem_budget"]
