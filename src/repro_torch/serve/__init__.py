"""Continuous-batching serving: paged KV cache + schedulers.

The counterpart of ``repro.serve``, with its exports.  The launch-layer
entry point (CLI + ``ServingLoop``) lives in ``repro_torch.launch.serve``;
the bench scenario family in ``repro_torch.bench.serving``.
"""
from .cache import PagedKVCache, block_hashes, next_pow2
from .scheduler import (CohortScheduler, ContinuousScheduler, Request,
                        build_serve_fns, mask_padded_cache, pack_prompts,
                        request_generator, sample)
from .traces import ARRIVALS, make_trace

__all__ = [
    "PagedKVCache", "block_hashes", "next_pow2",
    "CohortScheduler", "ContinuousScheduler", "Request",
    "build_serve_fns", "mask_padded_cache", "pack_prompts",
    "request_generator", "sample",
    "ARRIVALS", "make_trace",
]
