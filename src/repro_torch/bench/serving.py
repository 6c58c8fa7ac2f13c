"""Measure end-to-end serving scenarios (``serve/*``) into schema-v2 rows.

The counterpart of ``repro.bench.serving``.  A serving row is a
``BenchResult`` like any kernel cell, so the same tools read it
(``obs.cli compare``'s noise gate, the reference's ``BenchReport.load``):

  us_median / times_us   median / raw per-step decode latency in µs (the
                         gated quantity: the compare gate keys on
                         ``us_median`` and derives noise from the
                         ``times_us`` IQR)
  tokens_per_s           emitted tokens / measured wall time
  ttft_ms_p50 / p99      time-to-first-token percentiles
  decode_ms_p50 / p99    per-step decode latency percentiles (ms)
  occupancy_mean         mean active-slots / batch over decode steps
  requests / tokens      totals for the measured run
  cache_hit_ratio        prompt rows served from shared blocks (chunked
                         cells), with prefix_hit_tokens / _miss_tokens

Measurement protocol: build the smoke model once on the run's device
(weights from a generator seeded with 0; attention "flash", its head dim
of 8 zero-padded on the card up to one the kernel takes), replay the
trace once as warmup
(building the kernels on first use), then replay it again on fresh
``Request`` objects with a fresh metrics registry.  On the card the row
also carries the torch and CUDA versions and the card's name and power
limit.
"""
from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch

from ..obs import metrics as obs_metrics
from ..obs.trace import get_tracer
from .results import BenchResult, now_iso
from .scenario import ServeScenario

__all__ = ["run_serve_scenario"]


def _trace_requests(w: Dict[str, Any], vocab: int):
    from ..serve import make_trace
    return make_trace(
        w.get("arrival", "uniform"), int(w.get("n_requests", 8)),
        vocab=vocab, rate=float(w.get("rate", 0.5)),
        burst=int(w.get("burst", 4)), seed=int(w.get("seed", 0)),
        prompt_lens=tuple(w.get("prompt_lens", (5, 16))),
        max_new=tuple(w.get("max_new", (4, 8))),
        prefix_len=int(w.get("prefix_len", 0)),
        prefix_group=int(w.get("prefix_group", 0)))


def run_serve_scenario(sc: ServeScenario, opts=None) -> BenchResult:
    """Run one serving scenario (warmup replay + measured replay) on
    ``opts.device`` (the card unless given) and return its result row.
    ``opts`` is a ``runner.RunOptions`` (``device``, ``chip`` and ``emit``
    apply).  With ``check_outputs`` and prefix sharing, the trace is
    replayed unshared too, and a token that differs raises."""
    from ..configs import get_smoke_config
    from ..launch.serve import Request, ServingLoop
    from ..models import build_model
    from ..serve import next_pow2
    from .runner import _card_metrics, require_device

    dev = require_device(opts.device if opts is not None else "cuda")
    w = sc.workload
    cfg = get_smoke_config(w.get("arch", "qwen2-1.5b"))
    model = build_model(cfg, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))

    trace = _trace_requests(w, cfg.vocab)
    # monolithic prefill books max(next_pow2(prompt), prompt + max_new)
    # rows per slot, so the per-slot cap must cover the pow2 bucket of the
    # longest prompt (shared-prefix prompts push past the next boundary)
    max_new_hi = max(max(next_pow2(len(r.prompt)),
                         len(r.prompt) + r.max_new) for r in trace)

    def build_loop(prefix_cache, chunk_tokens=None):
        return ServingLoop(
            model, batch=int(w.get("batch", 2)),
            seed=int(w.get("seed", 0)),
            max_new=max(r.max_new for r in trace),
            scheduler=w.get("scheduler", "continuous"),
            block_len=int(w.get("block_len", 8)),
            max_seq=max_new_hi + int(w.get("block_len", 8)),
            chunk_tokens=(w.get("chunk_tokens") if chunk_tokens is None
                          else chunk_tokens),
            prefix_cache=prefix_cache)

    loop = build_loop(bool(w.get("prefix_cache", False)))

    def replay(requests, lp=None):
        return (lp or loop).run(requests, temperature=0.0)

    def fresh():
        return [Request(uid=r.uid, prompt=r.prompt, max_new=r.max_new,
                        arrival=r.arrival) for r in trace]

    cache = getattr(loop.scheduler, "cache", None)
    with get_tracer().span(f"scenario:{sc.name}",
                           scheduler=w.get("scheduler", "continuous"),
                           arrival=w.get("arrival", "uniform"),
                           n_requests=len(trace), device=str(dev)) as span:
        with get_tracer().span("serve.warmup"):
            replay(fresh())                 # builds every kernel
        if cache is not None and loop.prefix_cache:
            # forget warmup's retained blocks: the measured replay's hit
            # ratio must reflect a cold start, not a pre-seeded cache
            cache.reset_prefix_cache()
        measured = obs_metrics.Registry()
        loop.scheduler.metrics = measured   # fresh counters for the run
        t0 = time.perf_counter()
        results = replay(fresh())
        wall_s = time.perf_counter() - t0

        snap = {row["name"]: row for row in measured.snapshot()}
        dec = snap.get("serve.decode_ms", {})
        ttft = snap.get("serve.ttft_ms", {})
        occ = snap.get("serve.batch_occupancy", {})
        times_us = [v * 1e3 for v in
                    measured.histogram("serve.decode_ms").samples()]
        n_tokens = sum(len(v) for v in results.values())
        metrics: Dict[str, Any] = {
            "us_median": float(np.median(times_us)) if times_us else 0.0,
            "us_mean": dec.get("mean", 0.0) * 1e3,
            "times_us": times_us,
            "tokens_per_s": n_tokens / wall_s if wall_s > 0 else 0.0,
            "wall_s": wall_s,
            "ttft_ms_p50": ttft.get("p50", 0.0),
            "ttft_ms_p99": ttft.get("p99", 0.0),
            "decode_ms_p50": dec.get("p50", 0.0),
            "decode_ms_p99": dec.get("p99", 0.0),
            "occupancy_mean": occ.get("mean", 0.0),
            "requests": snap.get("serve.requests_total", {}).get("value", 0),
            "tokens": n_tokens,
        }
        if loop.chunk_tokens is not None and cache is not None:
            metrics["cache_hit_ratio"] = cache.cache_hit_ratio
            metrics["prefix_hit_tokens"] = cache.hit_tokens
            metrics["prefix_miss_tokens"] = cache.miss_tokens
        if w.get("check_outputs") and loop.prefix_cache:
            # greedy outputs must be bit-identical with sharing disabled:
            # replay the same trace through a fresh non-sharing chunked
            # loop (same chunk settings) and compare token-for-token
            ref_loop = build_loop(False, chunk_tokens=loop.chunk_tokens)
            ref = replay(fresh(), ref_loop)
            equal = (set(ref) == set(results)
                     and all(ref[u] == results[u] for u in ref))
            metrics["outputs_equal"] = bool(equal)
            if not equal:
                diff = [u for u in results
                        if ref.get(u) != results.get(u)]
                raise RuntimeError(
                    f"{sc.name}: prefix sharing changed greedy outputs "
                    f"for requests {diff[:8]}")
        if span is not None:
            span.attrs["us_median"] = metrics["us_median"]
            span.attrs["tokens_per_s"] = metrics["tokens_per_s"]
    if dev.type == "cuda":
        metrics.update(_card_metrics(dev.index or 0))

    from ..core import hardware
    chip = (opts.resolved_chip() if opts is not None
            else hardware.TARGET.name)
    result = BenchResult(
        scenario=sc.name, kernel=sc.kernel, shape=list(sc.shape),
        dtype=cfg.dtype, strategy=loop.scheduler_kind, chip=chip,
        metrics=metrics, config=dict(w, attention=model.attention),
        config_source="scenario",
        trace_id=span.span_id if span is not None else None,
        kind="measured", section=sc.section or "serve", interpret=False,
        backend=dev.type, jax_version="", created_at=now_iso())
    if opts is not None and opts.emit:
        opts.emit(result)
    return result
