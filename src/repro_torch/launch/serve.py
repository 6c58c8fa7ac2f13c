"""Serving entry point: continuous batching over a paged KV cache.

The counterpart of ``repro.launch.serve``.  The scheduling and cache
machinery lives in ``repro_torch.serve``; this module is the launch-layer
entry point.  ``ServingLoop`` picks a scheduler — slot-level continuous
batching (:class:`repro_torch.serve.ContinuousScheduler`) by default,
falling back to the static-cohort loop for a model without a paged decode
path — and the CLI replays deterministic arrival traces (uniform /
poisson / bursty, fixed seeds) against it.  ``ServingLoop`` takes the
port's ``Model`` with its weights inside (the reference: ``cfg, params``).

The helpers (``Request``, ``sample``, ``pack_prompts``,
``mask_padded_cache``, ``build_serve_fns``) are re-exported from
``repro_torch.serve``.

Run as a script it serves the arch's smoke model, on the card unless
``--device cpu`` is given:
    PYTHONPATH=src python -m repro_torch.launch.serve --requests 4
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --requests 4
"""
from __future__ import annotations

import argparse
import logging
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..obs import metrics as obs_metrics
from ..obs.trace import get_tracer
from ..serve import (ARRIVALS, CohortScheduler, ContinuousScheduler,
                     Request, build_serve_fns, make_trace,
                     mask_padded_cache, pack_prompts, sample)

__all__ = ["Request", "ServingLoop", "build_serve_fns", "main",
           "mask_padded_cache", "pack_prompts", "sample"]

log = logging.getLogger("repro_torch.serve")


class ServingLoop:
    """Launch-layer serving facade.

    ``scheduler="continuous"`` (the default) runs slot-level continuous
    batching over a paged KV arena; ``scheduler="cohort"`` runs the
    static-cohort loop.  A model without a paged decode path
    (``model.decode_paged is None``: the reference's ssm / hybrid / encdec)
    falls back to cohort.  Chunked prefill and prefix caching need the
    continuous scheduler and prompts without patch rows (not vlm); they
    are disabled otherwise.

    The scheduler's ``obs.metrics.Registry`` is exposed as
    ``self.metrics`` (a private registry by default, so concurrent loops
    and tests never share counters)."""

    def __init__(self, model, *, batch: int, seed: int = 0,
                 max_new: int = 64,
                 metrics: Optional[obs_metrics.Registry] = None,
                 scheduler: str = "continuous", block_len: int = 16,
                 max_seq: int = 1024, total_tokens: Optional[int] = None,
                 chunk_tokens: Optional[int] = None,
                 prefix_cache: bool = False):
        cfg = model.cfg
        if scheduler not in ("continuous", "cohort"):
            raise ValueError(f"unknown scheduler {scheduler!r}")
        if scheduler == "continuous" and \
                getattr(model, "decode_paged", None) is None:
            log.info("family %s has no paged decode path; falling back to "
                     "cohort scheduling", cfg.family)
            scheduler = "cohort"
        if scheduler != "continuous" and (chunk_tokens or prefix_cache):
            log.info("chunked prefill / prefix caching need the continuous "
                     "scheduler; disabling both")
            chunk_tokens, prefix_cache = None, False
        if (chunk_tokens or prefix_cache) and int(cfg.n_patches or 0) > 0:
            log.info("family %s prepends patch rows during prefill, which "
                     "chunked prefill cannot align; disabling chunked "
                     "prefill / prefix caching", cfg.family)
            chunk_tokens, prefix_cache = None, False
        if scheduler == "continuous":
            self.scheduler = ContinuousScheduler(
                model, batch=batch, seed=seed, max_new=max_new,
                metrics=metrics, block_len=block_len, max_seq=max_seq,
                total_tokens=total_tokens, chunk_tokens=chunk_tokens,
                prefix_cache=prefix_cache)
        else:
            self.scheduler = CohortScheduler(
                model, batch=batch, seed=seed, max_new=max_new,
                metrics=metrics)
        self.cfg = cfg
        self.batch = batch
        self.scheduler_kind = scheduler
        self.chunk_tokens = chunk_tokens
        self.prefix_cache = prefix_cache

    @property
    def metrics(self) -> obs_metrics.Registry:
        return self.scheduler.metrics

    def run(self, requests: List[Request], temperature: float = 0.0,
            max_steps: int = 64) -> Dict[int, List[int]]:
        return self.scheduler.run(requests, temperature=temperature,
                                  max_steps=max_steps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen2-1.5b",
                    help="architecture whose smoke config is served")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: the card (default; exits 2 without one); "
                         "cpu: the kernels' plain versions")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--ragged", action="store_true",
                    help="draw each prompt's length from [4, prompt-len] "
                         "to exercise the ragged/mixed-length path")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--scheduler", default="continuous",
                    choices=["continuous", "cohort"],
                    help="slot-level continuous batching (default) or the "
                         "static-cohort loop")
    ap.add_argument("--block-len", type=int, default=16,
                    help="paged KV cache block length (continuous only)")
    ap.add_argument("--chunk-tokens", type=int, default=None,
                    help="split prefill into chunks of this many tokens "
                         "interleaved with decode steps (continuous only; "
                         "must be a multiple of --block-len)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="content-address full KV blocks and share cached "
                         "prompt prefixes across requests (implies chunked "
                         "prefill at --block-len unless --chunk-tokens is "
                         "given)")
    ap.add_argument("--prefix-len", type=int, default=0,
                    help="shared-prefix traces: give arrival-trace prompts "
                         "a common random prefix of this many tokens")
    ap.add_argument("--prefix-group", type=int, default=0,
                    help="requests per shared prefix group (default: all "
                         "requests share one prefix)")
    ap.add_argument("--arrival", default="none",
                    choices=["none"] + list(ARRIVALS),
                    help="arrival trace: 'none' submits every request at "
                         "t=0; otherwise a deterministic virtual-step "
                         "trace at --rate requests/step")
    ap.add_argument("--rate", type=float, default=0.5,
                    help="arrival rate in requests per virtual step")
    ap.add_argument("--burst", type=int, default=4,
                    help="burst size for --arrival bursty")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed for prompts, arrivals and sampling")
    ap.add_argument("--tuning-registry", default=None,
                    help="autotuning registry JSON (default "
                         "./tuning_registry_torch.json)")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="dump the serving metrics snapshot (obs.metrics) "
                         "to PATH")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="enable span tracing; write the span JSONL to PATH")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device (pass --device cpu to serve on the "
              "CPU)", file=sys.stderr)
        return 2
    from ..tuning import apply_tuned_kernel_defaults
    apply_tuned_kernel_defaults(args.tuning_registry)
    if args.trace:
        get_tracer().enable()

    from ..configs import get_smoke_config
    from ..models import build_model
    cfg = get_smoke_config(args.arch)
    dev = torch.device(args.device)
    log.info("%s on %s", cfg.name, dev)
    model = build_model(cfg, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    loop = ServingLoop(model, batch=args.batch, max_new=args.max_new,
                       seed=args.seed, scheduler=args.scheduler,
                       block_len=args.block_len,
                       max_seq=(args.prompt_len + args.prefix_len
                                + args.max_new + args.block_len),
                       chunk_tokens=args.chunk_tokens,
                       prefix_cache=args.prefix_cache)
    if args.arrival == "none":
        rng = np.random.default_rng(args.seed)
        lens = (rng.integers(4, args.prompt_len + 1, args.requests)
                if args.ragged else [args.prompt_len] * args.requests)
        prefix = (rng.integers(0, cfg.vocab,
                               (args.prefix_len,)).astype(np.int32)
                  if args.prefix_len > 0 else None)
        reqs = []
        for i in range(args.requests):
            p = rng.integers(0, cfg.vocab, (int(lens[i]),)).astype(np.int32)
            if prefix is not None:
                p = np.concatenate([prefix, p])
            reqs.append(Request(uid=i, prompt=p, max_new=args.max_new))
    else:
        lo = 4 if args.ragged else args.prompt_len
        reqs = make_trace(args.arrival, args.requests, vocab=cfg.vocab,
                          rate=args.rate, burst=args.burst, seed=args.seed,
                          prompt_lens=(lo, args.prompt_len),
                          max_new=(args.max_new, args.max_new),
                          prefix_len=args.prefix_len,
                          prefix_group=args.prefix_group)
    t0 = time.time()
    results = loop.run(reqs, max_steps=args.max_new)
    dt = time.time() - t0
    total = sum(len(v) for v in results.values())
    snap = {(r["name"],): r for r in loop.metrics.snapshot()}
    ttft = snap.get(("serve.ttft_ms",), {})
    dec = snap.get(("serve.decode_ms",), {})
    occ = snap.get(("serve.batch_occupancy",), {})
    hit = ""
    cache = getattr(loop.scheduler, "cache", None)
    # the scheduler resolves a default chunk size when only
    # --prefix-cache is passed, so consult it rather than the CLI value
    if getattr(loop.scheduler, "chunk_tokens", None) is not None \
            and cache is not None:
        hit = f"; cache-hit ratio={cache.cache_hit_ratio:.2f}"
    print(f"[{loop.scheduler_kind}] served {len(results)} requests, "
          f"{total} tokens in {dt:.2f}s ({total/dt:.1f} tok/s) on "
          f"{dev.type}; ttft p50={ttft.get('p50', 0):.0f}ms "
          f"p99={ttft.get('p99', 0):.0f}ms; "
          f"decode p50={dec.get('p50', 0):.1f}ms/tok "
          f"p99={dec.get('p99', 0):.1f}ms/tok; "
          f"occupancy mean={occ.get('mean', 0):.2f}{hit}")
    for r in sorted(reqs, key=lambda r: r.uid):
        print(f"  req {r.uid}: prompt={len(r.prompt)} arrival={r.arrival:.1f} "
              f"ttft={r.ttft_ms:.0f}ms total={r.total_ms:.0f}ms "
              f"toks={results[r.uid]}")
    if args.metrics_json:
        loop.metrics.save(args.metrics_json)
        print(f"wrote metrics snapshot to {args.metrics_json}")
    if args.trace:
        n = get_tracer().save_jsonl(args.trace)
        print(f"wrote {n} spans to {args.trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
