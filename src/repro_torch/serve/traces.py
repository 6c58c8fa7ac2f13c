"""Deterministic arrival traces for the serving scenarios.

The counterpart of ``repro.serve.traces``, the same numpy draws in the same
order, so a seed gives the reference's trace.  A trace is a list of
:class:`~repro_torch.serve.scheduler.Request` whose
``arrival`` times are expressed in *virtual scheduler steps* (one prefill
or one batch decode step = 1.0), so the same seed replays the identical
workload on any host speed — the property the ``serve/*`` bench rows and
their CI gate depend on.

Three arrival processes, matching the serving literature's standard trio:

  uniform  requests evenly spaced at ``1 / rate`` steps
  poisson  exponential inter-arrival gaps at mean ``1 / rate``
  bursty   poisson gaps, but arrivals land in bursts of ``burst`` at the
           same instant (doubly-stochastic: stresses admission + queue)

Prompt lengths and per-request ``max_new`` are drawn from closed ranges
so traces exercise the ragged/mixed-length path; ``max_new`` variation is
the proxy for EOS-driven early exit (the smoke models never emit EOS).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .scheduler import Request

__all__ = ["make_trace", "ARRIVALS"]

ARRIVALS = ("uniform", "poisson", "bursty")


def _gaps(kind: str, n: int, rate: float, burst: int,
          rng: np.random.Generator) -> np.ndarray:
    # validate BEFORE the rate shortcut: an unknown kind (or a bad burst)
    # must fail loudly even when rate == 0 would make the gaps trivial
    if kind not in ARRIVALS:
        raise ValueError(f"unknown arrival kind {kind!r} (want one of "
                         f"{ARRIVALS})")
    if rate < 0:
        raise ValueError(f"rate must be >= 0, got {rate}")
    if kind == "bursty" and burst < 1:
        raise ValueError(f"burst must be >= 1, got {burst}")
    if rate == 0:
        # rate 0 = everything arrives at t=0 (the all-at-once workload);
        # no RNG draw, so it is identical across seeds and arrival kinds
        return np.zeros(n)
    if kind == "uniform":
        return np.full(n, 1.0 / rate)
    if kind == "poisson":
        return rng.exponential(1.0 / rate, n)
    # bursty: burst heads draw an exponential gap scaled so the long-run
    # rate still matches; burst members arrive with the head.  burst == 1
    # degenerates to poisson (every request is a head, scale 1/rate).
    gaps = np.zeros(n)
    heads = np.arange(n) % burst == 0
    gaps[heads] = rng.exponential(burst / rate, int(heads.sum()))
    return gaps


def make_trace(kind: str, n_requests: int, *, vocab: int,
               rate: float = 1.0, burst: int = 4, seed: int = 0,
               prompt_lens: Tuple[int, int] = (5, 24),
               max_new: Tuple[int, int] = (8, 40),
               prefix_len: int = 0, prefix_group: int = 0,
               arrival_rng: Optional[np.random.Generator] = None
               ) -> List[Request]:
    """Build ``n_requests`` requests with ``kind`` arrivals at ``rate``
    requests per virtual step.  ``prompt_lens`` / ``max_new`` are closed
    [lo, hi] ranges sampled per request.

    ``prefix_len > 0`` makes this a *shared-prefix* trace: requests are
    grouped in runs of ``prefix_group`` (default: all of them) and every
    request in a group gets the same ``prefix_len`` leading tokens, with
    its own ``prompt_lens``-range tail appended — the workload prefix
    caching exists for (system prompts, few-shot preambles).  With
    ``prefix_len == 0`` (the default) the RNG draw sequence is exactly
    the historical one, so existing traces and baselines replay
    unchanged."""
    if n_requests < 0:
        raise ValueError(f"n_requests must be >= 0, got {n_requests}")
    if prefix_len < 0:
        raise ValueError(f"prefix_len must be >= 0, got {prefix_len}")
    rng = np.random.default_rng(seed)
    # draw request shapes and contents before the arrival gaps so the
    # same seed yields the same prompts under every arrival kind
    lens = rng.integers(prompt_lens[0], prompt_lens[1] + 1, n_requests)
    news = rng.integers(max_new[0], max_new[1] + 1, n_requests)
    prompts = [rng.integers(0, vocab, (int(n),)).astype(np.int32)
               for n in lens]
    if prefix_len > 0 and n_requests > 0:
        group = prefix_group if prefix_group > 0 else n_requests
        n_groups = -(-n_requests // group)
        prefixes = [rng.integers(0, vocab, (prefix_len,)).astype(np.int32)
                    for _ in range(n_groups)]
        prompts = [np.concatenate([prefixes[i // group], prompts[i]])
                   for i in range(n_requests)]
    gaps = _gaps(kind, n_requests, rate, burst, arrival_rng or rng)
    arrivals = np.cumsum(gaps)
    return [Request(uid=i, prompt=prompts[i], max_new=int(news[i]),
                    arrival=float(arrivals[i]))
            for i in range(n_requests)]
