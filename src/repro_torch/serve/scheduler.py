"""Slot-level continuous batching and the legacy static-cohort scheduler.

The counterpart of ``repro.serve.scheduler``.  Where the reference takes
``(cfg, params)`` and builds and jits the model itself, these take the
port's :class:`~repro_torch.models.Model` with its weights inside and call
its entry points eagerly (there is no jit and no sharding, so ``rules`` is
gone).  Sampling at temperature > 0 cannot copy the reference, whose
per-request keys come from ``jax.random.fold_in``: here each request draws
from its own ``torch.Generator`` seeded from ``(seed, uid)``, once a step,
so sampled tokens do not depend on scheduling but are not the reference's
tokens.  Greedy decoding is the parity contract.

``ContinuousScheduler`` keeps a fixed number of batch *slots* decoding in
one step over a shared :class:`~repro_torch.serve.cache.PagedKVCache`
arena.  A finished slot is freed and refilled from the arrival queue on
the very next step, so short requests never hold the batch hostage the
way cohort scheduling does — occupancy stays near 1 under mixed-length
traffic, which is where the tokens/s win comes from.

Prefill runs one request at a time at ``B=1`` with the request's *exact*
token length (no left padding), then scatters the dense cache into the
slot's arena blocks.  Exact-length prefill makes every request's greedy
output bit-identical to a one-request-at-a-time oracle regardless of
arrival order, batch size, or what else shares the batch — the property
the serving tests pin (on the card it rests on the model's row-invariant
products: ``models.layers.kernel_product``, ``attention._sums``).  The KV
budget is bucketed to the next power of two (whole blocks).

``CohortScheduler`` is the old ``ServingLoop`` body behind the same
interface: take up to ``batch`` arrived requests, left-pad, prefill,
decode the cohort in lockstep until all members finish, repeat.  It
exists as the measured baseline the ``serve/*`` bench scenarios compare
against; its prefill KV budget is bucketed to the next power of two.

Time is *virtual*: arrivals are expressed in scheduler steps (one prefill
or one batch-decode step advances the clock by 1), so a trace replays
identically on any host speed.  Wall-clock is only used for the latency
metrics themselves (TTFT, decode ms).

Both schedulers report the reference's ``obs.metrics`` names:

  serve.ttft_ms           histogram, per request (arrival -> first token)
  serve.decode_ms         histogram, per decode step (per-token latency)
  serve.batch_occupancy   histogram, active/batch per decode step
                          (per cohort prefill for CohortScheduler)
  serve.queue_depth       gauge, arrived requests not yet in a slot
  serve.requests_total    counter
  serve.tokens_total      counter
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..obs import metrics as obs_metrics
from ..obs.trace import get_tracer
from .cache import PagedKVCache, next_pow2, scatter_prefill

__all__ = ["Request", "sample", "request_generator", "pack_prompts",
           "mask_padded_cache", "build_serve_fns", "ContinuousScheduler",
           "CohortScheduler"]


@dataclass
class Request:
    uid: int
    prompt: np.ndarray
    max_new: int
    arrival: float = 0.0                # virtual-step arrival time
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False
    # filled in by the scheduler ----------------------------------------------
    ttft_ms: Optional[float] = None     # arrival -> first token (incl.
    #                                     queue wait)
    total_ms: Optional[float] = None    # arrival -> request finished


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
           temperature: float = 0.0) -> torch.Tensor:
    """Greedy argmax at ``temperature`` <= 0, else one draw a row from
    softmax(logits / temperature) on ``generator``."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0]


def request_generator(seed: int, uid: int, device) -> torch.Generator:
    """Request ``uid``'s own sampling stream, seeded from ``(seed, uid)``
    (the reference folds ``uid`` into its key): independent of scheduling
    order, so sampled outputs do not change when the batch does."""
    s = np.random.SeedSequence([int(seed), int(uid)]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s))


def pack_prompts(active: List[Request], batch: int):
    """LEFT-pad ragged prompts into one (batch, max_len) int32 array.
    Returns (tokens, pads) where ``pads[i]`` is request i's pad count."""
    max_len = max(len(r.prompt) for r in active)
    tokens = np.zeros((batch, max_len), np.int32)
    pads = np.zeros((batch,), np.int32)
    for i, r in enumerate(active):
        p = np.asarray(r.prompt, np.int32).reshape(-1)
        pads[i] = max_len - len(p)
        tokens[i, pads[i]:] = p
    return tokens, pads


def mask_padded_cache(state, pads: np.ndarray):
    """Rewrite the pad slots' cached positions to -1 so ``attend_decode``
    (which masks ``pos_cache < 0`` as empty) never attends them."""
    kpos = getattr(state, "kpos", None)
    if kpos is None or not np.any(pads):
        return state
    slot = torch.arange(kpos.shape[-1], dtype=torch.int32,
                        device=kpos.device)
    pad_col = torch.as_tensor(np.asarray(pads, np.int32),
                              device=kpos.device)[None, :, None]
    masked = torch.where(slot[None, None, :] < pad_col, -1, kpos)
    return state._replace(kpos=masked)


def build_serve_fns(model, budget=None):
    """(prefill(batch), decode_step(state, tokens)): the model's entry
    points at a fixed KV ``budget`` (the reference jits these)."""
    def prefill(batch):
        return model.prefill(batch, budget=budget)

    def decode_step(state, tokens):
        return model.decode_step(state, tokens)

    return prefill, decode_step


def _device(model) -> torch.device:
    return next(model.net.parameters()).device


class _Sampler:
    """Tokens from logits: greedy, or a draw on each request's own
    ``request_generator`` (made at its first draw)."""

    def __init__(self, seed: int, device, temperature: float):
        self.seed, self.device, self.temperature = seed, device, temperature
        self._gens: Dict[int, torch.Generator] = {}

    def rows(self, logits: torch.Tensor, uids: Dict[int, int]
             ) -> Dict[int, int]:
        """{row: token} for the rows of ``uids`` ({row: request uid})."""
        if self.temperature <= 0:
            toks = torch.argmax(logits, dim=-1).tolist()
            return {i: int(toks[i]) for i in uids}
        out = {}
        for i, uid in uids.items():
            g = self._gens.get(uid)
            if g is None:
                g = self._gens[uid] = request_generator(self.seed, uid,
                                                        self.device)
            out[i] = int(sample(logits[i:i + 1], g, self.temperature)[0])
        return out


class _SchedulerBase:
    """Shared construction + metrics wiring for both schedulers."""

    def __init__(self, model, *, batch: int, seed: int = 0,
                 max_new: int = 64,
                 metrics: Optional[obs_metrics.Registry] = None):
        self.model = model
        self.cfg = model.cfg
        self.batch = batch
        self.max_new = max_new
        self.seed = seed
        self.device = _device(model)
        self.metrics = metrics if metrics is not None \
            else obs_metrics.Registry()

    def _metric_handles(self):
        m = self.metrics
        return (m.histogram("serve.ttft_ms"), m.histogram("serve.decode_ms"),
                m.histogram("serve.batch_occupancy"),
                m.gauge("serve.queue_depth"),
                m.counter("serve.requests_total"),
                m.counter("serve.tokens_total"))

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)


class _Slot:
    """One occupied batch slot of the continuous scheduler."""

    __slots__ = ("req", "pos", "target", "t_arrive", "plen", "filled",
                 "prefilling", "started")

    def __init__(self, req: Request, pos: int, target: int, t_arrive: float,
                 plen: int = 0, filled: int = 0, prefilling: bool = False):
        self.req = req
        self.pos = pos          # next cache row this slot writes
        self.target = target    # tokens to emit (min(max_new, max_steps))
        self.t_arrive = t_arrive
        # chunked-prefill progress (unused by the monolithic path)
        self.plen = plen        # prompt rows this slot must prefill
        self.filled = filled    # prompt rows written so far (chunk-aligned)
        self.prefilling = prefilling
        self.started = False    # True once the first chunk dispatched


class ContinuousScheduler(_SchedulerBase):
    """Slot-level continuous batching over a paged KV arena.

    ``total_tokens`` sets the arena budget (default: enough for every
    slot to hold ``max_seq`` rows); ``max_seq`` bounds one request's
    prompt + generation; ``max_prefills_per_step`` caps how many arrivals
    are admitted between decode steps (default: the batch size).

    ``chunk_tokens`` switches prefill from one monolithic exact-length
    call to fixed-size chunks interleaved with decode steps (one chunk,
    then one decode step, per scheduler step), bounding how long a queued
    long prompt can stall decoders.  Chunk boundaries are *absolute* row
    multiples of ``chunk_tokens`` and every chunk runs ``attend_prefix``'s
    full masked softmax, so greedy outputs stay bit-identical to a chunked
    solo oracle regardless of arrival order, batch mix, or prefix sharing
    (they are NOT bit-comparable to the monolithic path, whose flash
    kernel sums its softmax in another order).  ``prefix_cache``
    additionally content-addresses finished full blocks and admits new
    prompts by mapping their longest cached prefix — implies chunked
    prefill (default ``block_len`` — the finest legal chunk, so as much of
    a shared prefix as possible lands on a match boundary) because shared
    rows must end on an absolute chunk boundary."""

    def __init__(self, model, *, batch: int, seed: int = 0,
                 max_new: int = 64,
                 metrics: Optional[obs_metrics.Registry] = None,
                 block_len: int = 16, max_seq: int = 1024,
                 total_tokens: Optional[int] = None,
                 max_prefills_per_step: Optional[int] = None,
                 chunk_tokens: Optional[int] = None,
                 prefix_cache: bool = False):
        super().__init__(model, batch=batch, seed=seed, max_new=max_new,
                         metrics=metrics)
        cfg = self.cfg
        if getattr(model, "decode_paged", None) is None:
            raise ValueError(
                f"family {cfg.family!r} has no paged decode path; use "
                "CohortScheduler")
        self.block_len = block_len
        self.max_seq = max_seq
        if prefix_cache and chunk_tokens is None:
            # finest legal chunk: match length is capped to chunk
            # multiples, so coarser defaults silently shrink sharing
            chunk_tokens = block_len
        if chunk_tokens is not None:
            if chunk_tokens < block_len or chunk_tokens % block_len:
                raise ValueError(
                    f"chunk_tokens {chunk_tokens} must be a positive "
                    f"multiple of block_len {block_len}")
            if int(cfg.n_patches or 0) > 0:
                raise ValueError(
                    "chunked prefill does not support vlm prompts (patch "
                    "rows cannot be chunk-aligned); use the monolithic "
                    "path")
        self.chunk_tokens = chunk_tokens
        self.prefix_cache = bool(prefix_cache)
        if total_tokens is None:
            total_tokens = batch * max_seq
        self.cache = PagedKVCache(cfg, batch, total_tokens=total_tokens,
                                  max_seq=max_seq, block_len=block_len,
                                  prefix_cache=self.prefix_cache,
                                  device=self.device)
        self.max_prefills_per_step = (batch if max_prefills_per_step is None
                                      else max_prefills_per_step)
        # vlm prompts prepend n_patches rows to the cache during prefill
        self._extra_rows = int(cfg.n_patches or 0)

    # -- helpers ------------------------------------------------------------

    def _bucket(self, prompt_len: int) -> int:
        """KV budget for one prefill: next power of two, whole blocks."""
        b = max(next_pow2(max(prompt_len, 1)), self.block_len)
        bl = self.block_len
        return -(-b // bl) * bl

    def _prefill_write(self, prompt: np.ndarray, bucket: int, ids):
        """Exact-length B = 1 prefill at KV budget ``bucket``, its dense
        cache scattered into blocks ``ids`` of the arena, in place.
        Returns the last token's logits (1, Vp)."""
        logits, dense = self.model.prefill(self._prefill_batch(prompt),
                                           budget=bucket)
        scatter_prefill(self.cache.state, dense.k, dense.v,
                        dense.kpos[0, 0],
                        self._tensor(np.asarray(ids, np.int64)))
        return logits

    def _decode(self, tokens: np.ndarray, tables: torch.Tensor,
                slot_pos: np.ndarray) -> torch.Tensor:
        """One decode call over all ``batch`` slots -> logits (batch, Vp)."""
        logits, self.cache.state = self.model.decode_paged(
            self.cache.state, self._tensor(tokens), tables,
            self._tensor(slot_pos))
        return logits

    def _prefill_batch(self, prompt: np.ndarray):
        batch = {"tokens": self._tensor(
            np.asarray(prompt, np.int32).reshape(1, -1))}
        if self.cfg.n_patches:
            batch["patches"] = torch.zeros(
                (1, self.cfg.n_patches, self.cfg.d_model),
                device=self.device)
        return batch

    # -- main loop ----------------------------------------------------------

    def run(self, requests: List[Request], temperature: float = 0.0,
            max_steps: int = 64) -> Dict[int, List[int]]:
        if self.chunk_tokens is not None:
            return self._run_chunked(requests, temperature, max_steps)
        tracer = get_tracer()
        ttft_h, dec_h, occ_h, qdepth, req_c, tok_c = self._metric_handles()
        sampler = _Sampler(self.seed, self.device, temperature)

        pending = deque(sorted(requests, key=lambda r: (r.arrival, r.uid)))
        queue: deque = deque()          # arrived, waiting for a slot
        arrive_wall: Dict[int, float] = {}
        slots: List[Optional[_Slot]] = [None] * self.batch
        results: Dict[int, List[int]] = {}
        clock = 0.0                     # virtual steps

        def finish(i: int):
            s = slots[i]
            s.req.done = True
            s.req.total_ms = (time.perf_counter() - s.t_arrive) * 1e3
            results[s.req.uid] = s.req.out_tokens
            req_c.inc()
            tok_c.inc(len(s.req.out_tokens))
            self.cache.free_slot(i)
            slots[i] = None

        while pending or queue or any(s is not None for s in slots):
            # arrivals: pending -> queue once the virtual clock reaches them
            now = time.perf_counter()
            while pending and pending[0].arrival <= clock:
                r = pending.popleft()
                queue.append(r)
                arrive_wall[r.uid] = now
            qdepth.set(len(queue))

            # admission: refill free slots while the arena has room
            n_pref = 0
            while queue and n_pref < self.max_prefills_per_step:
                free = [i for i, s in enumerate(slots) if s is None]
                if not free:
                    break
                r = queue[0]
                target = min(r.max_new, max_steps)
                plen = len(r.prompt) + self._extra_rows
                bucket = self._bucket(plen)
                lifetime = max(bucket, plen + target)
                if not self.cache.can_admit(lifetime):
                    if not any(s is not None for s in slots):
                        raise RuntimeError(
                            f"request {r.uid} (lifetime {lifetime} tokens) "
                            f"cannot fit the arena even when idle")
                    break               # wait for a slot to free blocks
                queue.popleft()
                i = free[0]
                with tracer.span("serve.prefill", uid=r.uid,
                                 prompt_len=len(r.prompt), bucket=bucket):
                    ids = self.cache.admit(i, bucket, lifetime)
                    logits = self._prefill_write(r.prompt, bucket, ids)
                    tok = sampler.rows(logits, {0: r.uid})[0]
                t_first = time.perf_counter()
                r.ttft_ms = (t_first - arrive_wall[r.uid]) * 1e3
                ttft_h.observe(r.ttft_ms)
                r.out_tokens.append(tok)
                slots[i] = _Slot(r, pos=plen, target=target,
                                 t_arrive=arrive_wall[r.uid])
                if len(r.out_tokens) >= target:
                    finish(i)
                n_pref += 1
                clock += 1.0
                now = time.perf_counter()
                while pending and pending[0].arrival <= clock:
                    rr = pending.popleft()
                    queue.append(rr)
                    arrive_wall[rr.uid] = now
                qdepth.set(len(queue))

            active = [i for i, s in enumerate(slots) if s is not None]
            if not active:
                if pending:
                    # idle: jump the virtual clock to the next arrival
                    clock = max(clock, pending[0].arrival)
                    continue
                if queue:
                    continue            # admission will retry (or raise)
                break

            # one decode step over every slot (inactive slots write the
            # scratch block and their logits are discarded)
            occ_h.observe(len(active) / self.batch)
            tokens = np.zeros((self.batch, 1), np.int32)
            slot_pos = np.zeros((self.batch,), np.int32)
            for i in active:
                s = slots[i]
                tokens[i, 0] = s.req.out_tokens[-1]
                slot_pos[i] = s.pos
                self.cache.append(i, s.pos)
            t0 = time.perf_counter()
            with tracer.span("serve.decode_step", n_active=len(active),
                             queued=len(queue)):
                logits = self._decode(tokens, self.cache.device_tables(),
                                      slot_pos)
                toks = sampler.rows(logits, {i: slots[i].req.uid
                                             for i in active})
            dec_h.observe((time.perf_counter() - t0) * 1e3)
            clock += 1.0
            for i in active:
                s = slots[i]
                s.pos += 1
                s.req.out_tokens.append(toks[i])
                if len(s.req.out_tokens) >= s.target:
                    finish(i)
        qdepth.set(0)
        return results

    def _run_chunked(self, requests: List[Request], temperature: float,
                     max_steps: int) -> Dict[int, List[int]]:
        """Chunked-prefill loop: admission only reserves arena blocks
        (and maps any shared prefix); each scheduler step then runs one
        prefill chunk for the oldest mid-prefill slot, followed by one
        decode step over the fully-prefilled slots.  Mid-prefill slots are
        masked out of the decode call's block table so the inactive-row
        scratch write can never land in their (possibly shared) blocks."""
        tracer = get_tracer()
        ttft_h, dec_h, occ_h, qdepth, req_c, tok_c = self._metric_handles()
        hit_c = self.metrics.counter("serve.prefix_hit_tokens")
        miss_c = self.metrics.counter("serve.prefix_miss_tokens")
        sampler = _Sampler(self.seed, self.device, temperature)
        T = self.chunk_tokens

        pending = deque(sorted(requests, key=lambda r: (r.arrival, r.uid)))
        queue: deque = deque()          # arrived, waiting for a slot
        arrive_wall: Dict[int, float] = {}
        slots: List[Optional[_Slot]] = [None] * self.batch
        results: Dict[int, List[int]] = {}
        clock = 0.0                     # virtual steps

        def finish(i: int):
            s = slots[i]
            s.req.done = True
            s.req.total_ms = (time.perf_counter() - s.t_arrive) * 1e3
            results[s.req.uid] = s.req.out_tokens
            req_c.inc()
            tok_c.inc(len(s.req.out_tokens))
            self.cache.free_slot(i)
            slots[i] = None

        def drain_arrivals():
            now = time.perf_counter()
            while pending and pending[0].arrival <= clock:
                r = pending.popleft()
                queue.append(r)
                arrive_wall[r.uid] = now
            qdepth.set(len(queue))

        while pending or queue or any(s is not None for s in slots):
            drain_arrivals()

            # admission: reserve blocks + map shared prefix, no model call.
            # The match is capped to whole chunks strictly below the
            # prompt's last row, so at least one chunk (and the first
            # token's logits) is always computed live with the same
            # call shape the solo oracle uses.
            n_adm = 0
            while queue and n_adm < self.max_prefills_per_step:
                free = [i for i, s in enumerate(slots) if s is None]
                if not free:
                    break
                r = queue[0]
                target = min(r.max_new, max_steps)
                plen = len(r.prompt)
                lifetime = plen + target
                if not self.cache.can_admit(lifetime):
                    if not any(s is not None for s in slots):
                        raise RuntimeError(
                            f"request {r.uid} (lifetime {lifetime} tokens)"
                            f" cannot fit the arena even when idle")
                    break               # wait for a slot to free blocks
                queue.popleft()
                i = free[0]
                matched = self.cache.admit_shared(
                    i, np.asarray(r.prompt, np.int32).reshape(-1),
                    lifetime, max_match_rows=((plen - 1) // T) * T,
                    granule_rows=T)
                hit_c.inc(matched)
                miss_c.inc(plen - matched)
                slots[i] = _Slot(r, pos=plen, target=target,
                                 t_arrive=arrive_wall[r.uid], plen=plen,
                                 filled=matched, prefilling=True)
                n_adm += 1

            # one prefill chunk for the oldest mid-prefill slot
            pref = [i for i, s in enumerate(slots)
                    if s is not None and s.prefilling]
            if pref:
                i = min(pref, key=lambda j: (slots[j].req.arrival,
                                             slots[j].req.uid))
                s = slots[i]
                r = s.req
                prompt = np.asarray(r.prompt, np.int32).reshape(-1)
                if not s.started:
                    # last chance to share: a producer that was still
                    # mid-prefill at our admission has registered its
                    # completed chunks by now — graft them on while this
                    # slot has written nothing
                    grown = self.cache.extend_match(
                        i, prompt, max_match_rows=((s.plen - 1) // T) * T,
                        granule_rows=T)
                    if grown > s.filled:
                        hit_c.inc(grown - s.filled)
                        miss_c.inc(s.filled - grown)
                        s.filled = grown
                    s.started = True
                start = s.filled
                n = min(T, s.plen - start)
                width = next_pow2(n)
                self.cache.extend_to(i, start + n)
                toks = np.zeros((1, width), np.int32)
                toks[0, :n] = prompt[start:start + n]
                with tracer.span("serve.prefill_chunk", uid=r.uid,
                                 start=start, n_tokens=n):
                    logits, self.cache.state = self.model.prefill_chunk(
                        self.cache.state, self._tensor(toks),
                        self._tensor(self.cache.tables[i:i + 1]), start, n)
                    s.filled = start + n
                    last = s.filled >= s.plen
                    if last:
                        tok = sampler.rows(logits, {0: r.uid})[0]
                clock += 1.0
                # register incrementally: rows in completed absolute
                # chunks are final (later chunks never rewrite them), so
                # a prompt arriving mid-prefill can already share them.
                # Only FULL aligned chunks qualify — rows of a final
                # partial chunk ran at another call width.
                self.cache.register_prefix(i, prompt, (s.filled // T) * T)
                if last:
                    r.ttft_ms = (time.perf_counter()
                                 - arrive_wall[r.uid]) * 1e3
                    ttft_h.observe(r.ttft_ms)
                    r.out_tokens.append(tok)
                    s.prefilling = False
                    if len(r.out_tokens) >= s.target:
                        finish(i)
                drain_arrivals()

            active = [i for i, s in enumerate(slots)
                      if s is not None and not s.prefilling]
            if not active:
                if any(s is not None for s in slots):
                    continue            # prefill chunks still in flight
                if pending:
                    # idle: jump the virtual clock to the next arrival
                    clock = max(clock, pending[0].arrival)
                    continue
                if queue:
                    continue            # admission will retry (or raise)
                break

            # one decode step over the fully-prefilled slots
            occ_h.observe(len(active) / self.batch)
            pref = [i for i, s in enumerate(slots)
                    if s is not None and s.prefilling]
            tokens = np.zeros((self.batch, 1), np.int32)
            slot_pos = np.zeros((self.batch,), np.int32)
            for i in active:
                s = slots[i]
                tokens[i, 0] = s.req.out_tokens[-1]
                slot_pos[i] = s.pos
                self.cache.append(i, s.pos)
            if pref:
                # mask mid-prefill slots: their decode rows are inactive
                # (slot_pos 0) and must write the scratch block, not the
                # real block their table maps at row 0
                tbl = self.cache.tables.copy()
                tbl[pref] = -1
                tables = self._tensor(tbl)
            else:
                tables = self.cache.device_tables()
            t0 = time.perf_counter()
            with tracer.span("serve.decode_step", n_active=len(active),
                             queued=len(queue), prefilling=len(pref)):
                logits = self._decode(tokens, tables, slot_pos)
                toks = sampler.rows(logits, {i: slots[i].req.uid
                                             for i in active})
            dec_h.observe((time.perf_counter() - t0) * 1e3)
            clock += 1.0
            for i in active:
                s = slots[i]
                s.pos += 1
                s.req.out_tokens.append(toks[i])
                if len(s.req.out_tokens) >= s.target:
                    finish(i)
        qdepth.set(0)
        return results


class CohortScheduler(_SchedulerBase):
    """Static-cohort serving: up to ``batch`` arrived requests prefill
    together, decode in lockstep until every member finishes, then the
    next cohort forms.  The measured baseline for continuous batching."""

    def _budget(self, prompt_len: int) -> int:
        # power-of-two budget bucketing: cohorts whose budgets round to
        # the same bucket share one cache shape
        return next_pow2(prompt_len + self.max_new + 1)

    def run(self, requests: List[Request], temperature: float = 0.0,
            max_steps: int = 64) -> Dict[int, List[int]]:
        tracer = get_tracer()
        ttft_h, dec_h, occ_h, qdepth, req_c, tok_c = self._metric_handles()
        sampler = _Sampler(self.seed, self.device, temperature)

        pending = deque(sorted(requests, key=lambda r: (r.arrival, r.uid)))
        queue: deque = deque()
        arrive_wall: Dict[int, float] = {}
        results: Dict[int, List[int]] = {}
        clock = 0.0

        while pending or queue:
            now = time.perf_counter()
            while pending and pending[0].arrival <= clock:
                r = pending.popleft()
                queue.append(r)
                arrive_wall[r.uid] = now
            if not queue:               # idle until the next arrival
                clock = max(clock, pending[0].arrival)
                continue
            active = [queue.popleft()
                      for _ in range(min(self.batch, len(queue)))]
            uids = {i: r.uid for i, r in enumerate(active)}
            qdepth.set(len(queue))
            occ_h.observe(len(active) / self.batch)
            with tracer.span("serve.batch", n_active=len(active),
                             queued=len(queue)):
                prompts, pads = pack_prompts(active, self.batch)
                prefill_fn, decode_fn = build_serve_fns(
                    self.model, budget=self._budget(prompts.shape[1]))
                batch = {"tokens": self._tensor(prompts)}
                if self.cfg.is_encdec:
                    batch["frames"] = torch.zeros(
                        (self.batch, prompts.shape[1], self.cfg.d_model),
                        device=self.device)
                if self.cfg.n_patches:
                    batch["patches"] = torch.zeros(
                        (self.batch, self.cfg.n_patches, self.cfg.d_model),
                        device=self.device)
                with tracer.span("serve.prefill",
                                 prompt_len=int(prompts.shape[1])):
                    logits, state = prefill_fn(batch)
                    state = mask_padded_cache(state, pads)
                    toks = sampler.rows(logits, uids)
                clock += 1.0
                t_first = time.perf_counter()
                for r in active:
                    r.ttft_ms = (t_first - arrive_wall[r.uid]) * 1e3
                    ttft_h.observe(r.ttft_ms)
                for step in range(max_steps):
                    for i, r in enumerate(active):
                        if not r.done and len(r.out_tokens) < r.max_new:
                            r.out_tokens.append(toks[i])
                        elif not r.done:
                            r.done = True
                    if all(r.done or len(r.out_tokens) >= r.max_new
                           for r in active):
                        break
                    fed = np.zeros((self.batch, 1), np.int32)
                    for i in uids:
                        fed[i, 0] = toks[i]
                    t0 = time.perf_counter()
                    with tracer.span("serve.decode_step", step=step):
                        logits, state = decode_fn(state, self._tensor(fed))
                        toks = sampler.rows(logits, uids)
                    dec_h.observe((time.perf_counter() - t0) * 1e3)
                    clock += 1.0
                t_done = time.perf_counter()
                for r in active:
                    r.total_ms = (t_done - arrive_wall[r.uid]) * 1e3
                    results[r.uid] = r.out_tokens
                    req_c.inc()
                    tok_c.inc(len(r.out_tokens))
        qdepth.set(0)
        return results
