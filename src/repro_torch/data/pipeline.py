"""Synthetic but deterministic training data, prefetched to the device on a
background thread.

The counterpart of ``repro.data.pipeline``.  ``synth_batch`` is a copy of
the reference's numpy function (the same arrays for the same (seed,
step)), so that a checkpoint restored at step k replays batch k.
``Prefetcher`` is the paper's Overlap pattern at the host, with an explicit
device: a thread makes batch t + 1, pins it and starts its copy on a side
CUDA stream while the step consumes batch t; the consumer's stream waits
on that copy's event before it reads the batch, and each tensor is
recorded on the consumer's stream (``record_stream``) so that its memory
is not reused before the step is done with it.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from ..core.config import ArchConfig

__all__ = ["synth_batch", "Prefetcher"]


def synth_batch(cfg: ArchConfig, *, batch: int, seq: int, seed: int,
                step: int) -> Dict[str, np.ndarray]:
    """Deterministic synthetic LM batch for (seed, step)."""
    rng = np.random.default_rng(np.uint64(seed) * np.uint64(1_000_003)
                                + np.uint64(step))
    n_text = seq - (cfg.n_patches if cfg.n_patches else 0)
    if cfg.is_encdec:
        n_text = seq // 2
    # a learnable synthetic language: tokens follow a noisy affine recurrence
    # so the loss has signal to descend (pure-uniform tokens would not).
    t0 = rng.integers(0, cfg.vocab, (batch, 1))
    steps = rng.integers(0, 7, (batch, n_text - 1))
    toks = (np.cumsum(np.concatenate([t0, steps], axis=1), axis=1)
            % cfg.vocab).astype(np.int32)
    out: Dict[str, np.ndarray] = {
        "tokens": toks,
        "labels": np.concatenate(
            [toks[:, 1:], np.full((batch, 1), -1, np.int32)], axis=1),
    }
    if cfg.n_patches:
        out["patches"] = rng.standard_normal(
            (batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal(
            (batch, seq - n_text, cfg.d_model)).astype(np.float32)
    return out


class Prefetcher:
    """Batches ``synth_batch(step)`` for step = start_step, start_step + 1,
    ... on ``device``, ``depth`` of them made ahead by a background thread.
    On a CUDA device each batch is pinned and copied on a side stream; the
    consumer's stream waits on the copy when ``next`` hands it over."""

    def __init__(self, cfg: ArchConfig, *, batch: int, seq: int, seed: int,
                 start_step: int = 0, device="cpu", depth: int = 2):
        self.cfg, self.batch, self.seq, self.seed = cfg, batch, seq, seed
        self.device = torch.device(device)
        self.step = start_step
        self.stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _produce(self, step: int):
        host = synth_batch(self.cfg, batch=self.batch, seq=self.seq,
                           seed=self.seed, step=step)
        if self.stream is None:
            return {k: torch.from_numpy(v).to(self.device)
                    for k, v in host.items()}, None
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = {k: torch.from_numpy(v).pin_memory().to(
                self.device, non_blocking=True) for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(self.stream)
        return out, done

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            try:
                item = self._produce(step)
            except BaseException as e:          # handed to the consumer
                item = (e, None)
            while not self._stop.is_set():
                try:
                    self.q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(item[0], BaseException):
                return
            step += 1

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        batch, done = self.q.get()
        if isinstance(batch, BaseException):
            raise batch
        if done is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(done)
            for t in batch.values():
                t.record_stream(consumer)
        self.step += 1
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.thread.join(timeout=2)
