"""Atomic, optionally asynchronous checkpoints of a tree of tensors.

The counterpart of ``repro.checkpoint.checkpoint`` with its layout:
``<dir>/step_<k>/arrays.npz`` plus ``meta.json``; a top-level ``LATEST``
file is replaced atomically (a temporary file, then a rename) only after
the step directory is fully written, so a preemption mid-save never
corrupts the restore path; ``keep`` step directories are kept.

A tree is nested dicts, lists, tuples and NamedTuples (the trainer's
``{"params": ..., "opt": AdamWState}``) with tensor leaves, each saved
under its path joined by "/".  ``restore`` reads them into the structure
of a tree like it, each leaf in its like's type on a target device; a
missing key raises ``KeyError``.

The snapshot: the reference snapshots immutable arrays; the port's
parameters and moments are updated in place, and on the CPU ``t.cpu()``
is ``t`` itself, so an asynchronous save that kept references would write
what the next step is overwriting.  ``save`` therefore copies every leaf
to the host (``detach().to("cpu", copy=True)``) before it returns or
starts the writer thread.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["Checkpointer", "SEP"]

SEP = "/"


def _items(tree):
    """(key, child) pairs of a tree node, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}{SEP}{k}" if prefix else k))
    return flat


def _rebuild(like, fn, prefix: str = ""):
    """``like``'s structure with each leaf ``fn(key, leaf)``."""
    items = _items(like)
    if items is None:
        return fn(prefix, like)
    kids = [_rebuild(v, fn, f"{prefix}{SEP}{k}" if prefix else k)
            for k, v in items]
    if isinstance(like, dict):
        return dict(zip(like.keys(), kids))
    if hasattr(like, "_fields"):
        return type(like)(*kids)
    return type(like)(kids)


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy that no later in-place write reaches (bf16, which numpy
    lacks, as f32: exact)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True)


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ----------------------------------------------------------------

    def save(self, step: int, tree, extra_meta: Optional[dict] = None):
        """Snapshot every leaf to the host now, then write (on a thread
        with ``async_save``)."""
        host = {k: _host(v) for k, v in _flatten(tree).items()}
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write_caught, args=(step, host, extra_meta),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host, extra_meta)

    def wait(self):
        """Join the writer thread; its failure is raised here."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_caught(self, step, host, extra_meta):
        try:
            self._write(step, host, extra_meta)
        except BaseException as e:
            self._error = e

    def _write(self, step: int, host: Dict[str, torch.Tensor], extra_meta):
        step_dir = os.path.join(self.dir, f"step_{step:08d}")
        tmp_dir = step_dir + ".tmp"
        shutil.rmtree(tmp_dir, ignore_errors=True)
        os.makedirs(tmp_dir, exist_ok=True)
        np.savez(os.path.join(tmp_dir, "arrays.npz"),
                 **{k: v.numpy() for k, v in host.items()})
        meta = {"step": step, "time": time.time(), "keys": sorted(host)}
        meta.update(extra_meta or {})
        with open(os.path.join(tmp_dir, "meta.json"), "w") as f:
            json.dump(meta, f)
        shutil.rmtree(step_dir, ignore_errors=True)
        os.rename(tmp_dir, step_dir)
        # atomically advance LATEST
        latest_tmp = os.path.join(self.dir, "LATEST.tmp")
        with open(latest_tmp, "w") as f:
            f.write(f"step_{step:08d}")
        os.replace(latest_tmp, os.path.join(self.dir, "LATEST"))
        self._gc()

    def _gc(self):
        steps = sorted(d for d in os.listdir(self.dir)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for d in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # -- restore -------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.dir, "LATEST")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return int(f.read().strip().split("_")[1])

    def restore(self, tree_like, step: Optional[int] = None, device=None):
        """The saved tree in the structure of ``tree_like``, each leaf in
        its like's type on ``device`` (None: the like's device)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}", "arrays.npz")
        with np.load(path) as data:
            missing = [k for k in _flatten(tree_like) if k not in data.files]
            if missing:
                raise KeyError(f"checkpoint missing keys: {missing[:5]} "
                               f"({len(missing)} total)")
            return _rebuild(tree_like, lambda k, like: torch.from_numpy(
                data[k]).to(device=like.device if device is None else device,
                            dtype=like.dtype))

    def meta(self, step: Optional[int] = None) -> dict:
        if step is None:
            step = self.latest_step()
        with open(os.path.join(self.dir, f"step_{step:08d}",
                               "meta.json")) as f:
            return json.load(f)
