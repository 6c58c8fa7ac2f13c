"""The training step and the fault-tolerant training loop.

The counterpart of ``repro.launch.train``.  ``build_train_step(model, run)``
returns ``train_step(opt_state, batch, step) -> (opt_state, metrics)``:
gradient accumulation over ``run.microbatches`` (each microbatch's
gradients from ``torch.autograd.grad``, summed in the accumulator type:
f32, or bf16 with ``run.grad_compression == "bf16"``, each addition rounded
to bf16 as the reference's is), the division by the microbatch count,
``lr_schedule(step + 1)`` and ``adamw_update``, which writes the model's
parameters in place.  ``metrics`` holds ce, aux, tokens, grad_norm and lr.
``remat`` runs each decoder layer under ``torch.utils.checkpoint``.

On the card every product of the dense model runs forward and backward on
the matmul kernel (``layers.kernel_linear``) and prefill attention on the
flash kernel and its backward kernel (``FlashAttention``); the other
families refuse a loss under autograd there (``Model.loss``).  ZeRO-1
waits for the distributed slice (the reference skips it on one device
without sharding rules too).

``train_loop`` trains one model on one device (the card unless the caller
passes ``device="cpu"``) with the reference's checkpoint and resume,
preemption guard, retries and straggler statistics, on ``synth_batch`` by
(seed, step) through the ``Prefetcher``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --steps 50 [--device cpu]
"""
from __future__ import annotations

import argparse
import logging
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..checkpoint import Checkpointer
from ..core.config import ArchConfig, RunConfig
from ..data import Prefetcher
from ..distributed.fault_tolerance import (PreemptionGuard, StepStats,
                                           run_with_retries)
from ..models import build_model
from ..optim import AdamWState, adamw_init, adamw_update, lr_schedule

__all__ = ["microbatch_split", "build_train_step", "train_loop", "main"]

log = logging.getLogger("repro_torch.train")

Batch = Dict[str, torch.Tensor]


def microbatch_split(batch: Batch, n: int) -> List[Batch]:
    """(B, ...) -> n batches of (B / n, ...), in order."""
    def split(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not divide into {n} "
                             f"microbatches")
        return x.reshape(n, b // n, *x.shape[1:]).unbind(0)
    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def build_train_step(model, run: RunConfig) -> Callable:
    """``train_step(opt_state, batch, step, retry=None) -> (opt_state,
    metrics)`` for ``model``'s parameters (``named_parameters``, updated in
    place); ``retry`` wraps the gradient computation (which has no side
    effects: ``train_loop`` passes ``run_with_retries``).  Its
    ``gradients(batch) -> (grads, metrics)`` attribute is the step before
    the update."""
    params = dict(model.net.named_parameters())
    accum_dtype = torch.bfloat16 if run.grad_compression == "bf16" \
        else torch.float32

    def loss_grads(mb: Batch):
        loss, metrics = model.loss(mb, remat=run.remat)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        return grads, {k: v.detach().float() for k, v in metrics.items()}

    def gradients(batch: Batch) -> Tuple[Dict[str, torch.Tensor],
                                         Dict[str, torch.Tensor]]:
        a = run.microbatches
        if a == 1:
            return loss_grads(batch)
        acc = {k: torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
               for k, p in params.items()}
        metrics = None
        for mb in microbatch_split(batch, a):
            grads, m = loss_grads(mb)
            for k, g in grads.items():
                acc[k] += g.to(accum_dtype)
            metrics = m if metrics is None else \
                {k: metrics[k] + v for k, v in m.items()}
            del grads
        grads = {k: (g / a).float() for k, g in acc.items()}
        metrics = {k: v / a for k, v in metrics.items()}
        metrics["tokens"] = metrics["tokens"] * a
        return grads, metrics

    def train_step(opt_state: AdamWState, batch: Batch, step: int,
                   retry: Optional[Callable] = None):
        grads, metrics = (retry or (lambda f: f()))(lambda: gradients(batch))
        lr = lr_schedule(step + 1, lr=run.lr, warmup=run.warmup_steps,
                         total=run.total_steps)
        opt_state, gnorm = adamw_update(
            grads, opt_state, params, lr=lr, weight_decay=run.weight_decay,
            clip_norm=run.clip_norm)
        return opt_state, dict(metrics, grad_norm=gnorm, lr=lr)

    train_step.gradients = gradients
    return train_step


def train_loop(cfg: ArchConfig, run: RunConfig, *, steps: int,
               batch: int = 8, seq: int = 64,
               ckpt_dir: Optional[str] = None, resume: bool = False,
               log_every: int = 10, straggler_factor: float = 3.0,
               device="cuda", attention: str = "flash"):
    """Single-device training with checkpoint/restart and preemption
    handling -> (model, opt_state, the ce of each step run).  The weights
    come from ``run.seed`` on ``device``; with ``resume`` and a checkpoint
    in ``ckpt_dir`` the parameters and moments are restored into them (in
    place) and training goes on from its step.  A checkpoint is written
    after the last step and when a preemption signal arrives."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device=\"cpu\" to train on "
                           "the CPU")
    model = build_model(cfg, attention=attention, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(run.seed))
    params = dict(model.net.named_parameters())
    opt_state = adamw_init(params)
    start_step = 0

    ckpt = Checkpointer(ckpt_dir, async_save=True) if ckpt_dir else None
    if ckpt and resume and ckpt.latest_step() is not None:
        restored = ckpt.restore({"params": params, "opt": opt_state})
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(restored["params"][k])
            for mine, saved in ((opt_state.m, restored["opt"].m),
                                (opt_state.v, restored["opt"].v)):
                for k, t in mine.items():
                    t.copy_(saved[k])
        opt_state = opt_state._replace(step=restored["opt"].step)
        start_step = ckpt.latest_step()
        log.info("resumed from step %d", start_step)

    step_fn = build_train_step(model, run)
    stats = StepStats()
    history = []
    data = Prefetcher(cfg, batch=batch, seq=seq, seed=run.seed,
                      start_step=start_step, device=dev)
    try:
        with PreemptionGuard() as guard:
            for step in range(start_step, steps):
                batch_ = next(data)
                t0 = time.perf_counter()
                opt_state, metrics = step_fn(opt_state, batch_, step,
                                             retry=run_with_retries)
                ce = float(metrics["ce"])          # waits for the step
                stats.record(step, time.perf_counter() - t0,
                             factor=straggler_factor)
                history.append(ce)
                if step % log_every == 0:
                    log.info("step %d ce=%.4f gnorm=%.3f", step, ce,
                             float(metrics["grad_norm"]))
                if ckpt and (guard.requested or step == steps - 1):
                    ckpt.save(step + 1, {"params": params, "opt": opt_state})
                    if guard.requested:
                        log.warning("preempted at step %d: state saved", step)
                        break
    finally:
        data.close()
    if ckpt:
        ckpt.wait()
    return model, opt_state, history


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: the card (default; exits 2 without one); "
                         "cpu: the kernels' plain versions")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--tuning-registry", default=None,
                    help="autotuning registry JSON (default "
                         "./tuning_registry_torch.json)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device (pass --device cpu to train on the "
              "CPU)", file=sys.stderr)
        return 2
    from ..tuning import apply_tuned_kernel_defaults
    apply_tuned_kernel_defaults(args.tuning_registry)

    from ..configs import get_config, get_smoke_config
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    run = RunConfig(total_steps=args.steps,
                    warmup_steps=max(args.steps // 10, 1))
    _, _, history = train_loop(cfg, run, steps=args.steps, batch=args.batch,
                               seq=args.seq, ckpt_dir=args.ckpt,
                               resume=args.resume, device=args.device)
    print(f"first-10 ce={sum(history[:10])/max(len(history[:10]),1):.4f} "
          f"last-10 ce={sum(history[-10:])/max(len(history[-10:]),1):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
