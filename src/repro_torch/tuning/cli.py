"""Autotuner command line for the port.

    PYTHONPATH=src python -m repro_torch.tuning.cli tune --kernel stream
    PYTHONPATH=src python -m repro_torch.tuning.cli tune --all
    PYTHONPATH=src python -m repro_torch.tuning.cli tune --kernel stream --device cpu --shape 256,256
    PYTHONPATH=src python -m repro_torch.tuning.cli show [--kernel stream]
    PYTHONPATH=src python -m repro_torch.tuning.cli export --out tuned.csv

``tune`` measures on the card (``--device cuda``, the default; with no
card it exits 2 and writes nothing) or times the plain torch versions on
the CPU (``--device cpu``).  The registry path defaults to
``./tuning_registry_torch.json`` (override with ``--registry`` or the
REPRO_TORCH_TUNING_REGISTRY environment variable).  A second ``tune`` of
the same (kernel, shape, dtype, chip, mode) cell is a cache hit and does
no measurement; pass ``--force`` to re-measure.
"""
from __future__ import annotations

import argparse
import csv
import json
import logging
import sys
import time
from typing import List, Optional

from ..bench.timing import require_device
from . import registry as reg_mod
from .autotuner import Autotuner
from .registry import Registry
from .search_space import KERNELS, default_task


def _parse_shape(text: Optional[str]):
    if not text:
        return None
    return tuple(int(p) for p in text.replace("x", ",").split(",") if p)


def _fmt_config(cfg) -> str:
    cfg = dict(cfg)
    strat = cfg.pop("strategy", "?")
    strat = getattr(strat, "value", strat)
    rest = ",".join(f"{k}={v}" for k, v in sorted(cfg.items()))
    return f"{strat}[{rest}]"


def cmd_tune(args) -> int:
    kernels: List[str] = list(KERNELS) if args.all else [args.kernel]
    if not kernels or kernels == [None]:
        print("error: pass --kernel NAME or --all", file=sys.stderr)
        return 2
    if args.all and args.shape:
        print("error: --shape applies to one kernel; it cannot be combined "
              "with --all (kernels have different shape ranks)",
              file=sys.stderr)
        return 2
    try:
        require_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    registry = Registry(args.registry)
    tuner = Autotuner(registry, warmup=args.warmup, repeats=args.repeats)
    for kernel in kernels:
        task = default_task(kernel, shape=_parse_shape(args.shape),
                            dtype=args.dtype, device=args.device)
        t0 = time.time()
        cached = registry.get(task.kernel, task.shape, task.dtype,
                              task.chip, task.interpret)
        try:
            rec = tuner.tune(task, force=args.force, verbose=args.verbose)
        except RuntimeError as e:       # e.g. shape no candidate can tile
            print(f"error: {e}", file=sys.stderr)
            return 1
        hit = cached is not None and not args.force
        what = "cache hit" if hit else f"tuned in {time.time() - t0:.1f}s"
        speed = (f" {rec.speedup_vs_default:.2f}x vs default"
                 if rec.speedup_vs_default else "")
        print(f"{rec.kernel:<16s} shape={'x'.join(map(str, rec.shape))} "
              f"dtype={rec.dtype} chip={rec.chip} device={args.device}: "
              f"best={_fmt_config(rec.best)} {rec.best_us:.1f}us{speed} "
              f"[{what}, {rec.n_candidates} measured, "
              f"{rec.n_pruned} pruned]")
    print(f"registry: {registry.path} ({len(registry)} records)")
    return 0


def cmd_show(args) -> int:
    registry = Registry(args.registry)
    records = registry.records()
    if args.kernel:
        records = [r for r in records if r.kernel == args.kernel]
    if not records:
        print(f"no records in {registry.path}")
        return 1
    print(f"{'kernel':<16s} {'shape':<14s} {'dtype':<9s} {'chip':<9s} "
          f"{'best config':<40s} {'us':>10s} {'vs_default':>10s}")
    for r in records:
        print(f"{r.kernel:<16s} {'x'.join(map(str, r.shape)):<14s} "
              f"{r.dtype:<9s} {r.chip:<9s} {_fmt_config(r.best):<40s} "
              f"{r.best_us:>10.1f} "
              f"{(f'{r.speedup_vs_default:.2f}x' if r.speedup_vs_default else '-'):>10s}")
        if args.verbose:
            for m in sorted(r.measurements,
                            key=lambda m: m.us_median or 1e30):
                status = f"{m.us_median:10.1f}us" if m.error is None \
                    else f"FAILED: {m.error}"
                print(f"    {_fmt_config(m.config):<44s} "
                      f"pred={m.predicted_us:9.1f}us  {status}")
    return 0


def cmd_export(args) -> int:
    registry = Registry(args.registry)
    records = registry.records()
    rows = []
    for r in records:
        for m in r.measurements:
            rows.append({
                "kernel": r.kernel, "shape": "x".join(map(str, r.shape)),
                "dtype": r.dtype, "chip": r.chip,
                "config": _fmt_config(m.config),
                "us_median": m.us_median, "us_mean": m.us_mean,
                "us_min": m.us_min, "us_std": m.us_std,
                "n_trials": m.n_trials, "predicted_us": m.predicted_us,
                "is_best": m.config == r.best, "error": m.error or "",
            })
    if args.format == "csv":
        w = csv.DictWriter(args.out, fieldnames=list(rows[0]) if rows else
                           ["kernel"])
        w.writeheader()
        w.writerows(rows)
    else:
        json.dump({"schema_version": reg_mod.SCHEMA_VERSION,
                   "measurements": rows}, args.out, indent=1)
        args.out.write("\n")
    print(f"exported {len(rows)} measurements from {len(records)} records",
          file=sys.stderr)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.tuning.cli",
                                 description=__doc__.splitlines()[0])
    registry_help = ("registry JSON path (default "
                     "./tuning_registry_torch.json or "
                     "$REPRO_TORCH_TUNING_REGISTRY)")
    ap.add_argument("--registry", default=None, help=registry_help)
    ap.add_argument("-v", "--verbose", action="store_true")
    sub = ap.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("tune", help="search + measure + cache best configs")
    t.add_argument("--kernel", choices=KERNELS, default=None)
    t.add_argument("--all", action="store_true",
                   help="tune every kernel at its default shape")
    t.add_argument("--shape", default=None,
                   help="problem shape, e.g. 512x256 or 512,256 (kernel "
                        "default otherwise)")
    t.add_argument("--dtype", default="float32")
    t.add_argument("--repeats", type=int, default=5)
    t.add_argument("--warmup", type=int, default=1)
    t.add_argument("--force", action="store_true",
                   help="re-measure even on a cache hit")
    t.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda: the hand-written kernels on the card "
                        "(default); cpu: their plain torch versions")
    t.set_defaults(fn=cmd_tune)

    s = sub.add_parser("show", help="print cached records")
    s.add_argument("--kernel", choices=KERNELS, default=None)
    s.set_defaults(fn=cmd_show)

    e = sub.add_parser("export", help="dump full measurement provenance")
    e.add_argument("--out", type=argparse.FileType("w"), default=sys.stdout)
    e.add_argument("--format", choices=("json", "csv"), default="json")
    e.set_defaults(fn=cmd_export)

    for p in (t, s, e):     # also after the command; overrides the above
        p.add_argument("--registry", default=argparse.SUPPRESS,
                       help=registry_help)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO if args.verbose
                        else logging.WARNING)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
