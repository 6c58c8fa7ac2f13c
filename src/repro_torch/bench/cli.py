"""Benchmark command line for the port.

    PYTHONPATH=src python -m repro_torch.bench.cli list [--tag h100]
    PYTHONPATH=src python -m repro_torch.bench.cli run --only h100/ --json out.json
    PYTHONPATH=src python -m repro_torch.bench.cli run --device cpu --only smoke/

``list`` prints registered scenarios without running anything.  ``run``
measures the selected scenarios on the card (``--device cuda``, the
default) or runs the plain torch versions on the CPU (``--device cpu``).
With ``--device cuda`` and no card it exits 2 and runs nothing.  It exits 1
when a row fails its oracle check.  ``--json -`` writes the schema-v2 report
to stdout and keeps all progress on stderr.
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import List, Optional

from ..core import hardware
from ..core.async_pipeline import Strategy, parse_strategy
from . import runner, scenario
from .results import BenchReport


def _strategy(text: Optional[str]) -> Optional[Strategy]:
    if not text:
        return None
    try:
        return parse_strategy(text)
    except ValueError as e:
        raise SystemExit(f"error: {e}")


def _filters(args) -> dict:
    return dict(only=args.only, kernel=args.kernel,
                strategy=_strategy(args.strategy), tag=args.tag,
                smoke=True if getattr(args, "smoke", False) else None)


def _progress_stream(args):
    return sys.stderr if args.json == "-" else sys.stdout


def _emit(stream):
    def emit(r):
        m = r.metrics
        val = f"us_median={m['us_median']:.1f}"
        if "gb_per_s" in m:
            val += f" GB/s={m['gb_per_s']:.1f}"
        extra = ""
        if "max_err" in m:
            extra = f" max_err={m['max_err']:.2e}" + \
                ("" if m.get("check_ok", True) else " CHECK-FAILED")
        print(f"{r.kind:<9s}{r.scenario:<36s} chip={r.chip:<10s} "
              f"strategy={r.strategy:<16s} {val}{extra}",
              file=stream, flush=True)
    return emit


def _write_json(report: BenchReport, args, stream) -> None:
    if not args.json:
        return
    if args.json == "-":
        report.save(sys.stdout)
    else:
        report.save(args.json)
        print(f"# wrote {len(report)} rows to {args.json}", file=stream)


def _start_trace(args):
    """Enable the obs tracer when a trace output was requested."""
    if args.trace or args.chrome_trace:
        from ..obs.trace import tracer
        t = tracer()
        t.clear()
        t.enable()
        return t
    return None


def _write_trace(t, args, stream) -> None:
    if t is None:
        return
    if args.trace:
        n = t.save_jsonl(args.trace)
        print(f"# wrote {n} spans to {args.trace}", file=stream)
    if args.chrome_trace:
        doc = t.chrome_trace()
        with open(args.chrome_trace, "w") as f:
            json.dump(doc, f)
        print(f"# wrote {len(doc['traceEvents'])} trace events to "
              f"{args.chrome_trace}", file=stream)


def cmd_list(args) -> int:
    scs = scenario.scenarios(**_filters(args))
    if not scs:
        print("no scenarios match the given filters", file=sys.stderr)
        return 2
    print(f"{'name':<36s} {'kernel':<16s} {'shape':<14s} {'strategy':<16s} "
          f"{'tags':<14s} smoke")
    for sc in scs:
        strat = sc.strategy.value if sc.strategy else "(default)"
        print(f"{sc.name:<36s} {sc.kernel:<16s} "
              f"{'x'.join(map(str, sc.shape)):<14s} {strat:<16s} "
              f"{','.join(sc.tags):<14s} {'y' if sc.smoke else 'n'}")
    print(f"# {len(scs)} scenarios")
    return 0


def cmd_run(args) -> int:
    stream = _progress_stream(args)
    scs = scenario.scenarios(**_filters(args))
    if not scs:
        print("error: no scenarios match the given filters", file=sys.stderr)
        return 2
    try:
        runner.require_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    opts = runner.RunOptions(
        warmup=args.warmup, repeats=args.repeats, device=args.device,
        check=not args.no_check, chip=args.chip, emit=_emit(stream))
    t = _start_trace(args)
    report = runner.run_scenarios(scs, opts)
    bad = [r for r in report.results
           if r.metrics.get("check_ok") is False]
    _write_json(report, args, stream)
    _write_trace(t, args, stream)
    if bad:
        print(f"error: {len(bad)} scenario(s) failed the oracle check: "
              f"{[r.scenario for r in bad]}", file=sys.stderr)
        return 1
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.bench.cli",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("-v", "--verbose", action="store_true")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add_filters(p):
        p.add_argument("--only", default=None,
                       help="substring filter over scenario names; "
                            "comma-separates alternatives (OR)")
        p.add_argument("--kernel", choices=scenario.KERNELS, default=None)
        p.add_argument("--strategy", default=None,
                       help="async strategy filter "
                            f"({[s.value for s in Strategy]})")
        p.add_argument("--tag", default=None,
                       help="scenario tag filter (smoke/fig3/fig4/paper/h100)")
        p.add_argument("--smoke", action="store_true",
                       help="only smoke-tagged scenarios")

    p = sub.add_parser("list", help="print registered scenarios (no run)")
    add_filters(p)
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("run", help="measure scenarios on the card")
    add_filters(p)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda: the hand-written kernels on the card "
                        "(default); cpu: their plain torch versions")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--no-check", action="store_true",
                   help="skip the ref-oracle correctness check")
    p.add_argument("--chip", default=None, choices=sorted(hardware.CATALOG),
                   help="provenance chip (default: the card's catalog row, "
                        "or TARGET on the CPU)")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="write the schema-v2 report ('-' for stdout; "
                        "progress then goes to stderr)")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="enable span tracing and write the span JSONL")
    p.add_argument("--chrome-trace", default=None, metavar="PATH",
                   help="enable span tracing and write a Perfetto/"
                        "chrome://tracing JSON")
    p.set_defaults(fn=cmd_run)

    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO if args.verbose
                        else logging.WARNING)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
