"""Benchmark command line for the port.

    PYTHONPATH=src python -m repro_torch.bench.cli list [--tag h100]
    PYTHONPATH=src python -m repro_torch.bench.cli run --only h100/ --json out.json
    PYTHONPATH=src python -m repro_torch.bench.cli run --device cpu --only smoke/
    PYTHONPATH=src python -m repro_torch.bench.cli run --device cpu --tag serve
    PYTHONPATH=src python -m repro_torch.bench.cli sweep --tag regime --json BENCH.json
    PYTHONPATH=src python -m repro_torch.bench.cli lineage [--json doc.json]

``list`` prints registered scenarios without running anything.  ``run``
measures the selected scenarios on the card (``--device cuda``, the
default) or runs the plain torch versions on the CPU (``--device cpu``).
``sweep`` measures them too, projects each through the roofline model
across the chip lineage (every ``core.hardware`` chip, or ``--chip`` to
restrict) and folds the ``regime/*`` rows into one verdict a kernel; a
``serve/*`` cell (``--tag serve``) serves the smoke qwen2-1.5b through
``bench.serving`` and is measured, not projected.  Both
resolve each config from the tuning registry (``repro_torch.tuning``;
``--registry PATH``, ``--no-tuned`` for the seed defaults only).  With
``--device cuda`` and no card both exit 2 and run nothing; both exit 1 when
a measured row fails its oracle check.  ``--json -`` writes the schema-v2
report to stdout and keeps all progress on stderr.  ``lineage`` holds the
catalog's expected speedups to the committed published numbers
(experiments/baselines/LINEAGE_hopper.json): exit 1 on any "over" or
"under" verdict, 2 when the reference cannot be loaded.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import List, Optional

from ..core import hardware
from ..core.async_pipeline import Strategy, parse_strategy
from ..tuning.registry import Registry
from . import lineage, runner, scenario
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


def _select(args) -> List[scenario.Scenario]:
    """The scenarios the filters select; none prints an error."""
    scs = scenario.scenarios(**_filters(args))
    if not scs:
        print("error: no scenarios match the given filters", file=sys.stderr)
    return scs


def _emit(stream):
    def emit(r):
        m = r.metrics
        if r.kind == "regime":          # derived verdict row, not a timing
            be = m.get("break_even_depth")
            val = (f"verdict={m['verdict']} "
                   f"break_even_depth={be if be is not None else '-'} "
                   f"speedup={m['speedup']:.2f}x")
        elif "us_median" in m:
            val = f"us_median={m['us_median']:.1f}"
            if "gb_per_s" in m:
                val += f" GB/s={m['gb_per_s']:.1f}"
        else:
            val = f"predicted_us={m['predicted_us']:.2f}"
        extra = ""
        if "max_err" in m:
            extra = f" max_err={m['max_err']:.2e}" + \
                ("" if m.get("check_ok", True) else " CHECK-FAILED")
        print(f"{r.kind:<9s}{r.scenario:<36s} chip={r.chip:<10s} "
              f"strategy={r.strategy:<16s} {val}{extra}",
              file=stream, flush=True)
    return emit


def _options(args, stream) -> Optional[runner.RunOptions]:
    """The measurement options, or None (and an error) when ``--device``
    names a card this host does not have."""
    try:
        runner.require_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return None
    return runner.RunOptions(
        warmup=args.warmup, repeats=args.repeats, device=args.device,
        check=not args.no_check, use_tuned=not args.no_tuned,
        registry=Registry(args.registry) if args.registry else None,
        emit=_emit(stream))


def _failed_checks(report: BenchReport) -> int:
    """1 (and the failed scenarios on stderr) when a measured row failed its
    oracle check, else 0."""
    bad = [r.scenario for r in report.results
           if r.metrics.get("check_ok") is False]
    if bad:
        print(f"error: {len(bad)} scenario(s) failed the oracle check: "
              f"{bad}", file=sys.stderr)
        return 1
    return 0


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
    scs = _select(args)
    opts = _options(args, stream) if scs else None
    if opts is None:
        return 2
    opts.chip = args.chip
    t = _start_trace(args)
    report = runner.run_scenarios(scs, opts)
    _write_json(report, args, stream)
    _write_trace(t, args, stream)
    return _failed_checks(report)


def cmd_sweep(args) -> int:
    stream = _progress_stream(args)
    scs = _select(args)
    # --chip restricts the projection; the provenance chip is the device's
    chips = args.chip or list(hardware.CATALOG)
    opts = _options(args, stream) if scs else None
    if opts is None:
        return 2
    t = _start_trace(args)
    report = runner.sweep(scs, chips, opts)
    measured = sum(1 for r in report.results if r.kind == "measured")
    regime = [r for r in report.results if r.kind == "regime"]
    print(f"# sweep: {measured} measured rows + "
          f"{len(report) - measured - len(regime)} model rows over "
          f"{len(chips)} chips + {len(regime)} regime verdicts",
          file=stream)
    for r in regime:
        be = r.metrics.get("break_even_depth")
        print(f"#   regime {r.kernel:<16s} "
              f"{'x'.join(map(str, r.shape)):<14s} "
              f"{r.metrics['verdict']:<8s} "
              f"break-even depth={be if be is not None else '-'} "
              f"best=d{r.metrics['best_depth']} "
              f"({r.metrics['speedup']:.2f}x vs sync)", file=stream)
    _write_json(report, args, stream)
    _write_trace(t, args, stream)
    return _failed_checks(report)


def cmd_lineage(args) -> int:
    """Validate catalog speedup expectations against the committed
    published-number reference table; nonzero on any over/under verdict."""
    stream = _progress_stream(args)
    try:
        pairs = lineage.load_reference(args.reference)
    except (OSError, ValueError, KeyError, json.JSONDecodeError) as e:
        print(f"error: cannot load reference {args.reference}: {e}",
              file=sys.stderr)
        return 2
    verdicts = lineage.validate(pairs)
    chain = lineage.lineage_chain(precision=args.precision)
    print(f"# lineage arc ({args.precision}): " + " -> ".join(
        hardware.DATACENTER_LINEAGE), file=stream)
    for v in chain:
        print(f"chain    {v.old:>9s} -> {v.new:<10s} "
              f"expected={v.expected:5.2f}x "
              f"(flops {v.flop_ratio:.2f}x, bw {v.bw_ratio:.2f}x; "
              f"{v.binds} bind)", file=stream)
    for v in verdicts:
        print(f"{v.verdict:<12s} {v.old:>9s} -> {v.new:<10s} "
              f"[{v.precision}] expected={v.expected:5.2f}x "
              f"published={v.published:5.2f}x "
              f"dev={v.rel_dev:+.1%} band=+-{v.band:.0%}", file=stream)
    doc = lineage.to_doc(verdicts, chain,
                         reference=os.path.basename(args.reference))
    if args.json:
        if args.json == "-":
            json.dump(doc, sys.stdout, indent=1, sort_keys=True)
            sys.stdout.write("\n")
        else:
            with open(args.json, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            print(f"# wrote {len(verdicts)} verdicts to {args.json}",
                  file=stream)
    c = doc["counts"]
    print(f"# lineage: {c.get('within-band', 0)} within-band, "
          f"{c.get('over', 0)} over, {c.get('under', 0)} under",
          file=stream)
    if not doc["ok"]:
        bad = [f"{v.old}->{v.new}[{v.precision}]" for v in verdicts
               if not v.ok]
        print(f"error: catalog expectations drifted outside the published "
              f"band: {bad}", file=sys.stderr)
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
                       help="scenario tag filter "
                            "(smoke/fig3/fig4/paper/h100/regime/tuned/"
                            "serve/prefix)")
        p.add_argument("--smoke", action="store_true",
                       help="only smoke-tagged scenarios")

    p = sub.add_parser("list", help="print registered scenarios (no run)")
    add_filters(p)
    p.set_defaults(fn=cmd_list)

    def add_measure(p):
        p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                       help="cuda: the hand-written kernels on the card "
                            "(default); cpu: their plain torch versions")
        p.add_argument("--repeats", type=int, default=5)
        p.add_argument("--warmup", type=int, default=1)
        p.add_argument("--no-check", action="store_true",
                       help="skip the ref-oracle correctness check")
        p.add_argument("--no-tuned", action="store_true",
                       help="ignore the tuning registry; seed defaults only")
        p.add_argument("--registry", default=None,
                       help="tuning registry JSON to resolve configs from "
                            "(default ./tuning_registry_torch.json or "
                            "$REPRO_TORCH_TUNING_REGISTRY)")
        p.add_argument("--json", default=None, metavar="PATH",
                       help="write the schema-v2 report ('-' for stdout; "
                            "progress then goes to stderr)")
        p.add_argument("--trace", default=None, metavar="PATH",
                       help="enable span tracing and write the span JSONL")
        p.add_argument("--chrome-trace", default=None, metavar="PATH",
                       help="enable span tracing and write a Perfetto/"
                            "chrome://tracing JSON")

    p = sub.add_parser("run", help="measure scenarios on the card")
    add_filters(p)
    add_measure(p)
    p.add_argument("--chip", default=None, choices=sorted(hardware.CATALOG),
                   help="provenance chip (default: the card's catalog row, "
                        "or TARGET on the CPU)")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("sweep",
                       help="measure + roofline-project across the lineage")
    add_filters(p)
    add_measure(p)
    p.add_argument("--chip", action="append", default=None,
                   choices=sorted(hardware.CATALOG), metavar="CHIP",
                   help="restrict the projection (repeatable; default: "
                        "every catalog chip)")
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("lineage",
                       help="validate catalog speedup expectations against "
                            "the committed published-number reference")
    p.add_argument("--reference", default=lineage.default_reference_path(),
                   metavar="PATH",
                   help="lineage-reference JSON "
                        "(default: experiments/baselines/"
                        "LINEAGE_hopper.json)")
    p.add_argument("--precision", default="f32", choices=("f32", "f64"),
                   help="precision for the lineage-arc chain rows "
                        "(reference pairs carry their own)")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="write the lineage-validation verdict document "
                        "('-' for stdout; progress then goes to stderr)")
    p.set_defaults(fn=cmd_lineage)

    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO if args.verbose
                        else logging.WARNING)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
