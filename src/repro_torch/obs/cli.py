"""Observability command line for the port.

    PYTHONPATH=src python -m repro_torch.obs.cli summary --trace t.jsonl
    PYTHONPATH=src python -m repro_torch.obs.cli summary --metrics m.json
    PYTHONPATH=src python -m repro_torch.obs.cli export-trace t.jsonl t.chrome.json
    PYTHONPATH=src python -m repro_torch.obs.cli compare BASE.json NEW.json

``summary`` aggregates a span JSONL (per-name count/total/p50) and/or
pretty-prints a metrics snapshot.  ``export-trace`` converts a span JSONL
to Chrome trace-event JSON loadable at https://ui.perfetto.dev.
``compare`` is the noise-aware regression gate over two schema-v2
BENCH_*.json reports — exit code 1 when any cell regresses beyond its
measured noise band, so CI can gate on it directly.  The counterpart of
``repro.obs.cli`` without its ``profile`` command (an XLA report); all
three commands are pure stdlib.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List


def _fail(msg: str) -> "SystemExit":
    return SystemExit(f"error: {msg}")


# ---------------------------------------------------------------------------
# summary
# ---------------------------------------------------------------------------

def _span_summary(path: str, stream) -> None:
    from .metrics import quantile
    from .trace import load_jsonl
    spans = load_jsonl(path)
    if not spans:
        print(f"(no spans in {path})", file=stream)
        return
    by_name: dict = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s.dur_us)
    t0 = min(s.t0_us for s in spans)
    t1 = max(s.t1_us for s in spans)
    print(f"{len(spans)} spans over {(t1 - t0) / 1e3:.1f}ms "
          f"(trace {spans[0].trace_id})", file=stream)
    print(f"{'name':<28s} {'count':>6s} {'total_ms':>10s} "
          f"{'p50_us':>12s} {'max_us':>12s}", file=stream)
    rows = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))
    for name, durs in rows:
        durs = sorted(durs)
        print(f"{name:<28s} {len(durs):>6d} {sum(durs) / 1e3:>10.2f} "
              f"{quantile(durs, 0.5):>12.1f} {durs[-1]:>12.1f}",
              file=stream)


def _metrics_summary(path: str, stream) -> None:
    with open(path) as f:
        doc = json.load(f)
    rows = doc.get("rows", [])
    if not rows:
        print(f"(no metric rows in {path})", file=stream)
        return
    print(f"{'metric':<26s} {'kind':<10s} {'labels':<24s} value", file=stream)
    for r in rows:
        labels = ",".join(f"{k}={v}"
                          for k, v in sorted(r.get("labels", {}).items()))
        if r["kind"] == "histogram":
            val = (f"n={r['count']} mean={r['mean']:.2f} "
                   f"p50={r['p50']:.2f} p99={r['p99']:.2f}")
        else:
            val = f"{r['value']}"
        print(f"{r['name']:<26s} {r['kind']:<10s} {labels:<24s} {val}",
              file=stream)


def cmd_summary(args) -> int:
    if not args.trace and not args.metrics:
        raise _fail("summary needs --trace and/or --metrics")
    if args.trace:
        _span_summary(args.trace, sys.stdout)
    if args.metrics:
        if args.trace:
            print()
        _metrics_summary(args.metrics, sys.stdout)
    return 0


# ---------------------------------------------------------------------------
# export-trace
# ---------------------------------------------------------------------------

def cmd_export_trace(args) -> int:
    from .trace import chrome_trace, load_jsonl
    spans = load_jsonl(args.jsonl)
    doc = chrome_trace(spans)
    with open(args.out, "w") as f:
        json.dump(doc, f)
    print(f"wrote {len(doc['traceEvents'])} events to {args.out} "
          f"(load in https://ui.perfetto.dev)")
    return 0


# ---------------------------------------------------------------------------
# compare
# ---------------------------------------------------------------------------

def cmd_compare(args) -> int:
    from .compare import compare_reports, format_compare
    from ..bench.results import BenchReport
    base = BenchReport.load(args.base)
    new = BenchReport.load(args.new)
    res = compare_reports(base, new, k=args.k, rel_floor=args.rel_floor,
                          normalize=args.normalize)
    print(format_compare(res, base_path=args.base, new_path=args.new,
                         verbose=args.verbose))
    if args.json:
        res.save(args.json)
        print(f"# wrote verdicts to {args.json}")
    return 1 if res.n_regressions else 0


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------

def main(argv: List[str] = None) -> int:
    from .compare import DEFAULT_K, DEFAULT_REL_FLOOR
    ap = argparse.ArgumentParser(prog="repro_torch.obs.cli",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("summary",
                       help="aggregate a span JSONL / metrics snapshot")
    p.add_argument("--trace", default=None, metavar="JSONL",
                   help="span JSONL written by --trace / save_jsonl")
    p.add_argument("--metrics", default=None, metavar="JSON",
                   help="metrics snapshot written by Registry.save")
    p.set_defaults(fn=cmd_summary)

    p = sub.add_parser("export-trace",
                       help="span JSONL -> Chrome/Perfetto trace JSON")
    p.add_argument("jsonl")
    p.add_argument("out")
    p.set_defaults(fn=cmd_export_trace)

    p = sub.add_parser("compare",
                       help="noise-aware regression gate over two "
                            "BENCH_*.json (exit 1 on regression)")
    p.add_argument("base", help="baseline schema-v2 report")
    p.add_argument("new", help="candidate schema-v2 report")
    p.add_argument("-k", type=float, default=DEFAULT_K,
                   help="noise-band width in IQRs (default %(default)s)")
    p.add_argument("--rel-floor", type=float, default=DEFAULT_REL_FLOOR,
                   help="minimum band as a fraction of the baseline median "
                        "(default %(default)s)")
    p.add_argument("--normalize", action="store_true",
                   help="divide out the global median new/base ratio first "
                        "(absorbs a uniformly faster/slower host)")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="write the verdicts as JSON to PATH")
    p.add_argument("--verbose", action="store_true",
                   help="print every cell, not just non-pass verdicts")
    p.set_defaults(fn=cmd_compare)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
