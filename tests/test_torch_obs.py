"""The port's observability (``obs.metrics``, ``obs.compare``, ``obs.cli``)
held to the reference package on the same reports, spans and metrics."""
import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.bench import results as ref_results                  # noqa: E402
from repro.obs import cli as ref_cli                            # noqa: E402
from repro.obs import compare as ref_compare                    # noqa: E402
from repro.obs import metrics as ref_metrics                    # noqa: E402
from repro.obs import trace as ref_trace                        # noqa: E402
from repro_torch import obs                                     # noqa: E402
from repro_torch.bench import results                           # noqa: E402
from repro_torch.obs import cli, compare, metrics, trace        # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
BENCH_CI = os.path.join(ROOT, "experiments", "baselines", "BENCH_ci.json")


def test_package_exports():
    assert obs.metrics is metrics and obs.compare is compare
    assert (compare.DEFAULT_K, compare.DEFAULT_REL_FLOOR,
            compare.HIT_RATIO_BAND) == (ref_compare.DEFAULT_K,
                                        ref_compare.DEFAULT_REL_FLOOR,
                                        ref_compare.HIT_RATIO_BAND)


# --- metrics ----------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_quantile_and_registry_match_reference(seed):
    rng = np.random.RandomState(seed)
    samples = sorted(rng.exponential(100.0, size=rng.randint(0, 40)).tolist())
    for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert metrics.quantile(samples, q) == ref_metrics.quantile(samples, q)
    values = rng.uniform(0, 50, size=30).tolist()
    snaps = []
    for mod in (metrics, ref_metrics):
        reg = mod.Registry()
        # a window of 16 samples: the ring overwrites the oldest
        window = mod.Histogram("window", (("host", "a"),), max_samples=16)
        for i, v in enumerate(values):
            reg.counter("tokens", slot=i % 3).inc(v)
            reg.gauge("queue", host="a").set(v)
            reg.histogram("ttft_ms").observe(v * (i + 1))
            window.observe(v)
        snaps.append((reg.to_dict(), window.snapshot(), window.samples()))
    assert snaps[0] == snaps[1]


# --- compare ----------------------------------------------------------------

def _measured(scenario, rng, kernel="stream", *, raw=True, serving=False):
    us = float(rng.uniform(50.0, 5000.0))
    m = {"us_median": us, "us_std": float(rng.uniform(0.0, 0.1)) * us}
    if raw:
        m["times_us"] = (us * rng.normal(1.0, 0.03,
                                         size=rng.randint(2, 9))).tolist()
    if serving:
        m["tokens_per_s"] = float(rng.uniform(100.0, 2000.0))
        m["cache_hit_ratio"] = float(rng.uniform(0.0, 1.0))
    return dict(scenario=scenario, kernel=kernel, shape=[8], dtype="float32",
                strategy="overlap", chip="H100-SXM", metrics=m,
                kind="measured", section="regime", backend="cuda")


def _reports(seed):
    """A seeded base report and a new one: the same cells moved by noise,
    one uniform host factor, two planted 2x regressions and a halving,
    a serving cell whose throughput and hit ratio move, a cell only in
    each report, and model rows (never gated)."""
    rng = np.random.RandomState(seed)
    base = [_measured(f"regime/k{i}/tma/d{i % 3 + 2}", rng,
                      raw=bool(i % 4), kernel=f"k{i}") for i in range(12)]
    base.append(_measured("serve/poisson/continuous", rng, "serve",
                          serving=True))
    base.append(_measured("regime/gone/sync", rng))
    base.append(dict(_measured("regime/k0/tma/d2", rng), kind="model",
                     chip="A100"))
    new = copy.deepcopy(base[:-2]) + [_measured("regime/added/sync", rng)]
    host = float(rng.uniform(0.8, 1.25))
    for i, row in enumerate(new):
        m = row["metrics"]
        scale = host * float(rng.normal(1.0, 0.01))
        scale *= {3: 2.0, 7: 2.0, 9: 0.5}.get(i, 1.0)
        m["us_median"] *= scale
        if "times_us" in m:
            m["times_us"] = [t * scale for t in m["times_us"]]
        if "tokens_per_s" in m:
            m["tokens_per_s"] /= scale * float(rng.uniform(0.8, 1.2))
            m["cache_hit_ratio"] = min(1.0, m["cache_hit_ratio"] +
                                       float(rng.uniform(-0.05, 0.05)))
    doc = lambda rows: {"schema_version": 2, "rows": rows}
    return doc(base), doc(new)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_compare_reports_match_reference(seed, normalize):
    base, new = _reports(seed)
    got = compare.compare_reports(
        results.BenchReport.from_dict(base),
        results.BenchReport.from_dict(new), normalize=normalize)
    want = ref_compare.compare_reports(
        ref_results.BenchReport.from_dict(base),
        ref_results.BenchReport.from_dict(new), normalize=normalize)
    assert got.to_dict() == want.to_dict()
    for verbose in (False, True):
        assert compare.format_compare(got, verbose=verbose) == \
            ref_compare.format_compare(want, verbose=verbose)
    counts = got.counts()
    assert counts["missing"] == counts["new"] == 1
    if normalize:
        assert got.n_regressions >= 2


@pytest.mark.parametrize("seed", range(4))
def test_cell_noise_matches_reference(seed):
    rng = np.random.RandomState(seed)
    for raw in (True, False):
        m = _measured("c", rng, raw=raw)["metrics"]
        assert compare.cell_noise_us(m) == ref_compare.cell_noise_us(m)


def test_compare_result_round_trip(tmp_path):
    base, new = _reports(0)
    res = compare.compare_reports(results.BenchReport.from_dict(base),
                                  results.BenchReport.from_dict(new))
    path = tmp_path / "verdicts.json"
    res.save(str(path))
    assert compare.CompareResult.load(str(path)).to_dict() == res.to_dict()
    assert ref_compare.CompareResult.load(str(path)).to_dict() == \
        res.to_dict()


def test_bench_ci_baseline_loads_as_it_is():
    got = results.BenchReport.load(BENCH_CI)
    want = ref_results.BenchReport.load(BENCH_CI)
    assert [r.to_dict() for r in got.results] == \
        [r.to_dict() for r in want.results]
    assert (got.generator, got.backend, got.jax_version) == \
        (want.generator, want.backend, want.jax_version)


def test_cli_compare_gate(tmp_path, capsys):
    """A report against itself passes (exit 0); the same report with one
    cell's median and trials doubled regresses that cell (exit 1)."""
    assert cli.main(["compare", BENCH_CI, BENCH_CI]) == 0
    assert "GATE: ok (0 regression(s))" in capsys.readouterr().out
    doc = json.load(open(BENCH_CI))
    # the cell with the narrowest band (3 trials: its std scaled to an IQR)
    row = min((r for r in doc["rows"] if r["kind"] == "measured"),
              key=lambda r: compare.cell_noise_us(r["metrics"])
              / r["metrics"]["us_median"])
    row["metrics"]["us_median"] *= 2
    row["metrics"]["times_us"] = [2 * t for t in row["metrics"]["times_us"]]
    planted = tmp_path / "planted.json"
    planted.write_text(json.dumps(doc))
    out = tmp_path / "verdicts.json"
    assert cli.main(["compare", BENCH_CI, str(planted), "--json",
                     str(out)]) == 1
    text = capsys.readouterr().out
    assert "GATE: REGRESSED (1 regression(s))" in text
    verdicts = json.loads(out.read_text())["rows"]
    assert [v["scenario"] for v in verdicts if v["verdict"] == "regress"] \
        == [row["scenario"]]
    assert ref_cli.main(["compare", BENCH_CI, str(planted)]) == 1
    assert capsys.readouterr().out == text.replace(
        f"# wrote verdicts to {out}\n", "")


# --- summary and export-trace -----------------------------------------------

def _spans(path):
    t = trace.Tracer()
    t.enable()
    with t.span("sweep", n=2):
        for name in ("scenario:a", "scenario:b"):
            with t.span(name, kernel="stream"):
                with t.span("oracle"):
                    pass
    t.save_jsonl(str(path))


def test_cli_summary_and_export_match_reference(tmp_path, capsys):
    spans = tmp_path / "t.jsonl"
    _spans(spans)
    reg = metrics.Registry()
    reg.counter("tokens", slot=0).inc(3)
    reg.histogram("ttft_ms").observe(12.5)
    snap = tmp_path / "m.json"
    reg.save(str(snap))
    outs = []
    for mod in (cli, ref_cli):
        chrome = tmp_path / f"{mod.__name__}.json"
        assert mod.main(["summary", "--trace", str(spans), "--metrics",
                         str(snap)]) == 0
        assert mod.main(["export-trace", str(spans), str(chrome)]) == 0
        outs.append(capsys.readouterr().out.replace(str(chrome), "OUT"))
        outs.append(json.loads(chrome.read_text())["traceEvents"])
    assert outs[0] == outs[2] and outs[1] == outs[3]
    assert "5 events" in outs[0] and "scenario:a" in outs[0]
    assert len(ref_trace.load_jsonl(str(spans))) == 5


def test_cli_import_loads_no_jax():
    code = ("import sys, repro_torch.obs.cli, repro_torch.obs.compare, "
            "repro_torch.bench.lineage, repro_torch.bench.regime; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.'))); assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
