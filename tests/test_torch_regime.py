"""The port's regime map, its regime and Fig. 3 cells, and ``sweep``, held
to the reference package on the same rows and scenarios."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.bench import regime as ref_regime                    # noqa: E402
from repro.bench import results as ref_results                  # noqa: E402
from repro.bench import runner as ref_runner                    # noqa: E402
from repro.bench import scenario as ref_scenario                # noqa: E402
from repro_torch.bench import (cli, regime, results, runner,    # noqa: E402
                               scenario)
from repro_torch.core import hardware                           # noqa: E402
from repro_torch.core.async_pipeline import (Strategy,          # noqa: E402
                                             parse_strategy)

ROOT = os.path.join(os.path.dirname(__file__), "..")
REF_REGIME = [sc.name for sc in ref_scenario.scenarios(tag="regime")]


# --- (a) regime_rows on the same measured rows -----------------------------

def _row(kernel, shape, strategy, us, depth=None, *, dtype="float32",
         section="regime", kind="measured"):
    return dict(
        scenario=f"regime/{kernel}/{strategy}" + (
            f"/d{depth}" if depth is not None else ""),
        kernel=kernel, shape=list(shape), dtype=dtype, strategy=strategy,
        chip="H100-SXM", metrics={} if us is None else {"us_median": us},
        config={} if depth is None else {"depth": depth},
        config_source="default+scenario", tuned_key=None, trace_id=None,
        kind=kind, section=section, interpret=False, backend="cuda",
        jax_version="", created_at="2026-01-01T00:00:00+00:00")


def _synthetic_rows(seed):
    """Seeded cells of every kernel, plus the edge cases: a cell with no
    sync row, one with no async row, one whose sync row has no time, best
    async at exactly -/+ PAYS_MARGIN, ties between depths, no depth that
    reaches sync (break_even_depth None), an async row with no depth (the
    default 2) and one with no time, two strategies at one depth, and rows
    the map ignores (another section, a model row)."""
    rng = np.random.RandomState(seed)
    margin = regime.PAYS_MARGIN
    rows = []
    for kernel in scenario.KERNELS:
        shape = tuple(int(v) for v in rng.randint(8, 4096, size=2))
        base = float(rng.uniform(10.0, 5000.0))
        rows.append(_row(kernel, shape, "sync", base))
        for depth in (2, 3, 4):
            for strat in ("overlap", "tma"):
                if rng.rand() < 0.8 or (strat, depth) == ("tma", 2):
                    rows.append(_row(kernel, shape, strat,
                                     base * float(rng.uniform(0.7, 1.3)),
                                     depth))
        # the same kernel and shape in another dtype is another cell
        rows.append(_row(kernel, shape, "sync", base, dtype="bfloat16"))
        rows.append(_row(kernel, shape, "tma", base * 0.5, 2,
                         dtype="bfloat16"))
    base = float(rng.uniform(10.0, 5000.0))
    edge = {
        "nosync": [("overlap", base, 2), ("tma", base, 3)],
        "noasync": [("sync", base, None)],
        "zerosync": [("sync", 0.0, None), ("overlap", base, 2)],
        "paysedge": [("sync", base, None),
                     ("overlap", base * (1.0 - margin), 2),
                     ("tma", base * 1.2, 3)],
        "hurtsedge": [("sync", base, None),
                      ("overlap", base * (1.0 + margin), 2)],
        "tie": [("sync", base, None), ("overlap", base * 0.9, 2),
                ("tma", base * 0.9, 3), ("overlap", base * 0.95, 4)],
        "never": [("sync", base, None), ("overlap", base * 1.1, 2),
                  ("tma", base * 1.3, 3), ("overlap", base * 1.01, 4)],
        "evenat3": [("sync", base, None), ("overlap", base * 1.1, 2),
                    ("tma", base, 3)],
        "nodepth": [("sync", base, None), ("overlap", base * 0.5, None),
                    ("tma", None, 3), ("tma", base * 0.6, 3),
                    ("overlap", base * 0.7, 3)],
    }
    for i, (name, cells) in enumerate(edge.items()):
        for strat, us, depth in cells:
            r = _row(name, (i + 1,), strat, us, depth)
            if name == "nodepth" and strat == "overlap" and depth is None:
                r["scenario"] += "/d2"
            rows.append(r)
    rows.append(_row("stream", (7, 7), "sync", base, section="fig3"))
    rows.append(_row("stream", (7, 7), "overlap", 1.0, 2, section="fig3"))
    rows.append(_row("stream", (7, 7), "sync", base, kind="model"))
    order = rng.permutation(len(rows))
    return [rows[i] for i in order]


def _verdicts(mod_regime, mod_results, rows):
    out = []
    for r in mod_regime.regime_rows(
            [mod_results.BenchResult.from_dict(dict(d)) for d in rows]):
        d = r.to_dict()
        d.pop("created_at")
        out.append(d)
    return out


@pytest.mark.parametrize("seed", range(8))
def test_regime_rows_match_reference(seed):
    assert regime.PAYS_MARGIN == ref_regime.PAYS_MARGIN
    rows = _synthetic_rows(seed)
    got = _verdicts(regime, results, rows)
    assert got == _verdicts(ref_regime, ref_results, rows)
    by_kernel = {d["kernel"]: d for d in got if d["dtype"] == "float32"}
    assert not {"nosync", "noasync", "zerosync"} & set(by_kernel)
    assert len(got) == 2 * len(scenario.KERNELS) + 6
    assert by_kernel["paysedge"]["metrics"]["verdict"] == "neutral"
    assert by_kernel["hurtsedge"]["metrics"]["verdict"] == "neutral"
    tie = by_kernel["tie"]["metrics"]
    assert (tie["best_depth"], tie["break_even_depth"]) == (2, 2)
    never = by_kernel["never"]["metrics"]
    assert never["break_even_depth"] is None
    assert never["verdict"] == "neutral" and never["best_depth"] == 4
    assert by_kernel["evenat3"]["metrics"]["break_even_depth"] == 3
    nodepth = by_kernel["nodepth"]
    assert nodepth["metrics"]["best_depth"] == 2
    assert nodepth["metrics"]["us_d3"] == pytest.approx(
        nodepth["metrics"]["baseline_us"] * 0.6)
    assert nodepth["metrics"]["verdict"] == "pays"
    assert all(d["scenario"] == f"regime/{d['kernel']}/map" for d in got)


# --- (b) the regime and Fig. 3 cells ---------------------------------------

def test_regime_names_match_reference():
    port = [sc.name for sc in scenario.scenarios(tag="regime")]
    assert port == REF_REGIME
    assert len(port) == 7 * len(scenario.KERNELS) == 49


@pytest.mark.parametrize("name", REF_REGIME)
def test_regime_cell_is_its_h100_cell_at_a_depth(name):
    sc = scenario.get_scenario(name)
    ref_sc = ref_scenario.get_scenario(name)
    assert sc.kernel == ref_sc.kernel
    assert sc.strategy is parse_strategy(ref_sc.strategy.value)
    h100 = scenario.get_scenario(f"h100/{sc.kernel}/{sc.strategy.value}")
    assert (sc.shape, sc.dtype, sc.workload) == \
        (h100.shape, h100.dtype, h100.workload)
    want = dict(h100.config)
    if "depth" in ref_sc.config:
        want["depth"] = ref_sc.config["depth"]
    assert sc.config == want
    assert (sc.tags, sc.section, sc.smoke) == (("regime",), "regime", False)


@pytest.mark.parametrize("strategy", list(Strategy), ids=lambda s: s.value)
def test_h100_stream_intensity_axis(strategy):
    sc = scenario.get_scenario(f"h100/stream/{strategy.value}/iters=32")
    base = scenario.get_scenario(f"h100/stream/{strategy.value}")
    ref_sc = ref_scenario.get_scenario(f"fig3/stream/{strategy.value}/iters=32")
    assert (sc.kernel, sc.shape, sc.dtype, sc.strategy) == \
        ("stream", (16384, 4096), "float32", strategy)
    assert sc.config == base.config == ref_sc.config
    assert sc.workload == ref_sc.workload == {"iters": 32}
    assert (sc.tags, sc.section) == (("h100",), "fig3")


# --- (c) sweep over the reference's regime cells, on the CPU ---------------

def _port_cell(ref_sc):
    return scenario.Scenario(
        name=ref_sc.name, kernel=ref_sc.kernel, shape=ref_sc.shape,
        dtype=ref_sc.dtype, strategy=parse_strategy(ref_sc.strategy.value),
        config=dict(ref_sc.config), workload=dict(ref_sc.workload),
        tags=ref_sc.tags, section=ref_sc.section)


@pytest.fixture(scope="module")
def smoke_sweep(tmp_path_factory):
    """The port's sweep on the CPU over the reference's regime cells (its
    smoke shapes), every catalog chip, and the report saved as JSON."""
    scs = [_port_cell(ref_scenario.get_scenario(n)) for n in REF_REGIME]
    emitted = []
    report = runner.sweep(scs, None, runner.RunOptions(
        device="cpu", repeats=2, emit=emitted.append))
    path = tmp_path_factory.mktemp("sweep") / "BENCH_sweep.json"
    report.save(str(path))
    return report, emitted, path


def test_sweep_counts(smoke_sweep):
    report, emitted, _ = smoke_sweep
    kinds = [r.kind for r in report.results]
    n_chips = len(hardware.CATALOG)
    assert (kinds.count("measured"), kinds.count("model"),
            kinds.count("regime")) == (49, 49 * n_chips, 7)
    assert [r.to_dict() for r in emitted] == \
        [r.to_dict() for r in report.results]
    assert all(r.metrics["check_ok"] for r in report.results
               if r.kind == "measured")
    assert {r.kernel for r in report.results if r.kind == "regime"} == \
        set(scenario.KERNELS)
    assert report.backend == "cpu"


@pytest.mark.parametrize("kernel", scenario.KERNELS)
def test_sweep_projection_matches_reference(smoke_sweep, kernel):
    report, _, _ = smoke_sweep
    opts = ref_runner.RunOptions(use_tuned=False)
    model = [r for r in report.results
             if r.kind == "model" and r.kernel == kernel]
    assert len(model) == 7 * len(hardware.CATALOG)
    for r in model:
        want = ref_runner.project_scenario(
            ref_scenario.get_scenario(r.scenario), r.chip, opts)
        assert (r.strategy, r.section, r.config) == (
            want.strategy, want.section, want.config)
        assert r.metrics["bound"] == want.metrics["bound"]
        for key in ("predicted_us", "t_compute_us", "t_memory_us",
                    "intensity"):
            assert r.metrics[key] == pytest.approx(want.metrics[key],
                                                   rel=1e-9), (r.scenario,
                                                               r.chip, key)


def test_sweep_verdicts_match_reference(smoke_sweep):
    report, _, _ = smoke_sweep
    rows = [r.to_dict() for r in report.results if r.kind != "regime"]
    got = [r for r in report.results if r.kind == "regime"]
    want = ref_regime.regime_rows(
        [ref_results.BenchResult.from_dict(d) for d in rows])
    strip = lambda d: {k: v for k, v in d.items() if k != "created_at"}
    assert [strip(r.to_dict()) for r in got] == \
        [strip(r.to_dict()) for r in want]


# --- (g) the sweep's JSON renders in the reference's report ----------------

def test_sweep_renders_in_make_report(smoke_sweep):
    _, _, path = smoke_sweep
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "experiments", "make_report.py"),
         "--bench", str(path), "--no-dryrun"], capture_output=True,
        text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "**Async regime map**" in out.stdout
    table = out.stdout.split("**Async regime map**")[1]
    for kernel in scenario.KERNELS:
        assert f"| {kernel} |" in table


# --- (h) no card: sweep on cuda runs nothing -------------------------------

def test_sweep_on_cuda_without_card_runs_nothing(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    emitted = []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.sweep([scenario.get_scenario("smoke/stream")], ["A100"],
                     runner.RunOptions(emit=emitted.append))
    assert emitted == []
    assert cli.main(["sweep", "--only", "smoke/stream"]) == 2
    out = capsys.readouterr()
    assert "no CUDA device" in out.err
    assert "measured" not in out.out and "# sweep" not in out.out


def test_sweep_rejects_unknown_chip():
    with pytest.raises(KeyError, match="unknown chip"):
        runner.sweep([scenario.get_scenario("smoke/stream")], ["H100"],
                     runner.RunOptions(device="cpu"))


def _cli(*argv):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.bench.cli",
                           *argv], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300)


def test_cli_sweep_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the default device works here")
    out = _cli("sweep", "--tag", "regime")
    assert out.returncode == 2
    assert "no CUDA device" in out.stderr and "us_median" not in out.stdout


def test_cli_sweep_on_cpu():
    out = _cli("sweep", "--device", "cpu", "--only", "smoke/", "--repeats",
               "2", "--chip", "A100", "--chip", "H100-SXM", "--json", "-")
    assert out.returncode == 0, out.stderr
    report = results.BenchReport.from_dict(json.loads(out.stdout))
    assert [r.kind for r in report.results].count("model") == 14
    assert {r.chip for r in report.results if r.kind == "model"} == \
        {"A100", "H100-SXM"}
    assert "# sweep: 7 measured rows + 14 model rows over 2 chips + 0 " \
        "regime verdicts" in out.stderr
