"""The port's measurement path: timer rule, result rows the reference reads,
the whole slice on the CPU against the reference, and the CLI."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings                          # noqa: E402
from hypothesis import strategies as st                         # noqa: E402

from repro.bench import results as ref_results                  # noqa: E402
from repro.bench import runner as ref_runner                    # noqa: E402
from repro.bench import scenario as ref_scenario                # noqa: E402
from repro.bench import timing as ref_timing                    # noqa: E402
from repro_torch.bench import cli, runner, scenario, timing     # noqa: E402
from repro_torch.kernels import (flash_attention, hotspot,       # noqa: E402
                                 matmul, nw, pathfinder, stream)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU = runner.RunOptions(device="cpu", repeats=2, warmup=0)


@settings(max_examples=60, deadline=None)
@given(times=st.lists(st.floats(min_value=0.0, max_value=1e6,
                                allow_nan=False), max_size=24),
       k=st.sampled_from([0.0, 1.5, 3.0]))
def test_outlier_flags_match_reference(times, k):
    assert timing.outlier_flags(times, k) == ref_timing.outlier_flags(times, k)
    assert timing.reject_outliers(times, k) == \
        ref_timing.reject_outliers(times, k)


def test_time_callable_on_cpu_counts_calls():
    calls = []
    stats = timing.time_callable(lambda: calls.append(1), warmup=2,
                                 repeats=5, device="cpu")
    assert len(calls) == 7
    assert len(stats.times_us) + stats.n_outliers == 5
    assert set(stats.to_metrics()) >= {"us_median", "times_us", "n_trials"}


def test_port_report_loads_in_reference(tmp_path):
    sc = scenario.get_scenario("smoke/stream")
    report = runner.run_scenarios([sc], CPU)
    path = tmp_path / "bench.json"
    report.save(str(path))
    loaded = ref_results.BenchReport.load(str(path))
    assert len(loaded) == 1
    row = loaded.results[0]
    assert row.to_dict() == report.results[0].to_dict()
    assert (row.backend, row.interpret, row.jax_version) == ("cpu", False, "")
    assert row.chip == "H100-SXM" and row.config_source == "default"
    assert json.loads(path.read_text())["generator"] == "repro_torch.bench"


@pytest.mark.parametrize("name", ["smoke/stream", "fig3/stream/tma/iters=32",
                                  "fig4/hotspot/overlap", "smoke/pathfinder",
                                  "fig4/nw/register_bypass", "smoke/matmul",
                                  "smoke/flash_attention"])
def test_slice_matches_reference_on_shared_inputs(name):
    sc = scenario.get_scenario(name)
    kernels = (stream, hotspot, pathfinder, nw, flash_attention)
    for k in kernels:
        k.LAUNCHES = 0
    matmul.LAUNCHES.update(float32=0, bfloat16=0)
    row = runner.run_scenario(sc, CPU)
    assert row.metrics["check_ok"] is True
    assert [k.LAUNCHES for k in kernels] == [0] * len(kernels)
    assert set(matmul.LAUNCHES.values()) == {0}

    ref_sc = ref_scenario.get_scenario(name)
    assert (sc.kernel, sc.shape, sc.dtype, sc.workload) == \
        (ref_sc.kernel, ref_sc.shape, ref_sc.dtype, ref_sc.workload)
    ref_cfg = ref_runner.resolve_config(
        ref_sc, ref_runner.RunOptions(use_tuned=False))[0]
    cfg = runner.resolve_config(
        sc, runner.RunOptions(device="cpu", use_tuned=False))[0]
    assert cfg == scenario.config_from_reference(ref_cfg)
    ref_args = ref_sc.make_args()
    want = ref_scenario.call_kernel(ref_sc, ref_args, ref_cfg, True)
    args = scenario.args_from_numpy(sc.kernel,
                                    [np.asarray(a) for a in ref_args], "cpu")
    got = scenario.call_kernel(sc, args, cfg)
    tol = dict(stream=(1e-6, 1e-6), hotspot=(1e-5, 1e-3), pathfinder=(0, 0),
               nw=(0, 1e-4), matmul=(1e-4, 1e-3),
               flash_attention=(2e-5, 2e-5))[sc.kernel]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol[0],
                               atol=tol[1])


def test_h100_cells_are_hbm_scale():
    """Every h100 cell's working set exceeds 4x the 50 MB L2: stream,
    hotspot and lud hold 256 MiB matrices, pathfinder a 400.4 MB wall, nw
    its scores and its table, matmul 346.3 MB of A, B and C, flash
    attention 234.9 MB of q, k, v and out."""
    cells = scenario.scenarios(tag="h100")
    assert len(cells) == 40
    for sc in cells:
        if sc.kernel == "nw":
            n = sc.shape[0]
            nbytes = (n * n + (n + 1) ** 2) * 4
        elif sc.kernel == "matmul":
            m, k, n = sc.shape
            nbytes = (m * k + k * n) * 2 + m * n * 4
        elif sc.kernel == "flash_attention":
            b, h, kvh, s, d = sc.shape
            nbytes = (2 * b * h + 2 * b * kvh) * s * d * 4
        else:
            matrix = (sc.shape[0],) * 2 if sc.kernel == "lud" else sc.shape
            nbytes = np.prod(matrix) * 4
            if sc.kernel != "pathfinder":
                assert nbytes == 256 * 2 ** 20
        assert nbytes > 4 * 50e6


def test_run_on_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.run_scenario(scenario.get_scenario("smoke/stream"),
                            runner.RunOptions())
    assert cli.main(["run", "--only", "smoke/stream"]) == 2


def _cli(*argv):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.bench.cli",
                           *argv], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300)


def test_cli_list_and_cpu_run():
    out = _cli("list")
    assert out.returncode == 0, out.stderr
    assert "h100/hotspot/tma" in out.stdout and "# 133 scenarios" in out.stdout
    out = _cli("run", "--device", "cpu", "--only", "smoke/", "--repeats", "2",
               "--json", "-")
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout)
    assert [r["scenario"] for r in doc["rows"]] == [
        "smoke/flash_attention", "smoke/hotspot", "smoke/lud", "smoke/matmul",
        "smoke/nw", "smoke/pathfinder", "smoke/stream"]
    assert all(r["metrics"]["check_ok"] for r in doc["rows"])


def test_cli_run_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the default device works here")
    out = _cli("run", "--only", "smoke/stream")
    assert out.returncode == 2
    assert "no CUDA device" in out.stderr and "us_median" not in out.stdout


@pytest.mark.parametrize("name,chip", [("fig3/stream/overlap/iters=1", "A100"),
                                       ("fig4/hotspot/tma", "H100-SXM"),
                                       ("fig4/lud/drop_off", "H100-SXM"),
                                       ("fig4/pathfinder/drop_off",
                                        "H100-SXM"),
                                       ("smoke/hotspot", "TPUv5e"),
                                       ("smoke/matmul", "H100-SXM"),
                                       ("smoke/flash_attention", "A100")])
def test_projection_matches_reference(name, chip):
    got = runner.project_scenario(scenario.get_scenario(name), chip)
    want = ref_runner.project_scenario(
        ref_scenario.get_scenario(name), chip,
        ref_runner.RunOptions(use_tuned=False))
    assert got.kind == want.kind == "model"
    for key in ("predicted_us", "t_compute_us", "t_memory_us", "intensity",
                "bound"):
        assert got.metrics[key] == pytest.approx(want.metrics[key]), key
