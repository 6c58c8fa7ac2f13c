"""The port's autotuner (repro_torch.tuning) held to the reference's
(repro.tuning): enumeration, predictions and pruning on the same shapes,
the registry's records read across both packages, the autotuner on the
CPU's plain versions, the runner's tuned configs and the CLI."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.bench import runner as ref_runner                    # noqa: E402
from repro.bench import scenario as ref_scenario                # noqa: E402
from repro.core import hardware as ref_hardware                 # noqa: E402
from repro.tuning import registry as ref_registry               # noqa: E402
from repro.tuning import search_space as ref_space              # noqa: E402
from repro_torch.bench import cli as bench_cli                  # noqa: E402
from repro_torch.bench import runner, scenario                  # noqa: E402
from repro_torch.core.async_pipeline import (PipelineSpec,      # noqa: E402
                                             Strategy)
from repro_torch.kernels import ops                             # noqa: E402
from repro_torch.obs import trace                               # noqa: E402
from repro_torch.tuning import (Autotuner, Measurement,         # noqa: E402
                                Registry, SCHEMA_VERSION,
                                SchemaMismatch, SearchSpace,
                                TuningRecord, TuningTask,
                                apply_registry_defaults,
                                decode_config, default_task, make_key,
                                search_space, tuned)
from repro_torch.tuning import cli as tuning_cli                # noqa: E402

H100 = "H100-SXM"
#: each kernel's h100 cell: (shape, dtype)
H100_CELLS = {sc.kernel: (sc.shape, sc.dtype)
              for sc in scenario.scenarios(tag="tuned")}


def _encode(cfg):
    return {k: getattr(v, "value", v) for k, v in cfg.items()}


def _key(cfg):
    return json.dumps(_encode(cfg), sort_keys=True)


def _ref_shape(kernel, shape):
    """The reference's shape for a port shape: flash attention's
    (b, h, kvh, s, d) is (b * h, s, d) there, the same model terms."""
    if kernel == "flash_attention" and len(shape) == 5:
        b, h, _, s, d = shape
        return (b * h, s, d)
    return shape


def _cases():
    for kernel, spec in search_space.SPECS.items():
        yield kernel, "default", spec.default_shape, "float32"
        shape, dtype = H100_CELLS[kernel]
        yield kernel, "h100", shape, dtype


CASES = list(_cases())
CASE_IDS = [f"{k}-{where}" for k, where, _, _ in CASES]


# --- enumeration and predictions --------------------------------------------

def test_tuned_cells_cover_every_kernel():
    assert sorted(H100_CELLS) == sorted(search_space.KERNELS)
    for sc in scenario.scenarios(tag="tuned"):
        pinned = scenario.get_scenario(f"h100/{sc.kernel}/sync")
        assert sc.name == f"tuned/{sc.kernel}" and sc.section == "tuned"
        assert (sc.shape, sc.dtype) == (pinned.shape, pinned.dtype)
        assert sc.strategy is None and sc.config == {}
        assert "h100" not in sc.tags
        want = {"iters": search_space.STREAM_ITERS} if sc.kernel == "stream" \
            else pinned.workload
        assert sc.workload == want


@pytest.mark.parametrize("kernel,where,shape,dtype", CASES, ids=CASE_IDS)
def test_enumeration_and_predictions_match_reference(kernel, where, shape,
                                                     dtype):
    ref_sh = _ref_shape(kernel, shape)
    want = ref_space.SPECS[kernel].enumerate_configs(ref_sh)
    got = search_space.SPECS[kernel].enumerate_configs(shape)
    assert [_encode(c) for c in got] == [_encode(c) for c in want]
    assert len(got) > 0
    ref = ref_space.SearchSpace(kernel, ref_sh, dtype,
                                chip=ref_hardware.get_chip(H100))
    space = SearchSpace(kernel, shape, dtype)
    for c_got, c_want in zip(space.candidates(), ref.candidates()):
        assert c_got.predicted_us == pytest.approx(c_want.predicted_us,
                                                   rel=1e-9)


def test_h100_candidate_counts():
    """The reference's enumerations at the h100 shapes: 15 (strategy,
    depth, wait group) shapes times the tiles that divide."""
    counts = {k: len(SearchSpace(k, *H100_CELLS[k]).candidates())
              for k in search_space.KERNELS}
    assert counts == {"stream": 135, "hotspot": 45, "pathfinder": 30,
                      "nw": 45, "lud": 45, "matmul": 120,
                      "flash_attention": 60}
    assert len(search_space.strategy_depth_waits(Strategy.OVERLAP)) == 5
    assert search_space.strategy_depth_waits(Strategy.TMA) == (
        (2, None), (3, None), (4, None))


# --- pruning by the card ----------------------------------------------------

class _Replay(ref_space.SearchSpace):
    """The reference's pruning on its own candidates less ``refused``, with
    no VMEM limit (the card's check takes its place)."""

    def __init__(self, refused, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.refused = refused
        self.vmem_limit = float("inf")

    def candidates(self):
        return [c for c in super().candidates()
                if _key(c.config) not in self.refused]


LIMITS = ("shared memory", "registers", "blocks are", "bq=", "sub-tile",
          "MAX_TILE_ROWS", "built for")


@pytest.mark.parametrize("kernel,where,shape,dtype", CASES, ids=CASE_IDS)
def test_pruning_is_the_reference_less_card_refusals(kernel, where, shape,
                                                     dtype):
    space = SearchSpace(kernel, shape, dtype)
    survivors, dropped = space.pruned()
    card = [c for c in dropped if c.why_pruned.startswith("card: ")]
    for c in card:
        assert any(limit in c.why_pruned for limit in LIMITS), c.why_pruned
        with pytest.raises(ValueError):
            space.spec.check_card(shape, dtype, c.config,
                                  PipelineSpec.from_config(c.config))
    for c in survivors:
        assert space.card_refusal(c.config) is None
        assert 0 < c.vmem_bytes
    refused = {_key(c.config) for c in card}
    replay = _Replay(refused, kernel, _ref_shape(kernel, shape), dtype,
                     chip=ref_hardware.get_chip(H100))
    want, _ = replay.pruned()
    assert [_encode(c.config) for c in survivors] == \
        [_encode(c.config) for c in want]


def test_card_refusals_at_the_h100_shapes():
    """What the reference enumerates and the card refuses at the h100
    shapes: matmul's 256-wide blocks, flash's bq 256, hotspot's DROP_OFF
    above 8 rows and its rings past 227 KB at 32 rows."""
    refused = {}
    for kernel in search_space.KERNELS:
        _, dropped = SearchSpace(kernel, *H100_CELLS[kernel]).pruned()
        refused[kernel] = [c for c in dropped
                           if c.why_pruned.startswith("card: ")]
    assert {k: len(v) for k, v in refused.items()} == {
        "stream": 0, "hotspot": 16, "pathfinder": 0, "nw": 0, "lud": 0,
        "matmul": 90, "flash_attention": 30}
    assert all((c.config["bm"], c.config["bn"]) != (128, 128)
               for c in refused["matmul"])
    assert all(c.config["bq"] == 256 for c in refused["flash_attention"])
    hs = refused["hotspot"]
    assert sum(c.strategy is Strategy.DROP_OFF for c in hs) == 10
    assert all(c.config["tile_rows"] == 32 and "shared memory" in
               c.why_pruned for c in hs if c.strategy is not Strategy.DROP_OFF)


@pytest.mark.parametrize("check,args", [
    ("stream", (4096, torch.float16, PipelineSpec(), 8)),
    ("stream", (4094, torch.float32, PipelineSpec(), 8)),
    ("stream", (4096, torch.float32, PipelineSpec(Strategy.DROP_OFF), 64)),
    ("nw", (torch.int32, PipelineSpec(), 8)),
    ("nw", (torch.float32, PipelineSpec(Strategy.DROP_OFF), 32)),
    ("nw", (torch.float32, PipelineSpec(), 128)),
    ("lud", (torch.bfloat16, PipelineSpec(), 32)),
    ("lud", (torch.float32, PipelineSpec(), 128)),
    ("flash_attention", (128, torch.float16, PipelineSpec(), 128, 128)),
    ("flash_attention", (96, torch.float32, PipelineSpec(), 128, 128)),
    ("flash_attention", (128, torch.float32, PipelineSpec(), 256, 128)),
    ("flash_attention", (128, torch.float32, PipelineSpec(), 128, 48)),
])
def test_card_checks_refuse_on_the_cpu(check, args):
    from repro_torch.kernels import flash_attention, lud, nw, stream
    mod = dict(stream=stream, nw=nw, lud=lud,
               flash_attention=flash_attention)[check]
    with pytest.raises(ValueError):
        mod.check_card_config(*args)


def test_card_checks_take_the_seed_configs_at_the_h100_shapes():
    for kernel in search_space.KERNELS:
        space = SearchSpace(kernel, *H100_CELLS[kernel])
        assert space.card_refusal(ops.seed_default_config(kernel)) is None


# --- registry ---------------------------------------------------------------

def _record(kernel="stream", shape=(64, 128), chip="TPUv5e"):
    cfg = {"strategy": "overlap", "tile_rows": 8, "n_tiles": 4, "depth": 2}
    return TuningRecord(
        kernel=kernel, shape=list(shape), dtype="float32", chip=chip,
        best=cfg, best_us=12.5, default_us=20.0, speedup_vs_default=1.6,
        measurements=[Measurement(config=cfg, us_median=12.5, us_mean=13.0,
                                  us_min=12.0, us_std=0.5, n_trials=5,
                                  predicted_us=10.0)],
        n_candidates=1, n_pruned=0)


def test_registry_round_trip(tmp_path):
    path = str(tmp_path / "reg.json")
    rec = _record()
    Registry(path).put(rec)
    reg2 = Registry(path)
    got = reg2.get("stream", (64, 128), "float32", "TPUv5e")
    assert got is not None and got.to_dict() == rec.to_dict()
    assert got.key == make_key("stream", (64, 128), "float32", "TPUv5e") \
        == "stream|64x128|float32|TPUv5e|interpret"
    assert reg2.get("stream", (64, 129), "float32", "TPUv5e") is None
    assert reg2.get("stream", (64, 128), "bfloat16", "TPUv5e") is None


def test_registry_schema_mismatch_ignored_and_strict(tmp_path):
    path = str(tmp_path / "reg.json")
    with open(path, "w") as f:
        json.dump({"schema_version": SCHEMA_VERSION + 999,
                   "records": {"stream|64x128|float32|TPUv5e": {"junk": 1}}},
                  f)
    reg = Registry(path)
    assert len(reg) == 0
    with pytest.raises(SchemaMismatch):
        Registry(path, strict=True).load()
    reg.put(_record())
    with open(path) as f:
        assert json.load(f)["schema_version"] == SCHEMA_VERSION == 2


def test_registry_concurrent_saves_merge(tmp_path):
    path = str(tmp_path / "reg.json")
    a, b = Registry(path), Registry(path)
    a.load(), b.load()
    a.put(_record(kernel="stream"))
    b.put(_record(kernel="matmul"))
    assert {r.kernel for r in Registry(path).records()} == {"stream",
                                                            "matmul"}


def test_registry_save_does_not_revert_unwritten_keys(tmp_path):
    path = str(tmp_path / "reg.json")
    Registry(path).put(_record(kernel="stream"))
    a = Registry(path)
    a.load()
    newer = _record(kernel="stream")
    newer.best_us = 1.0
    Registry(path).put(newer)
    a.put(_record(kernel="matmul"))
    fresh = Registry(path)
    assert fresh.get("stream", (64, 128), "float32", "TPUv5e").best_us == 1.0
    assert fresh.get("matmul", (64, 128), "float32", "TPUv5e") is not None


def test_registry_corrupt_file_reads_as_empty(tmp_path):
    path = tmp_path / "reg.json"
    path.write_text("{not json")
    assert len(Registry(str(path))) == 0


def test_compiled_and_interpret_records_do_not_collide(tmp_path):
    reg = Registry(str(tmp_path / "reg.json"))
    card = _record(chip=H100)
    card.interpret, card.best_us = False, 1.0
    reg.put(_record(chip=H100))
    reg.put(card)
    assert len(reg) == 2
    assert reg.get("stream", (64, 128), "float32", H100).best_us == 12.5
    assert reg.get("stream", (64, 128), "float32", H100,
                   interpret=False).best_us == 1.0
    assert card.key.endswith("|compiled")


def test_records_cross_both_packages(tmp_path):
    rec = _record(chip=H100)
    rec.interpret = False
    ref_rec = ref_registry.TuningRecord.from_dict(rec.to_dict())
    assert ref_rec.key == rec.key and ref_rec.to_dict() == rec.to_dict()
    back = TuningRecord.from_dict(ref_rec.to_dict())
    assert back.to_dict() == rec.to_dict()
    # the files too: a reference registry's file reads in the port
    path = str(tmp_path / "ref.json")
    ref_registry.Registry(path).put(ref_rec)
    assert Registry(path).get("stream", (64, 128), "float32", H100,
                              interpret=False).to_dict() == rec.to_dict()
    assert ref_registry.SCHEMA_VERSION == SCHEMA_VERSION


def test_default_registry_is_the_ports_own(monkeypatch):
    from repro_torch.tuning import registry
    monkeypatch.delenv(registry.REGISTRY_ENV, raising=False)
    assert registry.default_registry_path() == "tuning_registry_torch.json"
    assert registry.default_registry_path() != \
        ref_registry.default_registry_path()
    monkeypatch.setenv("REPRO_TORCH_TUNING_REGISTRY", "/x/r.json")
    assert registry.default_registry_path() == "/x/r.json"


# --- the autotuner on the CPU's plain versions ------------------------------

@pytest.fixture
def fresh_defaults():
    yield
    ops.reset_default_configs()


@pytest.mark.parametrize("kernel,shape", [("stream", (64, 128)),
                                          ("pathfinder", (33, 128))])
def test_tune_then_lookup(tmp_path, fresh_defaults, kernel, shape):
    reg = Registry(str(tmp_path / "reg.json"))
    tuner = Autotuner(reg, warmup=1, repeats=2)
    task = default_task(kernel, shape=shape, device="cpu")
    assert task.interpret and task.chip == H100
    rec = tuner.tune(task)
    ok = [m for m in rec.measurements if m.error is None]
    assert len(ok) == len(rec.measurements) == rec.n_candidates > 0
    assert rec.best_us == min(m.us_median for m in ok) > 0
    assert rec.default_us > 0 and rec.speedup_vs_default >= 1.0
    assert rec.key.endswith("|interpret") and rec.jax_version == ""
    measured = {_key(m.config) for m in rec.measurements}
    survivors, _ = task.space.pruned()
    assert {_key(c.config) for c in survivors} <= measured

    mtime = os.path.getmtime(reg.path)
    again = tuner.tune(task)                    # a cache hit
    assert again.to_dict() == rec.to_dict()
    assert os.path.getmtime(reg.path) == mtime

    cfg = tuned(kernel, shape, registry=reg)
    assert cfg == decode_config(rec.best)
    assert isinstance(cfg["strategy"], Strategy)
    assert tuned(kernel, (shape[0] * 2, shape[1]), registry=reg) == \
        ops.seed_default_config(kernel)
    assert tuned(kernel, shape, registry=reg, interpret=False,
                 fallback_to_default=False) is None

    applied = apply_registry_defaults(reg)
    assert applied == {kernel: cfg}
    assert ops.default_config(kernel) == {**ops.seed_default_config(kernel),
                                          **cfg}
    ops.reset_default_configs()
    assert ops.default_config(kernel) == ops.seed_default_config(kernel)


def test_tune_spans(tmp_path):
    t = trace.tracer()
    t.clear()
    t.enable()
    try:
        rec = Autotuner(Registry(str(tmp_path / "r.json")), warmup=0,
                        repeats=1).tune(default_task(
                            "pathfinder", shape=(17, 64), device="cpu"))
    finally:
        t.disable()
    names = [s.name for s in t.spans()]
    t.clear()
    assert names.count("tune:pathfinder") == 1
    assert names.count("candidate") == len(rec.measurements)


def test_task_workload_overrides_the_spec():
    task = TuningTask("hotspot", (32, 64), device="cpu",
                      workload={"iters": 3, "grid": 2})
    temp, power = task.make_args()
    cfg = ops.seed_default_config("hotspot")
    got = task.call((temp, power), cfg)
    want = ops.hotspot(temp, power, iters=3, grid=2, **cfg)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    one = TuningTask("hotspot", (32, 64), device="cpu").call((temp, power),
                                                              cfg)
    assert not torch.equal(one, got)


def test_task_on_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_task("stream")


def test_tuned_default_invalid_for_shape_falls_back_to_seed(fresh_defaults):
    ops.set_default_config("stream", tile_rows=32, n_tiles=8)    # block 256
    x = torch.rand(64, 128)
    torch.testing.assert_close(ops.stream(x, iters=1), x * 0.5 + 0.5)
    with pytest.raises(ValueError):
        ops.stream(x, iters=1, tile_rows=32, n_tiles=8)


# --- the runner's tuned configs ---------------------------------------------

def _both_registries(tmp_path, rec):
    reg = Registry(str(tmp_path / "port.json"))
    reg.put(rec)
    ref_reg = ref_registry.Registry(str(tmp_path / "ref.json"))
    ref_reg.put(ref_registry.TuningRecord.from_dict(rec.to_dict()))
    return reg, ref_reg


@pytest.mark.parametrize("name,source", [
    ("smoke/stream", "tuned"),
    ("fig3/stream/tma/iters=32", "tuned+scenario"),
    ("fig4/hotspot/overlap", "tuned+scenario")])
def test_resolve_config_matches_reference(tmp_path, name, source):
    sc = scenario.get_scenario(name)
    rec = _record(kernel=sc.kernel, shape=sc.shape, chip=H100)
    if sc.kernel == "hotspot":
        rec.best = {"strategy": "tma", "tile_rows": 16, "depth": 3}
    reg, ref_reg = _both_registries(tmp_path, rec)
    got = runner.resolve_config(sc, runner.RunOptions(device="cpu",
                                                      registry=reg))
    want = ref_runner.resolve_config(
        ref_scenario.get_scenario(name),
        ref_runner.RunOptions(registry=ref_reg, chip=H100, interpret=True))
    assert got[0] == scenario.config_from_reference(want[0])
    assert got[1:] == want[1:] == (source, rec.key)
    # a card's record does not answer the CPU's lookup, nor the reverse
    off = runner.resolve_config(sc, runner.RunOptions(device="cpu",
                                                      use_tuned=False))
    assert off[1:] == (source.replace("tuned", "default"), None)


def test_refused_merge_raises(tmp_path):
    """An overlap winner at hotspot tile_rows 16 under h100/hotspot/
    drop_off: DROP_OFF holds 8 rows; the runner raises, never swaps."""
    sc = scenario.get_scenario("h100/hotspot/drop_off")
    rec = _record(kernel="hotspot", shape=sc.shape, chip=H100)
    rec.best = {"strategy": "overlap", "tile_rows": 16, "depth": 2,
                "wait_group": None, "out_depth": 2}
    reg, _ = _both_registries(tmp_path, rec)
    opts = runner.RunOptions(device="cpu", registry=reg)
    with pytest.raises(ValueError, match="h100/hotspot/drop_off") as e:
        runner.resolve_config(sc, opts)
    assert rec.key in str(e.value) and "DROP_OFF" in str(e.value)
    # the unpinned cell takes the record whole
    cfg, source, key = runner.resolve_config(
        scenario.get_scenario("tuned/hotspot"), opts)
    assert (cfg["tile_rows"], source, key) == (16, "tuned", rec.key)


def test_run_reports_the_tuned_source(tmp_path):
    sc = scenario.get_scenario("smoke/pathfinder")
    rec = _record(kernel="pathfinder", shape=sc.shape, chip=H100)
    rec.best = {"strategy": "sync", "tile_rows": 16, "depth": 2,
                "wait_group": None}
    reg, _ = _both_registries(tmp_path, rec)
    row = runner.run_scenario(sc, runner.RunOptions(
        device="cpu", registry=reg, repeats=1, warmup=0))
    assert (row.config_source, row.tuned_key) == ("tuned", rec.key)
    assert row.config["tile_rows"] == 16 and row.metrics["check_ok"]


# --- the command lines ------------------------------------------------------

def test_tuning_cli_on_the_cpu(tmp_path, capsys):
    path = str(tmp_path / "r.json")
    argv = ["tune", "--kernel", "stream", "--device", "cpu", "--shape",
            "64,128", "--repeats", "2", "--registry", path]
    assert tuning_cli.main(argv) == 0
    assert "tuned in" in capsys.readouterr().out
    assert tuning_cli.main(argv) == 0
    assert "cache hit" in capsys.readouterr().out
    assert tuning_cli.main(["--registry", path, "-v", "show"]) == 0
    out = capsys.readouterr().out
    assert "stream" in out and "64x128" in out and "pred=" in out
    csv_path = tmp_path / "t.csv"
    assert tuning_cli.main(["--registry", path, "export", "--format", "csv",
                            "--out", str(csv_path)]) == 0
    lines = csv_path.read_text().splitlines()
    rec = Registry(path).records()[0]
    assert lines[0].startswith("kernel,shape,dtype,chip,config,us_median")
    assert len(lines) == 1 + len(rec.measurements)
    assert tuning_cli.main(["--registry", str(tmp_path / "none.json"),
                            "show"]) == 1
    assert tuning_cli.main(["tune", "--all", "--shape", "64,128",
                            "--device", "cpu"]) == 2


def test_tuning_cli_on_cuda_without_card(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "r.json"
    assert tuning_cli.main(["tune", "--kernel", "stream", "--registry",
                            str(path)]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not path.exists()


def test_bench_cli_tuned_and_no_tuned(tmp_path, capsys):
    sc = scenario.get_scenario("smoke/stream")
    rec = _record(kernel="stream", shape=sc.shape, chip=H100)
    reg, _ = _both_registries(tmp_path, rec)
    base = ["run", "--device", "cpu", "--only", "smoke/stream", "--repeats",
            "1", "--registry", reg.path, "--json", "-"]
    assert bench_cli.main(base) == 0
    row = json.loads(capsys.readouterr().out)["rows"][0]
    assert (row["config_source"], row["tuned_key"]) == ("tuned", rec.key)
    assert bench_cli.main(base + ["--no-tuned"]) == 0
    row = json.loads(capsys.readouterr().out)["rows"][0]
    assert (row["config_source"], row["tuned_key"]) == ("default", None)
    assert np.isfinite(row["metrics"]["us_median"])
