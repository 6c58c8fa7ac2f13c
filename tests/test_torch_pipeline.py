"""The port's pipeline spec, chip catalog and shared-memory model against the
reference package's, value for value."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.core import async_pipeline as ref_ap                 # noqa: E402
from repro.core import hardware as ref_hw                       # noqa: E402
from repro.tuning import search_space as ref_ss                 # noqa: E402
from repro_torch.core import async_pipeline as ap               # noqa: E402
from repro_torch.core import hardware as hw                     # noqa: E402

STRATEGY_NAMES = [s.value for s in ref_ap.Strategy]


@pytest.mark.parametrize("wait_group", [None, 0, 1, 2, 3, 4])
@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("strategy", STRATEGY_NAMES)
def test_ring_depth_and_ahead_match_reference(strategy, depth, wait_group):
    want = ref_ap.PipelineSpec(strategy, depth, wait_group)
    got = ap.PipelineSpec(strategy, depth, wait_group)
    assert got.strategy.value == want.strategy.value
    assert (got.ring_depth, got.ahead) == (want.ring_depth, want.ahead)


def test_strategy_order_matches_reference():
    # the CUDA launchers take a strategy's index in ALL_STRATEGIES
    assert [s.value for s in ap.ALL_STRATEGIES] == \
        [s.value for s in ref_ap.ALL_STRATEGIES]


@pytest.mark.parametrize("text", ["sync", "SYNC", " Overlap ", "tma",
                                  "drop_off", "Register_Bypass", "", "dropoff",
                                  "async", "tma2"])
def test_parse_strategy_accepts_and_rejects_like_reference(text):
    try:
        want = ref_ap.parse_strategy(text).value
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            ap.parse_strategy(text)
        assert str(got.value) == str(e)
    else:
        assert ap.parse_strategy(text).value == want


@pytest.mark.parametrize("config", [
    {}, {"strategy": "tma", "depth": 3},
    {"strategy": "drop_off", "depth": "4", "wait_group": "1",
     "out_depth": 3, "tile_rows": 8},
    {"strategy": "sync", "wait_group": 0}])
def test_from_config_matches_reference(config):
    want = ref_ap.PipelineSpec.from_config(config)
    got = ap.PipelineSpec.from_config(config)
    assert (got.strategy.value, got.depth, got.wait_group, got.out_depth) == \
        (want.strategy.value, want.depth, want.wait_group, want.out_depth)


@pytest.mark.parametrize("bad", [dict(depth=0), dict(wait_group=-1),
                                 dict(out_depth=0)])
def test_spec_rejects_like_reference(bad):
    with pytest.raises(ValueError):
        ref_ap.PipelineSpec(**bad)
    with pytest.raises(ValueError):
        ap.PipelineSpec(**bad)


def test_catalog_rows_match_reference():
    assert set(ref_hw.CATALOG) <= set(hw.CATALOG)
    for name, chip in ref_hw.CATALOG.items():
        assert dataclasses.asdict(hw.CATALOG[name]) == \
            dataclasses.asdict(chip), name
    assert hw.TARGET.name == "H100-SXM"


@pytest.mark.parametrize("name,limit,want", [
    ("NVIDIA H100 80GB HBM3", "", "H100-SXM"),
    ("NVIDIA H100 PCIe", "", "H100-PCIe"),
    ("NVIDIA H100", "700.00 W", "H100-SXM"),
    ("NVIDIA H100", "350.00 W", "H100-PCIe"),
    ("NVIDIA A100-SXM4-80GB", "400.00 W", None),
    ("NVIDIA H100 NVL", "400.00 W", None),
    ("NVIDIA H100", "", None)])
def test_detect_chip(monkeypatch, name, limit, want):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: name)
    monkeypatch.setattr(hw, "card_power_limit", lambda i=0: limit)
    if want is None:
        with pytest.raises(RuntimeError, match="--chip"):
            hw.detect_chip()
    else:
        assert hw.detect_chip() == want


def _variants(configs):
    for cfg in configs:
        for od in (1, 2, 3, 4):
            yield {**cfg, "out_depth": od}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smem_budget_matches_stream_vmem_model(dtype):
    shape = (512, 256)
    isz = torch.tensor([], dtype=getattr(torch, dtype)).element_size()
    for cfg in _variants(ref_ss._stream_configs(shape)):
        tile = cfg["tile_rows"] * shape[1] * isz
        spec = ap.PipelineSpec.from_config(
            {**cfg, "strategy": cfg["strategy"].value})
        got = ap.smem_budget(spec, [tile], tile)
        sync = cfg["strategy"] is ref_ap.Strategy.SYNC
        single = cfg["strategy"] in (ref_ap.Strategy.SYNC,
                                     ref_ap.Strategy.REGISTER_BYPASS)
        assert got.in_ring == (1 if single else cfg["depth"]) * tile
        assert got.staging == (tile if sync else 0)
        assert got.out_ring == cfg["out_depth"] * tile
        assert got.total == ref_ss._stream_vmem(shape, dtype, cfg)


@pytest.mark.parametrize("shape", [(256, 256), (64, 126)])
def test_smem_budget_matches_hotspot_vmem_model(shape):
    _, cols = shape
    for cfg in _variants(ref_ss._hotspot_configs(shape)):
        t_tile = (cfg["tile_rows"] + 2) * (cols + 2) * 4
        p_tile = cfg["tile_rows"] * cols * 4
        spec = ap.PipelineSpec.from_config(
            {**cfg, "strategy": cfg["strategy"].value})
        got = ap.smem_budget(spec, [t_tile, p_tile], p_tile)
        sync = cfg["strategy"] is ref_ap.Strategy.SYNC
        single = cfg["strategy"] in (ref_ap.Strategy.SYNC,
                                     ref_ap.Strategy.REGISTER_BYPASS)
        assert got.in_ring == (1 if single else cfg["depth"]) \
            * (t_tile + p_tile)
        assert got.staging == ((t_tile + p_tile) if sync else 0)
        assert got.out_ring == cfg["out_depth"] * p_tile
        assert got.total == ref_ss._hotspot_vmem(shape, "float32", cfg)


def test_card_smem_drops_sync_ring_and_adds_tma_barriers():
    sync = ap.smem_budget(ap.PipelineSpec("sync"), [100], 10)
    assert sync.card == sync.total - sync.in_ring
    tma = ap.smem_budget(ap.PipelineSpec("tma", depth=3), [100], 10)
    assert tma.card == tma.total + 3 * 8
