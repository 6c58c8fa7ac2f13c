"""The port's kernels on CPU tensors (their plain torch versions) against the
reference's Pallas kernels in interpret mode, on the same numpy inputs.

On a CUDA tensor the same wrappers launch the hand-written kernels; those
are held to the plain versions on the card by ``chip_smoke.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                         # noqa: E402

from repro.core import Strategy as RefStrategy                  # noqa: E402
from repro.kernels import ops as ref_ops                        # noqa: E402
from repro_torch.bench.scenario import (args_from_numpy,        # noqa: E402
                                        config_from_reference)
from repro_torch.kernels import _build, hotspot, ops, stream    # noqa: E402

STRATEGIES = [s.value for s in RefStrategy]


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("shape", [(64, 128), (96, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_matches_reference(strategy, shape, dtype):
    x32 = _rng(0).uniform(size=shape).astype(np.float32)
    xj = jnp.asarray(x32).astype(dtype)
    want = ref_ops.stream(xj, iters=3, strategy=strategy, tile_rows=8,
                          n_tiles=4)
    (x,) = args_from_numpy("stream", [np.asarray(xj)], "cpu")
    assert x.dtype == getattr(torch, dtype)
    got = ops.stream(x, iters=3, strategy=strategy, tile_rows=8, n_tiles=4)
    assert got.dtype == x.dtype and tuple(got.shape) == shape
    tol = 1e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_stream_zero_iters_is_identity():
    x = torch.from_numpy(_rng(2).uniform(size=(32, 128)).astype(np.float32))
    got = ops.stream(x, iters=0)
    assert torch.equal(got, x)
    want = ref_ops.stream(jnp.asarray(x.numpy()), iters=0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("shape,grid", [((64, 126), 2), ((32, 128), 1)])
def test_hotspot_matches_reference(strategy, shape, grid):
    rng = _rng(3)
    temp = (rng.uniform(size=shape) * 100 + 300).astype(np.float32)
    power = rng.uniform(size=shape).astype(np.float32)
    want = ref_ops.hotspot(jnp.asarray(temp), jnp.asarray(power), iters=2,
                           strategy=strategy, grid=grid)
    t, p = args_from_numpy("hotspot", [temp, power], "cpu")
    got = ops.hotspot(t, p, iters=2, strategy=strategy, grid=grid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-3)


def test_hotspot_step_plain_matches_edge_clamped_oracle():
    from repro_torch.kernels import ref
    rng = _rng(4)
    temp = torch.from_numpy((rng.uniform(size=(16, 20)) * 100 + 300)
                            .astype(np.float32))
    power = torch.from_numpy(rng.uniform(size=(16, 20)).astype(np.float32))
    got = hotspot.hotspot_step_plain(hotspot.hotspot_step_plain(temp, power),
                                     power)
    torch.testing.assert_close(got, ref.hotspot_ref(temp, power, iters=2),
                               rtol=1e-6, atol=1e-4)


def test_cpu_calls_launch_nothing_and_build_nothing():
    stream.LAUNCHES = hotspot.LAUNCHES = 0
    x = torch.rand(64, 128)
    ops.stream(x, iters=2)
    ops.hotspot(x, x, iters=1)
    assert (stream.LAUNCHES, hotspot.LAUNCHES) == (0, 0)
    assert _build._libs == {}


@pytest.mark.parametrize("call", [
    lambda: ops.stream(torch.rand(60, 128), strategy="overlap"),
    lambda: ops.hotspot(torch.rand(60, 128), torch.rand(60, 128), grid=2),
    lambda: ops.hotspot(torch.rand(64, 128), torch.rand(64, 127)),
    lambda: stream.stream_cuda(torch.rand(32, 128, device="meta"))])
def test_invalid_calls_raise_value_error(call):
    with pytest.raises(ValueError):
        call()


def test_installed_default_falls_back_to_seed_on_value_error():
    x = torch.rand(64, 128)
    try:
        ops.set_default_config("stream", tile_rows=64)   # 64*4 rows > 64
        got = ops.stream(x, iters=1)
    finally:
        ops.reset_default_configs()
    torch.testing.assert_close(got, x * 0.5 + 0.5)
    assert ops.default_config("stream") == ops.seed_default_config("stream")
    with pytest.raises(ValueError):                      # explicit: no retry
        ops.stream(x, tile_rows=64)
    with pytest.raises(KeyError):
        ops.set_default_config("stream", grid=2)


def test_defaults_match_reference():
    assert set(ops.KERNEL_DEFAULTS) == set(ref_ops.KERNEL_DEFAULTS)
    for kernel in ops.KERNEL_DEFAULTS:
        assert ops.default_config(kernel) == config_from_reference(
            ref_ops.seed_default_config(kernel))


def test_build_without_nvcc_raises_runtime_error(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "isfile",
                        lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all(["stream"])


def test_build_digest_tracks_sources():
    a = _build._digest("stream")
    assert a == _build._digest("stream")
    assert a != _build._digest("hotspot")
    assert _build._target("stream").parent == _build.BUILD_DIR


def test_build_all_takes_another_source_tree(tmp_path):
    """A checkout's csrc copied elsewhere digests alike and builds into the
    directory it is given; an edited copy digests anew."""
    import shutil
    other = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, other)
    assert _build._digest("lud", other) == _build._digest("lud")
    assert _build._target("lud", other, tmp_path).parent == tmp_path
    (other / "async_pipeline.cuh").write_text("// edited\n")
    assert _build._digest("lud", other) != _build._digest("lud")


def test_wgmma_header_edit_rebuilds_matmul_and_flash(tmp_path):
    """The bf16 matmul and flash attention kernels share csrc/wgmma.cuh:
    an edit to it gives both libraries a new build hash, so both rebuild."""
    import shutil
    other = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, other)
    before = {n: _build._digest(n, other) for n in _build.SOURCES}
    assert (other / "wgmma.cuh").exists()
    for name in ("matmul", "flash_attention"):
        assert '#include "wgmma.cuh"' in (other / f"{name}.cu").read_text()
    (other / "wgmma.cuh").write_text(
        (other / "wgmma.cuh").read_text() + "// edited\n")
    after = {n: _build._digest(n, other) for n in _build.SOURCES}
    assert after["matmul"] != before["matmul"]
    assert after["flash_attention"] != before["flash_attention"]


def test_swapped_routes_a_library_and_restores():
    lib = object()
    with _build.swapped("lud", lib):
        assert _build._libs["lud"] is lib
    assert "lud" not in _build._libs


def test_ab_compares_sass_by_content_and_needs_a_card(tmp_path, capsys):
    from repro_torch.bench import ab
    base = {"_Z1fILi0EE": ["LDC R1", "EXIT"], "_Z1gv": ["NOP", "EXIT"]}
    here = {"_Z1f_renamedILi0EE": ["LDC R1", "EXIT"], "_Z1gv": ["EXIT"]}
    assert ab.compare_sass(base, here) == (1, ["_Z1gv"])
    assert ab.main([str(tmp_path)]) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("smi", ["reads", "missing", "garbled"])
def test_ab_reads_the_card_while_a_case_runs(smi, tmp_path, monkeypatch):
    """bench.ab's time lines carry nvidia-smi's SM clock (median) and power
    draw (most) read while the case ran; nothing without nvidia-smi or a
    reading it can parse."""
    import time
    from repro_torch.bench import ab
    if smi != "missing":
        tool = tmp_path / "nvidia-smi"
        tool.write_text("#!/bin/sh\necho '" + (
            "1980, 560.50" if smi == "reads" else "[N/A], [N/A]") + "'\n")
        tool.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))

    def case():
        time.sleep(0.3)
        return 7

    result, card = ab._card_during(case)
    assert result == 7
    assert card == ((1980.0, 560.5) if smi == "reads" else None)


@pytest.mark.parametrize("base", ["times", "lacks the launcher"])
def test_ab_turns_time_base_and_here_in_turns(base, monkeypatch):
    """A bench.ab time line measures base, here, here, base, with BASE's
    library swapped in for base's turns; a launcher BASE lacks
    (AttributeError) shows as its error, with here's times and here over
    the library call beside it."""
    from repro_torch.bench import ab
    monkeypatch.setattr(ab, "_card_during", lambda fn: (fn(), None))
    base_lib, turns = object(), []

    def measure():
        theirs = _build._libs.get("lud") is base_lib
        turns.append("base" if theirs else "here")
        if theirs and base == "lacks the launcher":
            raise AttributeError("lud_perimeters_launch")
        return 2.0 if theirs else 1.0

    line = ab._turns("lud perimeters n=8192 bs=32 both h=w=8160", "lud",
                     base_lib, measure, 4.0)
    assert "lud" not in _build._libs
    if base == "times":
        assert turns == ["base", "here", "here", "base"]
        assert line == ("time lud perimeters n=8192 bs=32 both h=w=8160: "
                        "base 2.0000 2.0000 ms, here 1.0000 1.0000 ms, "
                        "here/base 0.500, here/library 0.250")
    else:
        assert turns == ["base", "here", "here"]
        assert line == ("time lud perimeters n=8192 bs=32 both h=w=8160: "
                        "base AttributeError: lud_perimeters_launch, here "
                        "1.0000 1.0000 ms, here/library 0.250")


def test_ab_rounds_repeat_the_turns_and_give_their_spread(monkeypatch):
    """With rounds, a time line takes base, here, here, base that many
    times and adds here/base of each round (least, median, most), the
    medians, base's quartiles and the pairs here won."""
    from repro_torch.bench import ab
    monkeypatch.setattr(ab, "_card_during", lambda fn: (fn(), None))
    here_ms = iter([1.0, 1.0, 0.5, 0.5, 1.5, 1.5])
    turns = []

    def measure():
        theirs = _build._libs.get("hotspot") is base_lib
        turns.append("base" if theirs else "here")
        return 2.0 if theirs else next(here_ms)

    base_lib = object()
    line = ab._turns("hotspot tma", "hotspot", base_lib, measure, None,
                     rounds=3)
    assert turns == ["base", "here", "here", "base"] * 3
    assert line.endswith("here/base 0.500 (by round: least 0.250, "
                         "median 0.500, most 0.750; medians here 1.0000, "
                         "base 2.0000, base's quartiles 2.0000-2.0000; "
                         "here faster in 6 of 6 pairs)")


def test_ab_gives_base_lud_its_own_budget(tmp_path, monkeypatch):
    """Inside _base_budget a BASE's lud launches with the shared memory
    that BASE's own kernels/lud.py budgets (its K = bs body may lay its
    shared memory out otherwise), from a spec of BASE's PipelineSpec; with
    no BASE given, and outside the block, here's budget holds."""
    import shutil
    import sys
    from repro_torch.bench import ab
    from repro_torch.core.async_pipeline import PipelineSpec, Strategy
    from repro_torch.kernels import lud
    pkg = tmp_path / "src" / "repro_torch"
    shutil.copytree(_build.CSRC.parent, pkg,
                    ignore=shutil.ignore_patterns("csrc", "__pycache__"))
    with open(pkg / "kernels" / "lud.py", "a") as f:
        f.write("\n\ndef internal_smem(spec, k):\n"
                "    return 1000 * spec.ring_depth + k\n")
    monkeypatch.delitem(sys.modules, "_ab_base_repro_torch", raising=False)
    spec = PipelineSpec(Strategy.TMA, 3, None, 4)
    here = lud.internal_smem(spec, 32)
    with ab._base_budget("lud", None):
        assert lud.internal_smem(spec, 32) == here
    with ab._base_budget("lud", tmp_path):
        assert lud.internal_smem(spec, 32) == 3032
    assert lud.internal_smem(spec, 32) == here
    for name in [m for m in sys.modules if m.startswith("_ab_base_")]:
        monkeypatch.delitem(sys.modules, name)
    assert set(ab.BUSY) <= {case for _, case, _ in ab.CASES}


def test_ab_times_the_perimeters_once():
    """The perimeter case takes no strategy: it is in ONCE, not CASES."""
    from repro_torch.bench import ab
    assert [case for _, case, _ in ab.ONCE] == ["lud perimeters n=8192 bs=32"]
    assert not any("perimeter" in case for _, case, _ in ab.CASES)


@pytest.mark.parametrize("where", ["CUDA_HOME", "PATH", "neither"])
def test_cuobjdump_is_looked_for_where_nvcc_is(where, tmp_path, monkeypatch):
    """bench.sass finds cuobjdump under CUDA_HOME/bin or on PATH, like
    _build's nvcc (a CUDA_HOME without it does not hide the one on PATH),
    and raises RuntimeError where there is none."""
    from repro_torch.bench import sass
    home, on_path = tmp_path / "home", tmp_path / "path"
    for d in (home / "bin", on_path):
        d.mkdir(parents=True)
    tool = (home / "bin" if where == "CUDA_HOME" else on_path) / "cuobjdump"
    if where != "neither":
        tool.write_text("#!/bin/sh\n")
        tool.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setenv("PATH", str(on_path))
    real_isfile = sass.os.path.isfile
    monkeypatch.setattr(sass.os.path, "isfile", lambda p: str(p).startswith(
        str(tmp_path)) and real_isfile(p))
    if where == "neither":
        with pytest.raises(RuntimeError, match="cuobjdump not found"):
            sass.cuobjdump_path()
    else:
        assert sass.cuobjdump_path() == str(tool)
