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
    for kernel in ("stream", "hotspot"):
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
