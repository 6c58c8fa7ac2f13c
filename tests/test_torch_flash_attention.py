"""The port's flash attention on CPU tensors (its plain torch version: the
reference's tiled online softmax with its KV pruning) against the
reference's Pallas kernel in interpret mode and the oracles, on the same
numpy inputs.

On a CUDA tensor the same wrapper launches csrc/flash_attention.cu; that
kernel is held to the plain version on the card by ``chip_smoke.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                         # noqa: E402

from repro.bench import scenario as ref_scenario                # noqa: E402
from repro.core import Strategy as RefStrategy                  # noqa: E402
from repro.kernels import ops as ref_ops                        # noqa: E402
from repro.kernels import ref as ref_ref                        # noqa: E402
from repro.tuning import search_space as ref_space              # noqa: E402
from repro_torch.bench import runner, scenario                  # noqa: E402
from repro_torch.bench.scenario import args_from_numpy          # noqa: E402
from repro_torch.kernels import _build, flash_attention, ops    # noqa: E402
from repro_torch.kernels import ref                             # noqa: E402
from repro_torch.tuning import search_space                     # noqa: E402

STRATEGIES = [s.value for s in RefStrategy]
#: the reference's tolerance (tests/test_kernels.py::test_flash_attention)
TOL = 2e-5


def _qkv(shape_q, shape_kv, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in (shape_q, shape_kv, shape_kv))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 256)])
@pytest.mark.parametrize("h,kvh", [(4, 2), (4, 4), (8, 1)])
def test_flash_matches_reference(strategy, causal, window, h, kvh):
    s, d = 256, 64
    q, k, v = _qkv((h, s, d), (kvh, s, d), 0)
    want = ref_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   window=window, strategy=strategy, bq=128,
                                   bk=128)
    tq, tk, tv = args_from_numpy("flash_attention", [q, k, v], "cpu")
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                              strategy=strategy, bq=128, bk=128)
    assert got.dtype == torch.float32 and tuple(got.shape) == (h, s, d)
    _close(got, want)
    kr, vr = (np.repeat(t, h // kvh, axis=0) for t in (k, v))
    _close(got, ref_ref.attention_ref(jnp.asarray(q), jnp.asarray(kr),
                                      jnp.asarray(vr), causal=causal,
                                      window=window))


def test_flash_batched_matches_reference():
    """Leading batch dims: the reference vmaps them, the port folds them
    into one call (one launch on the card)."""
    b, h, s, d = 2, 4, 256, 64
    q, k, v = _qkv((b, h, s, d), (b, 2, s, d), 1)
    want = ref_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v))
    got = ops.flash_attention(*args_from_numpy("flash_attention", [q, k, v],
                                               "cpu"))
    _close(got, want)
    _close(got, scenario.ORACLES["flash_attention"](
        tuple(torch.from_numpy(t) for t in (q, k, v)), {}))


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 96),
                                           (False, 200)])
def test_attention_ref_matches_reference_oracle(causal, window):
    q, k, v = _qkv((3, 64, 32), (3, 64, 32), 2)
    got = ref.attention_ref(*(torch.from_numpy(t) for t in (q, k, v)),
                            causal=causal, window=window, scale=0.3)
    _close(got, ref_ref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal,
                                      window=window, scale=0.3))


@pytest.mark.parametrize("bk", [32, 64, 128])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 100),
                                           (False, 300)])
def test_plain_tiles_match_oracle(bk, causal, window):
    """The plain version's pruned online softmax, at other tile widths,
    equals the dense oracle."""
    q, k, v = (torch.from_numpy(t) for t in _qkv((2, 3, 512, 64),
                                                  (2, 1, 512, 64), 3))
    got = flash_attention.flash_attention_plain(q, k, v, causal=causal,
                                                window=window, bq=128, bk=bk)
    want = scenario.ORACLES["flash_attention"](
        (q, k, v), {"causal": causal, "window": window})
    _close(got, want)


def test_kv_range_prunes_exactly_the_masked_tiles():
    """[lo, hi) are exactly the KV tiles a q block's mask lets any entry
    of through (the reference's formula)."""
    s, bq = 1024, 128
    for bk in (64, 128, 256):
        for causal, window in ((True, 0), (False, 0), (True, 200),
                               (False, 300)):
            for q0 in range(0, s, bq):
                lo, hi = flash_attention.kv_range(q0, s, bq, bk, causal,
                                                  window)
                qi = np.arange(q0, q0 + bq)[:, None]
                kv = np.arange(s)[None, :]
                keep = np.ones((bq, s), bool)
                if causal:
                    keep &= kv <= qi
                if window > 0:
                    keep &= kv > qi - window
                tiles = np.flatnonzero(keep.reshape(bq, s // bk, bk)
                                       .any(axis=(0, 2)))
                assert (lo, hi) == (tiles.min(), tiles.max() + 1)
    assert flash_attention.kv_range(512, 4096, 128, 128, True, 256) == (2, 5)
    assert flash_attention.kv_range(3968, 4096, 128, 128, True, 0) == (0, 32)


@pytest.mark.parametrize("call", [
    lambda: ops.flash_attention(torch.zeros(2, 200, 64), torch.zeros(2, 200, 64),
                                torch.zeros(2, 200, 64)),
    lambda: ops.flash_attention(torch.zeros(3, 256, 64), torch.zeros(2, 256, 64),
                                torch.zeros(2, 256, 64)),
    lambda: ops.flash_attention(torch.zeros(2, 256, 64), torch.zeros(2, 128, 64),
                                torch.zeros(2, 128, 64)),
    lambda: flash_attention.flash_attention_cuda(
        *(torch.zeros(2, 256, 64, device="meta"),) * 3)])
def test_invalid_calls_raise_value_error(call):
    with pytest.raises(ValueError):
        call()


def test_non_divisible_seq_raises_like_reference():
    q = np.zeros((2, 192, 64), np.float32)
    with pytest.raises(ValueError, match="must divide"):
        ref_ops.flash_attention(*(jnp.asarray(q),) * 3, bq=128, bk=128)
    with pytest.raises(ValueError, match="must divide"):
        ops.flash_attention(*(torch.from_numpy(q),) * 3, bq=128, bk=128)


@pytest.mark.parametrize("shape", [(2, 256, 64), (12, 4096, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_spec_matches_reference(shape, dtype):
    """(h, s, d) is the reference's model; (b, h, kvh, s, d) is the same
    model per batch and q head."""
    spec, want = search_space.SPECS["flash_attention"], \
        ref_space.SPECS["flash_attention"]
    cfg = ops.default_config("flash_attention")
    ref_fb = want.flops_bytes(shape, dtype, cfg)
    assert spec.flops_bytes(shape, dtype, cfg) == pytest.approx(ref_fb)
    assert spec.n_tiles(shape, cfg) == want.n_tiles(shape, cfg)
    h, s, d = shape
    for b, kvh in ((1, h), (4, 2)):
        assert spec.flops_bytes((b, h, kvh, s, d), dtype, cfg) == \
            pytest.approx(tuple(b * x for x in ref_fb))
        assert spec.n_tiles((b, h, kvh, s, d), cfg) == want.n_tiles(shape, cfg)
    q, k, v = spec.make_args((2, 4, 2, 128, 64), dtype,
                             torch.Generator().manual_seed(0), "cpu")
    assert tuple(q.shape) == (2, 4, 128, 64)
    assert tuple(k.shape) == tuple(v.shape) == (2, 2, 128, 64)
    assert q.dtype == getattr(torch, dtype) and abs(float(q.float().mean())) < 0.1


def test_h100_cell_work():
    """h100/flash_attention: 206.2 GFLOP (the causal half) on 234.9 MB of
    q, k, v and out."""
    sc = scenario.get_scenario("h100/flash_attention/overlap")
    b, h, kvh, s, d = sc.shape
    assert (sc.dtype, sc.workload) == ("float32", {"causal": True, "window": 0})
    assert 2 * b * h * s * s * d == 206_158_430_208
    assert (2 * b * h + 2 * b * kvh) * s * d * 4 == 234_881_024
    assert (h, kvh, d) == (12, 2, 128)


def test_cpu_calls_launch_nothing_and_build_nothing():
    flash_attention.LAUNCHES = 0
    q = torch.rand(2, 4, 128, 64)
    ops.flash_attention(q, q[:, :2], q[:, :2])
    ops.flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16(), window=64)
    assert flash_attention.LAUNCHES == 0
    assert _build._libs == {}


def test_smoke_cell_matches_reference():
    sc = scenario.get_scenario("smoke/flash_attention")
    ref_sc = ref_scenario.get_scenario("smoke/flash_attention")
    assert (sc.kernel, sc.shape, sc.dtype, sc.workload) == \
        (ref_sc.kernel, ref_sc.shape, ref_sc.dtype, ref_sc.workload)
    row = runner.run_scenario(sc, runner.RunOptions(device="cpu", repeats=2,
                                                    warmup=0))
    assert row.metrics["check_ok"] is True and row.metrics["max_err"] < TOL


def test_check_sees_a_skipped_kv_tile(monkeypatch):
    """The flash check at its tolerance passes a sound result and fails one
    whose q blocks each skipped their first KV tile."""
    sc = scenario.get_scenario("h100/flash_attention/overlap")
    sc = scenario.Scenario(name="test/flash", kernel="flash_attention",
                           shape=(1, 4, 2, 512, 64), workload=sc.workload)
    args = sc.make_args("cpu", seed=5)
    tol = scenario.CHECK_TOL["flash_attention"]
    plain = flash_attention.flash_attention_plain
    assert scenario.check_output(sc, args, plain(*args)) < TOL
    kv_range = flash_attention.kv_range
    monkeypatch.setattr(flash_attention, "kv_range",
                        lambda *a: (kv_range(*a)[0] + 1, kv_range(*a)[1]))
    assert scenario.check_output(sc, args, plain(*args)) > 10 * tol
