"""Flash attention's backward on the CPU: ``flash_attention_bwd_plain`` (the
backward kernel's function, step for step: each row's softmax statistics
over the forward's KV tiles, then dK/dV and dQ tile by tile) against
autograd through ``flash_attention_plain`` and against ``jax.grad`` of the
reference's attention (``repro.kernels.ref.attention_ref`` for MHA,
``repro.models.attention.attend_chunked`` for GQA), on the same numpy
inputs and output gradient; and ``FlashAttention``, the autograd Function
the model routes through, against autograd through the chunked route.

csrc/flash_attention_bwd.cu is held to the plain version on the card by
``chip_smoke.py`` (phase 12); its bf16 design's arithmetic is replayed in
tests/test_torch_flash_backward_replay.py.

Tolerance: 1e-4 of the largest gradient value.  Both sides compute in f32
and sum in orders of their own (the reference's dense softmax and its
transposes; the plain version's 128-row tiles): about 1e-6 of it apart."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import attention_ref
from repro.models import attention as ref_attn
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as attn

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests: they run many small
    torch ops, which the default pool (a thread a core) slows many times
    over when several test processes share the cores (see
    tests/test_torch_flash_replay.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, tol=TOL):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got.detach().double() if isinstance(got, torch.Tensor)
                     else got, dtype=np.float64)
    lim = tol * max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=lim)


def _inputs(seed, h, kvh, s, d):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((h, s, d), (kvh, s, d), (kvh, s, d), (h, s, d))]


def _bwd(q, k, v, dout, **kw):
    """The plain backward of the plain forward on numpy (H, S, D) inputs."""
    q, k, v, dout = map(torch.from_numpy, (q, k, v, dout))
    o = fa.flash_attention_plain(q, k, v, **kw)
    return fa.flash_attention_bwd_plain(q, k, v, o, dout, **kw)


@pytest.mark.parametrize("h,kvh,s,d,causal,window,kv_len", [
    (4, 2, 256, 64, True, 0, None), (2, 2, 256, 64, False, 0, None),
    (6, 1, 384, 32, True, 96, None), (4, 4, 256, 16, False, 0, 200),
    (4, 2, 384, 16, True, 96, 200)],
    ids=["causal-g2", "non-causal", "window-g6", "kv_len", "window-kv_len"])
def test_plain_backward_matches_autograd_through_plain_forward(
        h, kvh, s, d, causal, window, kv_len):
    """float64 inputs: the plain backward (in float64) against autograd
    through the plain forward (which computes in f32), rows whose every
    key is masked (window-kv_len) included."""
    q, k, v, dout = (torch.from_numpy(a).double()
                     for a in _inputs(0, h, kvh, s, d))
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = fa.flash_attention_plain(*leaves, **kw)
    o.backward(dout.float())
    got = fa.flash_attention_bwd_plain(q, k, v, o.detach().double(), dout,
                                       **kw)
    for g, t in zip(got, leaves):
        assert g.dtype == torch.float64
        _close(g, t.grad.numpy(), 1e-5)


@pytest.mark.parametrize("causal,window,s,d", [
    (True, 0, 256, 64), (False, 0, 256, 64), (True, 96, 384, 64),
    (False, 200, 256, 128)],
    ids=["causal", "non-causal", "window", "non-causal-window"])
def test_plain_backward_matches_jax_grad_of_reference_mha(causal, window, s,
                                                          d):
    q, k, v, dout = _inputs(1, 2, 2, s, d)

    def f(q_, k_, v_):
        return jnp.sum(attention_ref(q_, k_, v_, causal=causal,
                                     window=window) * dout)
    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = _bwd(q, k, v, dout, causal=causal, window=window)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("causal,kv_len", [(False, 200), (True, 130)],
                         ids=["non-causal", "causal"])
def test_plain_backward_with_kv_len_matches_reference_on_the_true_rows(
        causal, kv_len):
    """S = 256 padded past a key count: the true rows' gradients are the
    reference's over the first kv_len rows, the padding gets none (its
    output gradient is 0, as the model's slicing gives it)."""
    q, k, v, dout = _inputs(2, 4, 4, 256, 64)
    dout[:, kv_len:] = 0.0
    n = kv_len

    def f(q_, k_, v_):
        return jnp.sum(attention_ref(q_, k_, v_, causal=causal) * dout[:, :n])
    want = jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(t[:, :n]) for t in (q, k, v)))
    got = _bwd(q, k, v, dout, causal=causal, kv_len=kv_len)
    for g, w in zip(got, want):
        _close(g[:, :n], w)
        assert not g[:, n:].any()


@pytest.mark.parametrize("h,kvh,causal,window,s", [
    (4, 2, True, 0, 256), (6, 1, True, 96, 384), (4, 2, False, 0, 256),
    (6, 3, True, 0, 128)],
    ids=["g2-causal", "g6-window", "g2-non-causal", "g2-one-tile"])
def test_plain_backward_matches_jax_grad_of_reference_gqa(h, kvh, causal,
                                                          window, s):
    """GQA: q head h reads kv head h // (H / KV); dK and dV sum over each
    KV head's group.  The reference: jax.grad of its attend_chunked
    (B, S, H, D) in f32."""
    q, k, v, dout = _inputs(3, h, kvh, s, 64)
    idx = jnp.asarray(np.arange(h) // (h // kvh), jnp.int32)

    def f(q_, k_, v_):
        out = ref_attn.attend_chunked(
            q_[None].transpose(0, 2, 1, 3), k_[None].transpose(0, 2, 1, 3),
            v_[None].transpose(0, 2, 1, 3), idx, causal=causal,
            window=window, chunk=64)
        return jnp.sum(out[0].transpose(1, 0, 2) * dout)
    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = _bwd(q, k, v, dout, causal=causal, window=window)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("hd,s", [(64, 200), (96, 100)],
                         ids=["d64", "d96-padded-to-128"])
def test_model_route_on_the_card_matches_jax_grad_of_reference(
        monkeypatch, hd, s):
    """attend_chunked(impl="flash") where it would launch the kernel (a
    patched ``_on_card``): S padded up to 128 rows with the key count S, hd
    96 zero-padded to 128 at the scale of 96, through ``FlashAttention``;
    the gradients of q, k and v (B, S, H, hd) are jax.grad of the
    reference's attend_chunked."""
    monkeypatch.setattr(attn, "_on_card", lambda x: True)
    rng = np.random.default_rng(4)
    q, k, v, dout = (rng.normal(size=shape).astype(np.float32) for shape in
                     ((2, s, 4, hd), (2, s, 2, hd), (2, s, 2, hd),
                      (2, s, 4, hd)))
    idx = np.arange(4) // 2

    def f(q_, k_, v_):
        return jnp.sum(ref_attn.attend_chunked(
            q_, k_, v_, jnp.asarray(idx, jnp.int32), causal=True, window=0,
            chunk=64) * dout)
    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    out = attn.attend_chunked(*leaves, attn.kv_index_map(4, 2, 4),
                              causal=True, window=0, chunk=64, impl="flash")
    (out * torch.from_numpy(dout)).sum().backward()
    for t, w in zip(leaves, want):
        _close(t.grad, w)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 96),
                                           (False, 0)])
def test_function_gradients_equal_the_chunked_routes(causal, window):
    """``FlashAttention`` (forward and backward plain on the CPU) under
    autograd against autograd through attend_chunked(impl="chunked"), on
    (B, S, H, D) = (2, 256, 6, 64) over 3 kv heads."""
    rng = np.random.default_rng(5)
    arrays = [rng.normal(size=(2, 256, h, 64)).astype(np.float32)
              for h in (6, 3, 3)]
    dout = torch.from_numpy(rng.normal(size=(2, 256, 6, 64))
                            .astype(np.float32))
    kw = dict(causal=causal, window=window, chunk=64)
    idx = attn.kv_index_map(6, 3, 6)
    want = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    (attn.attend_chunked(*want, idx, impl="chunked", **kw)
     * dout).sum().backward()
    got = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    q, k, v = (t.transpose(1, 2) for t in got)
    out = fa.FlashAttention.apply(q, k, v, causal, window, None, 256)
    (out.transpose(1, 2) * dout).sum().backward()
    for g, w in zip(got, want):
        _close(g.grad, w.grad.numpy())


def test_bwd_wrapper_checks_its_arguments():
    q = torch.zeros(2, 128, 64)
    with pytest.raises(ValueError, match="shaped as q"):
        fa.flash_attention_bwd_cuda(q, q, q, q[:1], q)
    with pytest.raises(ValueError, match="divide"):
        fa.flash_attention_bwd_cuda(torch.zeros(3, 128, 64),
                                    torch.zeros(2, 128, 64),
                                    torch.zeros(2, 128, 64),
                                    torch.zeros(3, 128, 64),
                                    torch.zeros(3, 128, 64))
    fa.BWD_LAUNCHES = 0
    fa.flash_attention_bwd_cuda(q, q, q, q, q)
    assert fa.BWD_LAUNCHES == 0                 # the CPU: no kernel


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fault", [None, "no HMMA", "local memory",
                                   "f32 local memory", "missing", "no HGMMA",
                                   "no UTMALDG"])
def test_chip_smoke_bwd_sass_check_fails_what_the_design_forbids(
        monkeypatch, capsys, fault):
    """chip_smoke's SASS check of the backward library: 12 kernels, the f32
    design's 6 with HMMA (3xTF32 mma.sync), the bf16 design's 6 with HGMMA
    (wgmma) and UTMALDG (TMA), none with local memory; each fault fails
    it."""
    mod = _chip_smoke()
    f32 = [f"_ZN6fa_bwd{len(k) + 7}fa_bwd_{k}ILi{d}EEEv"
           for k in ("prep", "dkdv", "dq") for d in (64, 128)]
    bf16 = [f"_ZN8fa_bwd16{len(k) + 9}fa_bwd16_{k}I{t}Li{d}EEEv"
            for k, t in (("rows", "Li0E"), ("dkdv", ""), ("rows", "Li1E"))
            for d in (64, 128)]
    counts = {n: dict.fromkeys(mod.SASS_OPS, 0) | {"HMMA": 288, "FFMA": 16}
              for n in f32}
    counts |= {n: dict.fromkeys(mod.SASS_OPS, 0) | {"HGMMA": 52,
                                                     "UTMALDG": 10}
               for n in bf16}
    if fault == "no HMMA":
        counts[f32[3]]["HMMA"] = 0
    if fault == "local memory":
        counts[bf16[3]]["STL"] = 2
    if fault == "f32 local memory":
        counts[f32[3]]["LDL"] = 4
    if fault == "missing":
        del counts[bf16[5]]
    if fault == "no HGMMA":
        counts[bf16[1]]["HGMMA"] = 0
    if fault == "no UTMALDG":
        counts[bf16[4]]["UTMALDG"] = 0
    monkeypatch.setattr(mod, "sass_counts", lambda path: counts)
    mod.check_bwd_sass("libflash_attention_bwd.so")
    out = capsys.readouterr().out
    assert "sass flash_attention_bwd fa_bwd_prepILi64EEEv: " in out
    assert "sass flash_attention_bwd fa_bwd16_dkdvILi128EEEv: " in out
    assert bool(mod.FAILURES) == (fault is not None)


def test_ab_times_the_backward_once_through_each_sides_wrapper():
    """bench.ab's backward cases: bf16 and f32 at the flash cell, bf16 at
    phase 12's layer shape, each timed once (no strategy) through each
    side's own kernels/flash_attention.py, beside SDPA's backward."""
    from repro_torch.bench import ab
    cases = [c for lib, c, _ in ab.CASES if lib == "flash_attention_bwd"]
    assert cases == [
        "flash_attention_bwd bf16 (4, 12, 2, 4096, 128) causal",
        "flash_attention_bwd f32 (4, 12, 2, 4096, 128) causal",
        "flash_attention_bwd bf16 (4, 12, 2, 512, 128) causal"]
    assert "flash_attention_bwd" in ab.STRATEGY_FREE
    assert ab.OWN_WRAPPER["flash_attention_bwd"] == "fa_bwd"
    assert ab.WRAPPER_MODULE["flash_attention_bwd"] == "flash_attention"
