"""The port's recurrent families on CPU tensors against the reference's:
the blocks of ``repro.models.ssm`` (mLSTM, sLSTM, Mamba) on the same numpy
inputs and weights, the xlstm-1.3b (ssm) and hymba-1.5b (hybrid) smoke
models on the reference's weights (``load_reference_params``), and their
greedy tokens under the cohort scheduler, to which serving falls back.

Tolerances.  A block in fp32 is the same arithmetic in another order:
1e-5.  The port's own equivalences (chunkwise against stepwise, chunk
sizes) hold the reference's own tolerances for them
(tests/test_models.py: 2e-4, Mamba 2e-3).  A whole model in fp32: 1e-4, the
other dense archs' tolerance (tests/test_torch_models.py).  A whole model in
bf16: each framework rounds its products and elementwise results to bf16 on
its own, and these models' untied unembedding gives logits of up to ~4
(the tied qwen2's are 0.5), so a rounding flip in a hidden value moves a
logit by up to 0.24 (xlstm; 0.11 hymba): the reference's own bf16 logits
differ from its fp32 ones by up to 0.45 (xlstm; 0.13 hymba) on the same
inputs.  So the bf16 check holds the relative l2 of the difference to
3e-2 (the dense models' 3e-2, on the whole logits: 0.015 seen) and each
value to 1.5 times the reference's own bf16 - fp32 difference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.core.config import ArchConfig as RefArchConfig
from repro.core.config import SSMConfig as RefSSMConfig
from repro.distributed.sharding import split_tree as ref_split_tree
from repro.launch.serve import ServingLoop as RefServingLoop
from repro.models import build_model as ref_build_model
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_tfm
from repro.serve import Request as RefRequest
from repro_torch.configs import get_smoke_config
from repro_torch.core.config import ArchConfig, SSMConfig
from repro_torch.distributed import split_tree
from repro_torch.kernels import _build, matmul
from repro_torch.launch.serve import ServingLoop
from repro_torch.models import attention as attn
from repro_torch.models import build_model, ssm
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import load_reference_params
from repro_torch.serve import CohortScheduler, ContinuousScheduler, Request

ARCHS = ["xlstm-1.3b", "hymba-1.5b"]
IMPLS = ["chunked", "flash"]
#: a whole model in fp32 (see the module docstring)
MODEL_TOL = 1e-4
#: a whole model in bf16: relative l2, and the multiple of the reference's
#: own bf16 - fp32 difference each value may differ by
BF16_REL_L2, BF16_OWN = 3e-2, 1.5


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _close_bf16(got, want, want_fp32):
    got, want = _np(got), _np(want)
    own = float(np.abs(want - _np(want_fp32)).max())
    assert float(np.abs(got - want).max()) <= BF16_OWN * own
    assert np.linalg.norm(got - want) <= BF16_REL_L2 * np.linalg.norm(want)


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _tokens(seed, *shape):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


# -- the blocks ------------------------------------------------------------------

def _gates(rng, b, s, h, dh, f_shift=2.0):
    q, k, v = (_normal(rng, b, s, h, dh) for _ in range(3))
    return q, k, v, _normal(rng, b, s, h), _normal(rng, b, s, h) + f_shift


@pytest.mark.parametrize("chunk", [8, 7, 64], ids=["divides", "ragged",
                                                   "whole"])
def test_mlstm_seq_matches_reference(chunk):
    """``chunk`` 7 runs at 6, the largest divisor of S = 24 below it."""
    rng = np.random.default_rng(0)
    xs = _gates(rng, 2, 24, 2, 8)
    st = ref_ssm.mlstm_state_init(2, 2, 8)
    want, wst = ref_ssm.mlstm_seq(*map(jnp.asarray, xs), st, chunk)
    got, gst = ssm.mlstm_seq(*map(torch.from_numpy, xs),
                             ssm.mlstm_state_init(2, 2, 8), chunk)
    _close(got, want, 1e-5)
    for g, w in zip(gst, wst):
        _close(g, w, 1e-5)


def test_mlstm_step_matches_reference():
    rng = np.random.default_rng(1)
    q, k, v, i_raw, f_raw = (x[:, 0] for x in _gates(rng, 3, 1, 2, 8))
    c = _normal(rng, 3, 2, 8, 8)
    n = _normal(rng, 3, 2, 8)
    m = _normal(rng, 3, 2)
    want, wst = ref_ssm.mlstm_step(
        *map(jnp.asarray, (q, k, v, i_raw, f_raw)),
        ref_ssm.MLSTMState(*map(jnp.asarray, (c, n, m))))
    got, gst = ssm.mlstm_step(
        *map(torch.from_numpy, (q, k, v, i_raw, f_raw)),
        ssm.MLSTMState(*map(torch.from_numpy, (c, n, m))))
    _close(got, want, 1e-5)
    for g, w in zip(gst, wst):
        _close(g, w, 1e-5)


def _ssm_cfg(dtype="float32"):
    """(reference, port) xlstm smoke configs in ``dtype``."""
    return [dataclasses.replace(f("xlstm-1.3b"), dtype=dtype)
            for f in (ref_smoke, get_smoke_config)]


@pytest.mark.parametrize("mode", ["train", "decode"])
def test_mlstm_block_matches_reference(mode):
    """The whole block in fp32: the headwise q, k, v products (the batched
    launch on the card) and the f32 gate products."""
    ref_cfg, cfg = _ssm_cfg()
    d_inner, h = 2 * cfg.d_model, cfg.n_heads
    p, _ = ref_split_tree(ref_ssm.mlstm_init(jax.random.PRNGKey(2), ref_cfg,
                                             d_inner, h))
    rng = np.random.default_rng(2)
    x = _normal(rng, 2, 1 if mode == "decode" else 24, cfg.d_model)
    want, wst = ref_ssm.mlstm_block(
        p, jnp.asarray(x), ref_cfg, ref_ssm.mlstm_state_init(2, h, 32),
        mode=mode, n_heads=h, compute_dtype=jnp.float32)
    got, gst = ssm.mlstm_block(
        _t(p), torch.from_numpy(x), cfg, ssm.mlstm_state_init(2, h, 32),
        mode=mode, n_heads=h, compute_dtype=torch.float32)
    _close(got, want, 1e-5)
    for g, w in zip(gst, wst):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("mode", ["train", "decode"])
def test_slstm_block_matches_reference(mode):
    ref_cfg, cfg = _ssm_cfg()
    h, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    p, _ = ref_split_tree(ref_ssm.slstm_init(jax.random.PRNGKey(3), ref_cfg,
                                             h))
    rng = np.random.default_rng(3)
    x = _normal(rng, 2, 1 if mode == "decode" else 16, cfg.d_model)
    st = [_normal(rng, 2, h, dh) for _ in range(4)]
    st[1] = np.abs(st[1]) + 0.5                      # a positive normalizer
    want, wst = ref_ssm.slstm_block(
        p, jnp.asarray(x), ref_cfg,
        ref_ssm.SLSTMState(*map(jnp.asarray, st)), mode=mode, n_heads=h,
        compute_dtype=jnp.float32)
    got, gst = ssm.slstm_block(
        _t(p), torch.from_numpy(x), cfg,
        ssm.SLSTMState(*map(torch.from_numpy, st)), mode=mode, n_heads=h,
        compute_dtype=torch.float32)
    _close(got, want, 1e-5)
    for g, w in zip(gst, wst):
        _close(g, w, 1e-5)


def _mamba_cfg():
    kw = dict(name="t", family="hybrid", n_layers=1, d_model=16, n_heads=2,
              n_kv_heads=1, d_ff=32, vocab=64, dtype="float32")
    return (RefArchConfig(ssm=RefSSMConfig(kind="mamba", d_state=4, chunk=8),
                          **kw),
            ArchConfig(ssm=SSMConfig(kind="mamba", d_state=4, chunk=8), **kw))


@pytest.mark.parametrize("mode", ["train", "decode"])
def test_mamba_apply_matches_reference(mode):
    ref_cfg, cfg = _mamba_cfg()
    p, _ = ref_split_tree(ref_ssm.mamba_init(jax.random.PRNGKey(4), ref_cfg,
                                             32))
    rng = np.random.default_rng(4)
    x = _normal(rng, 2, 1 if mode == "decode" else 32, 16)
    s0 = _normal(rng, 2, 32, 4)
    want, wst = ref_ssm.mamba_apply(p, jnp.asarray(x), ref_cfg,
                                    ref_ssm.MambaState(jnp.asarray(s0)),
                                    mode=mode, compute_dtype=jnp.float32)
    got, gst = ssm.mamba_apply(_t(p), torch.from_numpy(x), cfg,
                               ssm.MambaState(torch.from_numpy(s0)),
                               mode=mode, compute_dtype=torch.float32)
    _close(got, want, 1e-5)
    _close(gst.s, wst.s, 1e-5)


def test_ssd_chunk_matches_scan_chunk():
    """The production SSD chunk against the associative scan (the port's
    and the reference's), from a nonzero carry."""
    rng = np.random.default_rng(5)
    b, L, D, N = 2, 8, 6, 4
    la = -np.abs(_normal(rng, b, L, D)) * 0.3
    du = _normal(rng, b, L, D)
    b_t, c_t = _normal(rng, b, L, N), _normal(rng, b, L, N)
    carry = _normal(rng, b, D, N)
    a_bar = np.exp(la)[..., None] * np.ones((1, 1, 1, N), np.float32)
    bx = du[..., None] * b_t[:, :, None, :]
    s_new, y = ssm._mamba_ssd_chunk(*map(torch.from_numpy,
                                         (carry, la, du, b_t, c_t)))
    s_scan, states = ssm._mamba_scan_chunk(*map(torch.from_numpy,
                                                (carry, a_bar, bx)))
    want_s, want_states = ref_ssm._mamba_scan_chunk(
        jnp.asarray(carry), (jnp.asarray(a_bar), jnp.asarray(bx)))
    _close(s_scan, want_s, 1e-5)
    _close(states, want_states, 1e-5)
    _close(s_new, s_scan, 1e-5)
    _close(y, torch.einsum("bldn,bln->bld", states, torch.from_numpy(c_t)),
           1e-5)


def test_init_matches_reference_shapes_and_distributions():
    ref_cfg, cfg = _ssm_cfg()
    g = torch.Generator().manual_seed(0)
    for port_fn, ref_fn, args in (
            (ssm.mlstm_init, ref_ssm.mlstm_init, (64, 2)),
            (ssm.slstm_init, ref_ssm.slstm_init, (2,))):
        got = split_tree(port_fn(g, cfg, *args))
        want = ref_split_tree(ref_fn(jax.random.PRNGKey(0), ref_cfg, *args))
        assert jax.tree.map(lambda t: tuple(t.shape), got[0]) == \
            jax.tree.map(lambda a: a.shape, want[0])
        assert got[1] == want[1]
    _, hcfg = _mamba_cfg()
    p = split_tree(ssm.mamba_init(g, hcfg, 4096))[0]
    ref_p = ref_split_tree(ref_ssm.mamba_init(jax.random.PRNGKey(0),
                                              _mamba_cfg()[0], 4096))[0]
    assert {k: tuple(v.shape) for k, v in p.items()
            if not isinstance(v, dict)} == \
        {k: v.shape for k, v in ref_p.items() if not isinstance(v, dict)}
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert 1e-3 <= float(dt.min()) and float(dt.max()) <= 1e-1
    assert float(dt.log().mean()) == pytest.approx(np.log(1e-2), abs=0.1)
    _close(p["a_log"], ref_p["a_log"], 1e-6)
    m = split_tree(ssm.mlstm_init(g, cfg, 64, 2))[0]
    assert torch.equal(m["b_f"], torch.full((2,), 3.0))
    assert abs(float(m["w_q"].std()) * 32 ** 0.5 - 1) < 0.1


# -- the port's own equivalences (tests/test_models.py:65-130) -------------------

def test_mlstm_chunkwise_equals_stepwise():
    rng = np.random.default_rng(6)
    xs = [torch.from_numpy(x) for x in _gates(rng, 2, 32, 2, 8)]
    st0 = ssm.mlstm_state_init(2, 2, 8)
    h_chunk, st_c = ssm.mlstm_seq(*xs, st0, chunk=8)
    st, outs = st0, []
    for t in range(32):
        h, st = ssm.mlstm_step(*(x[:, t] for x in xs), st)
        outs.append(h)
    _close(h_chunk, torch.stack(outs, 1), 2e-4)
    _close(st_c.c, st.c, 2e-4)


def test_mlstm_chunk_size_invariance():
    rng = np.random.default_rng(7)
    xs = [torch.from_numpy(x) for x in _gates(rng, 1, 24, 2, 4, 1.0)]
    st0 = ssm.mlstm_state_init(1, 2, 4)
    h1, _ = ssm.mlstm_seq(*xs, st0, chunk=4)
    h2, _ = ssm.mlstm_seq(*xs, st0, chunk=12)
    _close(h1, h2, 2e-4)


def test_mamba_chunkwise_equals_stepwise():
    _, cfg = _mamba_cfg()
    p = split_tree(ssm.mamba_init(torch.Generator().manual_seed(4), cfg,
                                  32))[0]
    x = torch.from_numpy(_normal(np.random.default_rng(8), 2, 32, 16))
    st0 = ssm.mamba_state_init(2, 32, 4)
    y_seq, st_seq = ssm.mamba_apply(p, x, cfg, st0, mode="train",
                                    compute_dtype=torch.float32)
    ys, st = [], st0
    for t in range(32):
        y, st = ssm.mamba_apply(p, x[:, t:t + 1], cfg, st, mode="decode",
                                compute_dtype=torch.float32)
        ys.append(y)
    _close(y_seq, torch.cat(ys, 1), 2e-3)
    _close(st_seq.s, st.s, 2e-3)


def test_slstm_seq_equals_stepwise():
    _, cfg = _ssm_cfg()
    p = split_tree(ssm.slstm_init(torch.Generator().manual_seed(6), cfg,
                                  2))[0]
    x = torch.from_numpy(_normal(np.random.default_rng(9), 2, 16,
                                 cfg.d_model))
    st0 = ssm.slstm_state_init(2, 2, 16)
    out, _ = ssm.slstm_block(p, x, cfg, st0, mode="train", n_heads=2,
                             compute_dtype=torch.float32)
    outs, st = [], st0
    for t in range(16):
        o, st = ssm.slstm_block(p, x[:, t:t + 1], cfg, st, mode="decode",
                                n_heads=2, compute_dtype=torch.float32)
        outs.append(o)
    _close(out, torch.cat(outs, 1), 2e-4)


# -- the models, with the reference's weights ---------------------------------

#: layers of each smoke model in the whole-model tests: hymba's smoke
#: config has 3, all global (0, L // 2, L - 1), so 5 give it local
#: (windowed) layers too
LAYERS = {"xlstm-1.3b": 4, "hymba-1.5b": 5}


def _model_pair(arch, dtype, key=0):
    """(reference model, its params, port model with those weights)."""
    def cfg(smoke):
        return dataclasses.replace(smoke(arch), dtype=dtype,
                                   n_layers=LAYERS[arch])
    ref = ref_build_model(cfg(ref_smoke))
    params, _ = ref_split_tree(ref.init(jax.random.PRNGKey(key)))
    model = build_model(cfg(get_smoke_config), device="cpu")
    load_reference_params(model, jax.tree.map(np.asarray, params))
    return ref, params, model


#: prompts of S tokens, then DECODE teacher-forced steps
S, DECODE = 20, 4


def _reference_run(ref, params, toks):
    """The reference's logits: forward, the loss, a prefill of S tokens and
    DECODE steps (each jitted once)."""
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    out = {"forward": jax.jit(ref.forward)(params, batch),
           "loss": float(jax.jit(ref.loss)(params, batch)[0])}
    prefill = jax.jit(ref.prefill, static_argnames="budget")
    logits, st = prefill(params, {"tokens": batch["tokens"][:, :S]},
                         budget=S + DECODE)
    steps = [logits]
    step = jax.jit(ref.decode_step)
    for t in range(S, S + DECODE):
        logits, st = step(params, st, batch["tokens"][:, t:t + 1])
        steps.append(logits)
    out["steps"] = jnp.stack(steps, 1)
    out["state"] = st
    return out


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    """{dtype: (ref params, port model, the reference's run)} for one arch,
    both dtypes on the same weights."""
    toks = _tokens(11, 2, S + DECODE)
    out = {}
    for dtype in ("float32", "bfloat16"):
        ref, params, model = _model_pair(request.param, dtype)
        out[dtype] = (params, model, _reference_run(ref, params, toks))
    return toks, out


def _port_run(model, toks):
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    with torch.no_grad():
        out = {"forward": model.forward(tb), "loss": float(model.loss(tb)[0])}
    logits, st = model.prefill({"tokens": tb["tokens"][:, :S]},
                               budget=S + DECODE)
    steps = [logits]
    for t in range(S, S + DECODE):
        logits, st = model.decode_step(st, tb["tokens"][:, t:t + 1])
        steps.append(logits)
    out["steps"] = torch.stack(steps, 1)
    out["state"] = st
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", IMPLS)
def test_model_entry_points_match_reference(family, impl, dtype):
    """forward, loss, and a prefill then DECODE steps, under both
    attend_chunked implementations (the flash kernel's plain version here);
    the decode state's fields against the reference's at the end.  hymba's
    S + DECODE = 24 rows pass its window of 8 on layers 1 and 3."""
    toks, runs = family
    _, model, want = runs[dtype]
    got = _port_run(model.with_attention(impl), toks)
    if dtype == "float32":
        for what in ("forward", "steps"):
            _close(got[what], want[what], MODEL_TOL)
        assert got["loss"] == pytest.approx(want["loss"], abs=MODEL_TOL)
    else:
        fp32 = runs["float32"][2]
        for what in ("forward", "steps"):
            _close_bf16(got[what], want[what], fp32[what])
        assert got["loss"] == pytest.approx(want["loss"], abs=1e-2)
    st, ref_st = got["state"], want["state"]
    assert [tuple(x.shape) for x in st] == [x.shape for x in ref_st]
    np.testing.assert_array_equal(st.pos.numpy(), np.asarray(ref_st.pos))
    if dtype == "float32":
        for name in ("mlstm_c", "mlstm_n", "slstm", "mamba"):
            _close(getattr(st, name), getattr(ref_st, name), MODEL_TOL)


def test_weights_carry_across(family):
    """Every reference leaf lands at its shape (``load_tree`` is strict:
    every parameter given, none left over); the port's count is the sum
    of the reference tree's leaves."""
    _, runs = family
    params, model, _ = runs["float32"]
    leaves = jax.tree.leaves(params)
    assert sum(p.numel() for p in model.net.parameters()) == \
        sum(int(np.prod(a.shape)) for a in leaves)
    got = {k: tuple(v.shape) for k, v in model.net.state_dict().items()}
    want = {}
    for path, a in jax.tree_util.tree_leaves_with_path(params):
        keys = [str(getattr(k, "key", k)) for k in path]
        if keys[0] in tfm.LAYER_LISTS:
            for i in range(a.shape[0]):
                want[".".join([keys[0], str(i)] + keys[1:])] = a.shape[1:]
        else:
            want[".".join(keys)] = a.shape
    assert got == want
    cfg = model.cfg
    if cfg.family == "ssm":
        assert len(model.net["slstm_layers"]) == \
            ref_tfm.ssm_layer_counts(ref_smoke("xlstm-1.3b"))[1]
        np.testing.assert_array_equal(
            model.net["slstm_layers"][1]["slstm"]["r"].detach().numpy(),
            np.asarray(params["slstm_layers"]["slstm"]["r"][1]))
    else:
        np.testing.assert_array_equal(
            model.net["layers"][2]["mamba"]["a_log"].detach().numpy(),
            np.asarray(params["layers"]["mamba"]["a_log"][2]))


def test_cpu_model_launches_nothing_and_builds_nothing(family):
    _, runs = family
    model = runs["bfloat16"][1]
    before = (matmul.BATCHED_LAUNCHES, dict(matmul.LAUNCHES))
    with torch.no_grad():
        model.forward({"tokens": torch.from_numpy(_tokens(16, 1, 12))})
    assert (matmul.BATCHED_LAUNCHES, matmul.LAUNCHES) == before
    assert _build._libs == {}


def test_model_init_is_transformer_init_one_child_at_a_time():
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        model = build_model(cfg, device="cpu")
        model.init(torch.Generator().manual_seed(3))
        whole = build_model(cfg, device="cpu")
        tfm.load_tree(whole.net, split_tree(tfm.transformer_init(
            torch.Generator().manual_seed(3), cfg))[0])
        got, want = model.net.state_dict(), whole.net.state_dict()
        assert list(got) == list(want)
        for name in got:
            assert torch.equal(got[name], want[name]), name


def test_hymba_global_layers_and_windows(monkeypatch):
    """The global layers are the reference's ``layer_flags`` (0, L // 2,
    L - 1); in train and prefill a global layer calls attend_chunked at
    window 0 (full causal attention on the flash kernel) and a local one at
    the config's window; decode passes the flag to attend_decode's mask.
    At 5 layers (the smoke config's 3 are all global)."""
    for L in (3, 5, 32):
        cfg = dataclasses.replace(get_smoke_config("hymba-1.5b"), n_layers=L)
        want = ref_tfm.layer_flags(dataclasses.replace(
            ref_smoke("hymba-1.5b"), n_layers=L))["global_attn"]
        np.testing.assert_array_equal(tfm.layer_flags(cfg)["global_attn"],
                                      want)
    model = build_model(cfg := dataclasses.replace(
        get_smoke_config("hymba-1.5b"), n_layers=5), device="cpu")
    model.init(torch.Generator().manual_seed(0))
    seen = {"chunked": [], "decode": []}
    real_c, real_d = attn.attend_chunked, attn.attend_decode

    def chunked(*a, **kw):
        seen["chunked"].append(kw["window"])
        return real_c(*a, **kw)

    def decode(*a, **kw):
        seen["decode"].append((kw["window"], kw["global_flag"]))
        return real_d(*a, **kw)
    monkeypatch.setattr(attn, "attend_chunked", chunked)
    monkeypatch.setattr(attn, "attend_decode", decode)
    toks = torch.from_numpy(_tokens(17, 1, 12))
    logits, st = model.prefill({"tokens": toks}, budget=16)
    model.decode_step(st, logits.argmax(-1).int()[:, None])
    w = cfg.attn.window
    assert seen["chunked"] == [0, w, 0, w, 0]
    assert seen["decode"] == [(w, True), (w, False), (w, True), (w, False),
                              (w, True)]


def test_ssm_layer_counts_and_state_match_reference():
    for arch in ARCHS:
        cfg, ref_cfg = get_smoke_config(arch), ref_smoke(arch)
        assert tfm.ssm_layer_counts(cfg) == ref_tfm.ssm_layer_counts(ref_cfg)
        got = tfm.init_state(cfg, 3, 10)
        want = ref_tfm.init_state(ref_cfg, 3, 10)
        assert got._fields == want._fields
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            np.testing.assert_array_equal(_np(g), _np(w))


# -- paged decode is not theirs; serving falls back to cohort ------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_paged_paths_refuse_recurrent_families(arch):
    cfg = get_smoke_config(arch)
    model = build_model(cfg, device="cpu")
    assert model.decode_paged is None and model.prefill_chunk is None
    with pytest.raises(NotImplementedError, match="paged"):
        tfm.init_paged_state(cfg, 2, 4)
    paged = tfm.init_paged_state(get_smoke_config("qwen2-1.5b"), 2, 4)
    one = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="paged"):
        tfm.forward_paged_decode(model.net, one, paged, one,
                                 torch.zeros(1, dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="paged"):
        tfm.forward_paged_chunk(model.net, one, paged, one, 0, 1)
    with pytest.raises(ValueError, match="paged decode"):
        ContinuousScheduler(model, batch=2)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_loop_falls_back_to_cohort(arch):
    """Mirrors tests/test_serve.py's: a continuous request with chunked
    prefill and the prefix cache runs the cohort loop without either."""
    model = build_model(get_smoke_config(arch), device="cpu")
    model.init(torch.Generator().manual_seed(1))
    loop = ServingLoop(model, batch=2, scheduler="continuous",
                       chunk_tokens=16, prefix_cache=True)
    assert loop.scheduler_kind == "cohort"
    assert isinstance(loop.scheduler, CohortScheduler)
    assert loop.chunk_tokens is None and loop.prefix_cache is False
    out = loop.run([Request(uid=i, prompt=_tokens(20 + i, 8), max_new=2)
                    for i in range(2)])
    assert all(len(v) == 2 for v in out.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_cohort_greedy_matches_reference(arch):
    """Greedy tokens of the port's ServingLoop (cohort fallback, batch 2,
    ragged prompts left-padded in a cohort, the pads run through the
    recurrences as in the reference) on the smoke model in fp32: the
    reference's, token for token, in FIFO and reversed arrival order."""
    ref, params, model = _model_pair(arch, "float32", key=1)
    rng = np.random.default_rng(0)
    lens, new = (12, 7, 9), (3, 4, 3)
    prompts = [rng.integers(0, 512, (n,)).astype(np.int32) for n in lens]

    def reqs(cls, reverse=False):
        arr = [0.0, 1.0, 2.0]
        return [cls(uid=i, prompt=p, max_new=m,
                    arrival=arr[2 - i] if reverse else arr[i])
                for i, (p, m) in enumerate(zip(prompts, new))]
    for reverse in (False, True):
        want = RefServingLoop(ref.cfg, params, batch=2, max_new=8).run(
            reqs(RefRequest, reverse))
        loop = ServingLoop(model, batch=2, max_new=8)
        assert loop.scheduler_kind == "cohort"
        assert loop.run(reqs(Request, reverse)) == want
