"""The port's dense model stack on CPU tensors against the reference's, on
the same numpy inputs and, at the model level, the same weights (carried
across by ``load_reference_params``).

Tolerances.  The layer pieces in fp32 are the same arithmetic: 1e-5
(rope, norm, mlp) and the reference's attention tolerance 2e-5
(``attend_chunked`` in both implementations, decode and prefix attention).
In bf16 each framework rounds its matmul outputs and elementwise results to
bf16 on its own (8 significand bits): ``attend_chunked`` in bf16 holds
2e-2 (a bf16 ulp of an O(1) output is up to 1.6e-2), the mlp 3e-2.  The
whole model computes in bf16 through its layers, and a rounding flip in a
hidden value moves its logits by about the embedding scale times 2^-8 each
layer: the model entry points hold 3e-2 (the largest difference seen is
1.0e-2 at logits of magnitude 0.5), inside the reference's own 6e-2 for
its bf16 model path (tests/test_models.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.distributed.sharding import split_tree as ref_split_tree
from repro.kernels import flash_attention as ref_fa
from repro.models import attention as ref_attn
from repro.models import build_model as ref_build_model
from repro.models import layers as ref_layers
from repro.models import transformer as ref_tfm
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import Param, is_param, split_tree
from repro_torch.kernels import _build, flash_attention, ops
from repro_torch.models import attention as attn
from repro_torch.models import build_model, layers, moe
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import load_reference_params

#: the model entry points' tolerance (see the module docstring)
MODEL_TOL = 3e-2
ARCH = "qwen2-1.5b"
IMPLS = ["chunked", "flash"]


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# -- layer pieces ------------------------------------------------------------

def test_rope_matches_reference():
    rng = np.random.default_rng(0)
    x = _normal(rng, 2, 9, 3, 16)
    pos = rng.integers(0, 4000, (2, 9)).astype(np.int32)
    for theta in (10000.0, 1e6):
        want = ref_layers.rope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = layers.rope(torch.from_numpy(x), layers.rope_tables(
            torch.from_numpy(pos), x.shape[-1], theta))
        _close(got, want, 1e-5)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_matches_reference(kind):
    rng = np.random.default_rng(1)
    x = _normal(rng, 3, 5, 32) * 3
    p = {"scale": _normal(rng, 32)}
    if kind == "layernorm":
        p["bias"] = _normal(rng, 32)
    want = ref_layers.norm({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x))
    got = layers.norm({k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(x))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("act", ["swiglu", "gelu", "relu"])
def test_mlp_matches_reference(act, dtype, tol):
    rng = np.random.default_rng(2)
    d, ff = 24, 40
    x = _normal(rng, 2, 7, d)
    p = {"up": {"w": _normal(rng, d, ff) / 5, "b": _normal(rng, ff)},
         "down": {"w": _normal(rng, ff, d) / 7}}
    if act == "swiglu":
        p["gate"] = {"w": _normal(rng, d, ff) / 5}
    want = ref_layers.mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x), act,
                          jnp.dtype(dtype))
    got = layers.mlp(jax.tree.map(torch.from_numpy, p), torch.from_numpy(x),
                     act, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, tol)


def test_split_tree_and_init_shapes():
    cfg = get_smoke_config(ARCH)
    tree = tfm.transformer_init(torch.Generator().manual_seed(0), cfg)
    values, axes = split_tree(tree)
    ref_values, ref_axes = ref_split_tree(
        ref_tfm.transformer_init(jax.random.PRNGKey(0), ref_smoke(ARCH)))
    # the reference's tree with its layer axis unstacked
    layer0 = jax.tree.map(lambda a: a[0], ref_values["layers"])
    assert jax.tree.map(lambda t: tuple(t.shape), values["layers"][0]) == \
        jax.tree.map(lambda a: a.shape, layer0)
    assert axes["layers"][0] == jax.tree.map(
        lambda a: a[1:], ref_axes["layers"],
        is_leaf=lambda x: isinstance(x, tuple))
    assert axes["embed"] == ref_axes["embed"]
    assert is_param(Param(torch.zeros(1), ("embed",)))
    with pytest.raises(TypeError):
        split_tree({"w": torch.zeros(1)})
    # the reference's distributions: normal / sqrt(d_in), zero biases,
    # unit scales, the embedding at 0.02
    wq = values["layers"][0]["attn"]["wq"]
    assert abs(float(wq["w"].std()) * cfg.d_model ** 0.5 - 1) < 0.1
    assert float(wq["b"].abs().max()) == 0.0
    assert float(values["ln_f"]["scale"].min()) == 1.0
    assert abs(float(values["embed"]["emb"].std()) / 0.02 - 1) < 0.05


def test_padded_heads_and_vocab_take_the_tp_degree():
    cfg = get_smoke_config(ARCH)                    # 6 heads, vocab 512
    assert layers.padded_heads(cfg) == 6
    assert layers.padded_heads(cfg, 4) == 8
    assert layers.padded_vocab(cfg) == 512
    assert layers.padded_vocab(cfg, 3) == 768


# -- attention ---------------------------------------------------------------

def _qkv(rng, b, s, h, kvh, d, dtype="float32"):
    q, k, v = (_normal(rng, b, s, n, d) for n in (h, kvh, kvh))
    return [jnp.asarray(x, dtype) for x in (q, k, v)], \
        [torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v)]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("chunk", [32, 48], ids=["divides", "ragged"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 40), (False, 0)])
@pytest.mark.parametrize("h,kvh", [(6, 2), (4, 4)])
def test_attend_chunked_matches_reference(impl, chunk, causal, window, h,
                                          kvh):
    rng = np.random.default_rng(3)
    (rq, rk, rv), (q, k, v) = _qkv(rng, 2, 128, h, kvh, 16)
    idx = attn.kv_index_map(h, kvh, h)
    want = ref_attn.attend_chunked(rq, rk, rv, idx, causal=causal,
                                   window=window, chunk=chunk)
    got = attn.attend_chunked(q, k, v, idx, causal=causal, window=window,
                              chunk=chunk, impl=impl)
    assert got.shape == q.shape and got.dtype == q.dtype
    _close(got, want, 2e-5)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("s,window", [(100, 0), (200, 64)])
def test_attend_chunked_ragged_causal_matches_reference(impl, s, window):
    """Causal S not a multiple of 128: flash pads S up and slices back."""
    rng = np.random.default_rng(4)
    (rq, rk, rv), (q, k, v) = _qkv(rng, 1, s, 6, 2, 32)
    idx = attn.kv_index_map(6, 2, 6)
    want = ref_attn.attend_chunked(rq, rk, rv, idx, causal=True,
                                   window=window, chunk=24)
    got = attn.attend_chunked(q, k, v, idx, causal=True, window=window,
                              chunk=24, impl=impl)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("impl", IMPLS)
def test_attend_chunked_bf16_matches_reference(impl):
    rng = np.random.default_rng(5)
    (rq, rk, rv), (q, k, v) = _qkv(rng, 2, 128, 6, 2, 32, "bfloat16")
    idx = attn.kv_index_map(6, 2, 6)
    want = ref_attn.attend_chunked(rq, rk, rv, idx, causal=True, window=0,
                                   chunk=64)
    got = attn.attend_chunked(q, k, v, idx, causal=True, window=0, chunk=64,
                              impl=impl)
    assert got.dtype == torch.bfloat16
    _close(got, want, 2e-2)


@pytest.mark.parametrize("impl", IMPLS)
def test_attend_chunked_head_padding_exact(impl):
    """Padded q heads do not change the real heads' outputs; the padded
    map (padded heads clamp to the last kv head) is not h // group, so
    flash gathers the kv heads."""
    rng = np.random.default_rng(6)
    (rq, rk, rv), (q, k, v) = _qkv(rng, 1, 128, 6, 2, 16)
    base = attn.attend_chunked(q, k, v, attn.kv_index_map(6, 2, 6),
                               causal=True, window=0, chunk=32, impl=impl)
    pad = torch.from_numpy(_normal(rng, 1, 128, 2, 16))
    idx = attn.kv_index_map(6, 2, 8)
    assert not np.array_equal(idx, np.arange(8) // 4)
    padded = attn.attend_chunked(torch.cat([q, pad], 2), k, v, idx,
                                 causal=True, window=0, chunk=32, impl=impl)
    _close(padded[:, :, :6], base, 1e-6)
    want = ref_attn.attend_chunked(jnp.concatenate([rq, jnp.asarray(
        pad.numpy())], 2), rk, rv, idx, causal=True, window=0, chunk=32)
    _close(padded, want, 2e-5)


@pytest.mark.parametrize("call", [
    dict(causal=False, window=0, s=100, d=192, card=True),
    dict(causal=True, window=0, s=128, global_flag=True),
    dict(causal=True, window=0, s=128, impl="dense")])
def test_attend_chunked_flash_refuses_outside_its_contract(call, monkeypatch):
    """A head dim past the card's (there, stood in for by a patched
    ``_on_card``), a global flag and an unknown implementation raise,
    naming "chunked"; a non-causal ragged S is in the contract (the key
    count: tests/test_torch_flash_attention.py)."""
    call = dict(call)
    s, d = call.pop("s"), call.pop("d", 16)
    impl = call.pop("impl", "flash")
    if call.pop("card", False):
        monkeypatch.setattr(attn, "_on_card", lambda x: True)
    q = torch.zeros(1, s, 2, d)
    with pytest.raises(ValueError, match="chunked"):
        attn.attend_chunked(q, q, q, attn.kv_index_map(2, 2, 2), chunk=32,
                            impl=impl, **call)


def test_attend_chunked_flash_refuses_backward_on_the_card(monkeypatch):
    """The kernel has a backward pass now.  Where the call launches it (the
    card, stood in for here by a patched ``_on_card``), a call that autograd
    differentiates runs through ``FlashAttention``, whose backward is the
    backward kernel's function (its plain version on the CPU), and gives
    the gradients of "chunked" (fp32, the reference's 2e-5); without
    autograd it runs as before."""
    monkeypatch.setattr(attn, "_on_card", lambda x: True)
    calls = []
    bwd = flash_attention.flash_attention_bwd_plain
    monkeypatch.setattr(flash_attention, "flash_attention_bwd_plain",
                        lambda *a, **kw: calls.append(1) or bwd(*a, **kw))
    rng = np.random.default_rng(12)
    arrays = [_normal(rng, 1, 100, h, 64) for h in (4, 2, 2)]
    dout = torch.from_numpy(_normal(rng, 1, 100, 4, 64))
    idx = attn.kv_index_map(4, 2, 4)
    kw = dict(causal=True, window=0, chunk=32)
    grads = {}
    for impl in ("flash", "chunked"):
        qkv = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
        out = attn.attend_chunked(*qkv, idx, impl=impl, **kw)
        (out * dout).sum().backward()
        grads[impl] = (out.detach(), [t.grad for t in qkv])
    assert calls == [1]
    _close(grads["flash"][0], grads["chunked"][0], 2e-5)
    for got, want in zip(grads["flash"][1], grads["chunked"][1]):
        _close(got, want, 2e-5)
    with torch.no_grad():
        flash = attn.attend_chunked(*map(torch.from_numpy, arrays), idx,
                                    impl="flash", **kw)
    _close(flash, grads["chunked"][0], 2e-5)


@pytest.mark.parametrize("hd", [8, 16, 96])
def test_attend_chunked_flash_pads_the_head_dim_on_the_card(monkeypatch, hd):
    """On the card (a patched ``_on_card``) a head dim the kernel does not
    take is zero-padded up to the next of ``CARD_D`` at the true scale, and
    the padding sliced off: the unpadded result.  Past the largest it
    raises."""
    rng = np.random.default_rng(hd)
    (_, _, _), (q, k, v) = _qkv(rng, 2, 100, 6, 2, hd)
    idx = attn.kv_index_map(6, 2, 6)
    kw = dict(causal=True, window=0, chunk=32, impl="flash")
    want = attn.attend_chunked(q, k, v, idx, **kw)
    seen = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention", lambda *a, **k_: (
        seen.append(a[0].shape), real(*a, **k_))[1])
    monkeypatch.setattr(attn, "_on_card", lambda x: True)
    got = attn.attend_chunked(q, k, v, idx, **kw)
    assert seen == [(2, 6, 128, 64 if hd <= 64 else 128)]
    assert got.shape == want.shape
    _close(got, want, 1e-6)
    big = torch.zeros(1, 128, 2, 136)
    with pytest.raises(ValueError, match="head dims up to 128"):
        attn.attend_chunked(big, big, big, attn.kv_index_map(2, 2, 2), **kw)


def _cache(rng, b, w, kvh, d, filled):
    k, v = _normal(rng, b, w, kvh, d), _normal(rng, b, w, kvh, d)
    pos = np.full((b, w), -1, np.int32)
    pos[:, :filled] = np.arange(filled)
    return k, v, pos


@pytest.mark.parametrize("window", [0, 5])
def test_attend_decode_matches_reference(window):
    rng = np.random.default_rng(7)
    k, v, pos = _cache(rng, 2, 16, 2, 16, 11)
    q = _normal(rng, 2, 1, 6, 16)
    qpos = np.array([10, 7], np.int32)
    idx = attn.kv_index_map(6, 2, 6)
    want = ref_attn.attend_decode(*map(jnp.asarray, (q, k, v, pos)), idx,
                                  q_position=jnp.asarray(qpos), window=window)
    got = attn.attend_decode(*map(torch.from_numpy, (q, k, v, pos)), idx,
                             q_position=torch.from_numpy(qpos), window=window)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("window", [0, 4])
def test_attend_prefix_matches_reference(window):
    rng = np.random.default_rng(8)
    k, v, pos = _cache(rng, 1, 24, 2, 16, 13)
    q = _normal(rng, 1, 6, 6, 16)
    qpos = np.arange(7, 13, dtype=np.int32)[None]
    idx = attn.kv_index_map(6, 2, 6)
    want = ref_attn.attend_prefix(*map(jnp.asarray, (q, k, v, pos)), idx,
                                  q_positions=jnp.asarray(qpos),
                                  window=window)
    got = attn.attend_prefix(*map(torch.from_numpy, (q, k, v, pos)), idx,
                             q_positions=torch.from_numpy(qpos),
                             window=window)
    _close(got, want, 2e-5)


def test_gather_paged_view_and_append_match_reference():
    rng = np.random.default_rng(9)
    kb, vb = _normal(rng, 6, 4, 2, 8), _normal(rng, 6, 4, 2, 8)
    pb = rng.integers(0, 50, (6, 4)).astype(np.int32)
    table = np.array([[3, 1, -1], [5, -1, -1]], np.int32)
    want = ref_attn.gather_paged_view(*map(jnp.asarray, (kb, vb, pb, table)))
    got = attn.gather_paged_view(*map(torch.from_numpy, (kb, vb, pb, table)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    kn, vn = _normal(rng, 2, 1, 2, 8), _normal(rng, 2, 1, 2, 8)
    blk, off = np.array([1, 5], np.int32), np.array([2, 0], np.int32)
    want = ref_attn.append_paged_layer(*map(jnp.asarray,
                                            (kb, vb, kn, vn, blk, off)))
    kt, vt = torch.from_numpy(kb.copy()), torch.from_numpy(vb.copy())
    got = attn.append_paged_layer(kt, vt, *map(torch.from_numpy,
                                               (kn, vn, blk, off)))
    assert got[0] is kt                                  # in place
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("window", [0, 6])
def test_init_cache_matches_reference(window):
    cfg = dataclasses.replace(get_smoke_config(ARCH), attn=dataclasses.replace(
        get_smoke_config(ARCH).attn, window=window))
    ref_cfg = dataclasses.replace(ref_smoke(ARCH), attn=dataclasses.replace(
        ref_smoke(ARCH).attn, window=window))
    got = attn.init_cache(cfg, 3, 10, n_layers=1)
    want = ref_attn.init_cache(ref_cfg, 3, 10, n_layers=1)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(_np(g), _np(w))


def test_update_cache_layer_writes_in_place_like_reference():
    rng = np.random.default_rng(10)
    k, v, pos = _cache(rng, 2, 12, 2, 8, 0)
    kn, vn = _normal(rng, 2, 3, 2, 8), _normal(rng, 2, 3, 2, 8)
    positions = np.broadcast_to(np.arange(5, 8, dtype=np.int32), (2, 3))
    want = ref_attn.update_cache_layer(*map(jnp.asarray,
                                            (k, v, pos, kn, vn, positions)))
    kt, vt, pt = (torch.from_numpy(x.copy()) for x in (k, v, pos))
    got = attn.update_cache_layer(kt, vt, pt, *map(
        torch.from_numpy, (kn, vn, positions.copy())))
    assert got[0] is kt and got[2] is pt
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- the model, with the reference's weights -----------------------------------

@pytest.fixture(scope="module")
def pair():
    """(reference model, its params, port model with those weights)."""
    ref = ref_build_model(ref_smoke(ARCH))
    params, _ = ref_split_tree(ref.init(jax.random.PRNGKey(0)))
    model = build_model(get_smoke_config(ARCH), device="cpu")
    load_reference_params(model, jax.tree.map(np.asarray, params))
    return ref, params, model


def _tokens(seed, *shape):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


def test_weights_carry_across(pair):
    ref, params, model = pair
    assert sum(p.numel() for p in model.net.parameters()) == \
        model.cfg.param_count()
    wq = model.net["layers"][1]["attn"]["wq"]["w"]
    np.testing.assert_array_equal(
        wq.detach().numpy(), np.asarray(params["layers"]["attn"]["wq"]["w"][1]))


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_and_loss_match_reference(pair, impl):
    ref, params, model = pair
    toks = _tokens(11, 2, 28)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    tbatch = {"tokens": torch.from_numpy(toks),
              "labels": torch.from_numpy(toks)}
    m = model.with_attention(impl)
    with torch.no_grad():
        _close(m.forward(tbatch), ref.forward(params, batch), MODEL_TOL)
        loss, metrics = m.loss(tbatch)
    want, ref_metrics = ref.loss(params, batch)
    assert abs(float(loss) - float(want)) < 1e-3
    assert int(metrics["tokens"]) == int(ref_metrics["tokens"]) == toks.size


def test_prefill_and_decode_match_reference(pair):
    ref, params, model = pair
    toks = _tokens(12, 2, 24)
    s = 20
    want, st = ref.prefill(params, {"tokens": jnp.asarray(toks[:, :s])},
                           budget=24)
    got, tst = model.prefill({"tokens": torch.from_numpy(toks[:, :s])},
                             budget=24)
    assert tuple(tst.k.shape) == tuple(st.k.shape)
    _close(got, want, MODEL_TOL)
    for t in range(s, 24):
        step = toks[:, t:t + 1]
        want, st = ref.decode_step(params, st, jnp.asarray(step))
        got, tst = model.decode_step(tst, torch.from_numpy(step))
        _close(got, want, MODEL_TOL)
    np.testing.assert_array_equal(tst.kpos.numpy(), np.asarray(st.kpos))
    np.testing.assert_array_equal(tst.pos.numpy(), np.asarray(st.pos))


def _chunked_prefill(prefill_chunk, paged, prompt, table, width, to):
    """Prefill ``prompt`` in chunks of ``width`` (the last padded) through
    ``prefill_chunk``; returns the last chunk's logits and the arena."""
    for start in range(0, len(prompt), width):
        real = prompt[start:start + width]
        chunk = np.zeros((1, width), np.int32)
        chunk[0, :len(real)] = real
        logits, paged = prefill_chunk(paged, to(chunk), table, start,
                                      len(real))
    return logits, paged


def test_prefill_chunk_and_decode_paged_match_reference(pair):
    """Two slots prefilled chunk by chunk (block_len 4, chunk widths 8 and
    16, prompts of 19 and 10 tokens), then 3 paged decode steps with the
    slots at different positions."""
    ref, params, model = pair
    cfg = model.cfg
    prompts = [_tokens(13, 19), _tokens(14, 10)]
    tables = np.array([[1, 2, 3, 4, 5, 6, 7], [8, 9, 10, 11, -1, -1, -1]],
                      np.int32)
    got_logits = {}
    for width in (8, 16):
        ref_paged = ref_tfm.init_paged_state(ref_smoke(ARCH), 12, 4)
        paged = tfm.init_paged_state(cfg, 12, 4, device="cpu")
        for slot, prompt in enumerate(prompts):
            table = tables[slot:slot + 1]
            want, ref_paged = _chunked_prefill(
                lambda pg, tk, tb, st, n: ref.prefill_chunk(
                    params, pg, tk, tb, jnp.int32(st), jnp.int32(n)),
                ref_paged, prompt, jnp.asarray(table), width, jnp.asarray)
            got, paged = _chunked_prefill(
                model.prefill_chunk, paged, prompt, torch.from_numpy(table),
                width, torch.from_numpy)
            _close(got, want, MODEL_TOL)
            got_logits[(width, slot)] = got
        np.testing.assert_array_equal(paged.pos.numpy(),
                                      np.asarray(ref_paged.pos))
        slot_pos = np.array([19, 10], np.int32)
        step = np.stack([p[-1:] for p in prompts])
        for _ in range(3):
            want, ref_paged = ref.decode_paged(
                params, ref_paged, jnp.asarray(step), jnp.asarray(tables),
                jnp.asarray(slot_pos))
            got, paged = model.decode_paged(
                paged, torch.from_numpy(step), torch.from_numpy(tables),
                torch.from_numpy(slot_pos))
            _close(got, want, MODEL_TOL)
            step = got.argmax(-1).int().numpy()[:, None]
            slot_pos = slot_pos + 1
    # the chunk decomposition does not change a row (attend_prefix)
    for slot in (0, 1):
        _close(got_logits[(8, slot)], got_logits[(16, slot)], 1e-6)


def test_cpu_model_launches_nothing_and_builds_nothing(pair):
    _, _, model = pair
    flash_attention.LAUNCHES = 0
    toks = torch.from_numpy(_tokens(15, 1, 40))
    model.prefill({"tokens": toks})
    with torch.no_grad():
        model.forward({"tokens": toks})
    assert flash_attention.LAUNCHES == 0
    assert _build._libs == {}


def test_model_init_is_transformer_init_one_child_at_a_time():
    """Model.init draws what transformer_init draws from the same seed,
    child by child (the reference's distributions stated once)."""
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(3))
    whole = build_model(cfg, device="cpu")
    tfm.load_tree(whole.net, split_tree(tfm.transformer_init(
        torch.Generator().manual_seed(3), cfg))[0])
    got, want = model.net.state_dict(), whole.net.state_dict()
    assert list(got) == list(want)
    for name in got:
        assert torch.equal(got[name], want[name]), name


def test_loss_on_the_card_refuses_backward_through_flash(monkeypatch):
    """Model.loss under autograd on the card (patched ``_on_card``s: the
    products take ``layers.kernel_linear``, whose product is the kernel's
    plain version on the CPU, and flash takes ``FlashAttention``) trains the
    dense family: no refusal, the backward kernels' functions run, and
    every parameter's gradient is the one "chunked" with torch.matmul
    gives, in fp32 (1e-4 of each leaf's largest value: the products sum K in
    tiles of 128 and flash its online softmax, in orders of their own).
    The other families' refusal: tests/test_torch_train.py."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    model = build_model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(4))
    toks = torch.from_numpy(_tokens(16, 2, 24))
    batch = {"tokens": toks, "labels": toks}
    loss, _ = model.with_attention("chunked").loss(batch)
    want = dict(zip([n for n, _ in model.net.named_parameters()],
                    torch.autograd.grad(loss, list(model.net.parameters()))))
    monkeypatch.setattr(attn, "_on_card", lambda x: True)
    monkeypatch.setattr(layers, "_on_card", lambda x: True)
    products, bwd = [], flash_attention.flash_attention_bwd_plain
    monkeypatch.setattr(flash_attention, "flash_attention_bwd_plain",
                        lambda *a, **kw: products.append("flash") or
                        bwd(*a, **kw))
    backward = layers.KernelLinear.backward
    monkeypatch.setattr(layers.KernelLinear, "backward", staticmethod(
        lambda ctx, dy: products.append("linear") or backward(ctx, dy)))
    flash_attention.LAUNCHES = 0
    got_loss, _ = model.loss(batch)
    got = dict(zip(want, torch.autograd.grad(got_loss,
                                             list(model.net.parameters()))))
    assert flash_attention.LAUNCHES == 0           # the CPU: no kernel
    assert products.count("flash") == cfg.n_layers
    # seven products a layer and the unembedding
    assert products.count("linear") == 7 * cfg.n_layers + 1
    _close(got_loss, loss, 1e-5)
    for name, g in want.items():
        lim = 1e-4 * float(g.abs().max())
        err = float((got[name] - g).abs().max())
        assert err <= lim, (name, err, lim)


def _fp32(cfg, sinusoid):
    attn_cfg = dataclasses.replace(cfg.attn, rope_theta=0.0) if sinusoid \
        else cfg.attn
    return dataclasses.replace(cfg, dtype="float32", attn=attn_cfg)


@pytest.mark.parametrize("arch,sinusoid", [
    ("command-r-35b", False), ("deepseek-67b", False),
    ("phi3-mini-3.8b", False), ("qwen2-1.5b", True)],
    ids=["command-r-35b", "deepseek-67b", "phi3-mini-3.8b",
         "qwen2-1.5b-sinusoid"])
def test_other_dense_archs_match_reference(arch, sinusoid):
    """layernorm with a parallel residual (command-r), untied unembedding
    (deepseek), MHA at head dim 12 (phi3), sinusoidal positions in place of
    rope (rope_theta 0), all computing in fp32 (the algorithm, at 1e-4:
    deepseek's untied logits are O(1), six times the tied ones, and so are
    its bf16 rounding differences)."""
    ref = ref_build_model(_fp32(ref_smoke(arch), sinusoid))
    params, _ = ref_split_tree(ref.init(jax.random.PRNGKey(1)))
    model = build_model(_fp32(get_smoke_config(arch), sinusoid),
                        device="cpu")
    load_reference_params(model, jax.tree.map(np.asarray, params))
    toks = _tokens(16, 2, 20)
    with torch.no_grad():
        got = model.forward({"tokens": torch.from_numpy(toks)})
    _close(got, ref.forward(params, {"tokens": jnp.asarray(toks)}), 1e-4)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"])
def test_moe_family_builds_and_runs(arch):
    """The moe smoke configs build through every entry that raised before
    the family was ported, and run prefill, decode and paged decode (their
    values against the reference: tests/test_torch_moe.py)."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(5))
    assert isinstance(model.net["layers"][0]["moe"], moe.MoE)
    assert "mlp" not in model.net["layers"][0]
    assert tfm.init_state(cfg, 1, 8).k.shape[0] == cfg.n_layers
    assert set(tfm.transformer_init(torch.Generator(), cfg)["layers"][0]) >= \
        {"attn", "moe"}
    toks = torch.from_numpy(_tokens(17, 2, 12))
    logits, state = model.prefill({"tokens": toks}, budget=16)
    logits, state = model.decode_step(state, logits.argmax(-1).int()[:, None])
    assert logits.shape == (2, layers.padded_vocab(cfg))
    paged = tfm.init_paged_state(cfg, 5, 4)
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    got, _ = model.decode_paged(paged, toks[:, :1], table,
                                torch.tensor([0, 3], dtype=torch.int32))
    assert bool(torch.isfinite(got[:, :cfg.vocab]).all())


def test_build_model_refuses_unknown_attention():
    with pytest.raises(ValueError):
        build_model(get_smoke_config(ARCH), attention="dense", device="cpu")
    assert ref_fa.NEG_INF == flash_attention.NEG_INF == attn.NEG
