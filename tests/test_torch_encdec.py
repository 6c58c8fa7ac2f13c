"""The port's encdec family on CPU tensors against the reference's: the
whisper-medium smoke model (2 + 2 layers, d_model 48, 4 heads of 12) on the
reference's weights (``load_reference_params``): ``encode``, forward, loss,
prefill and decode steps; the cross-attention K/V the prefill carries in
the state; the frames' length refused where it differs from the tokens';
and its greedy tokens under the cohort scheduler, to which serving falls
back (encdec has no paged decode).

Tolerances as tests/test_torch_vlm.py's: fp32 at 1e-4; bf16 at relative
l2 3e-2 and each value within 1.5 times the reference's own bf16 - fp32
difference (the two frameworks round their bf16 products and elementwise
results at other points).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.distributed.sharding import split_tree as ref_split_tree
from repro.launch.serve import ServingLoop as RefServingLoop
from repro.models import build_model as ref_build_model
from repro.models import encdec as ref_encdec
from repro.serve import Request as RefRequest
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import split_tree
from repro_torch.launch.serve import ServingLoop
from repro_torch.models import build_model, encdec
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import load_reference_params
from repro_torch.serve import CohortScheduler, ContinuousScheduler, Request

ARCH = "whisper-medium"
IMPLS = ["chunked", "flash"]
MODEL_TOL = 1e-4
BF16_REL_L2, BF16_OWN = 3e-2, 1.5
#: prompts of S tokens over S frames (not a multiple of the flash kernel's
#: 128 rows: its non-causal calls run with a key count below the padded
#: length), then DECODE teacher-forced steps
S, DECODE = 20, 4


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


def _model_pair(dtype, key=0):
    ref = ref_build_model(dataclasses.replace(ref_smoke(ARCH), dtype=dtype))
    params, _ = ref_split_tree(ref.init(jax.random.PRNGKey(key)))
    model = build_model(dataclasses.replace(get_smoke_config(ARCH),
                                            dtype=dtype), device="cpu")
    load_reference_params(model, jax.tree.map(np.asarray, params))
    return ref, params, model


def _inputs(seed=11):
    """tokens (2, S + DECODE), labels with a masked run, frames (2, S, d)."""
    rng = np.random.default_rng(seed)
    cfg = get_smoke_config(ARCH)
    toks = rng.integers(0, 512, (2, S + DECODE)).astype(np.int32)
    labels = toks.copy()
    labels[1, :5] = -1
    frames = rng.normal(size=(2, S + DECODE, cfg.d_model)).astype(np.float32)
    return toks, labels, frames


def _reference_run(ref, params, toks, labels, frames):
    cfg = ref.cfg
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
             "frames": jnp.asarray(frames)}
    loss, metrics = jax.jit(ref.loss)(params, batch)
    out = {"encode": ref_encdec.encode(params, cfg, batch["frames"][:, :S],
                                       remat=False),
           "forward": jax.jit(ref.forward)(params, batch),
           "loss": float(loss), "tokens": int(metrics["tokens"])}
    prefill = jax.jit(ref.prefill, static_argnames="budget")
    logits, st = prefill(params, {"tokens": batch["tokens"][:, :S],
                                  "frames": batch["frames"][:, :S]},
                         budget=S + DECODE + 8)
    out["prefill_state"] = st
    steps = [logits]
    step = jax.jit(ref.decode_step)
    for t in range(S, S + DECODE):
        logits, st = step(params, st, batch["tokens"][:, t:t + 1])
        steps.append(logits)
    out["steps"] = jnp.stack(steps, 1)
    out["state"] = st
    return out


def _port_run(model, toks, labels, frames):
    tb = {"tokens": torch.from_numpy(toks),
          "labels": torch.from_numpy(labels),
          "frames": torch.from_numpy(frames)}
    with torch.no_grad():
        loss, metrics = model.loss(tb)
        out = {"encode": encdec.encode(model.net, tb["frames"][:, :S],
                                       model.attention),
               "forward": model.forward(tb), "loss": float(loss),
               "tokens": int(metrics["tokens"])}
    logits, st = model.prefill({"tokens": tb["tokens"][:, :S],
                                "frames": tb["frames"][:, :S]},
                               budget=S + DECODE + 8)
    out["prefill_state"] = st._replace(**{f: getattr(st, f).clone()
                                          for f in st._fields})
    steps = [logits]
    for t in range(S, S + DECODE):
        logits, st = model.decode_step(st, tb["tokens"][:, t:t + 1])
        steps.append(logits)
    out["steps"] = torch.stack(steps, 1)
    out["state"] = st
    return out


@pytest.fixture(scope="module")
def runs():
    """{dtype: (ref, params, port model, the reference's run)}."""
    inputs = _inputs()
    out = {}
    for dtype in ("float32", "bfloat16"):
        ref, params, model = _model_pair(dtype)
        out[dtype] = (ref, params, model, _reference_run(ref, params,
                                                         *inputs))
    return inputs, out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", IMPLS)
def test_model_entry_points_match_reference(runs, impl, dtype):
    """encode of S frames, forward and the loss over S + DECODE tokens and
    frames, and a prefill of S then DECODE decode steps."""
    inputs, by_dtype = runs
    _, _, model, want = by_dtype[dtype]
    got = _port_run(model.with_attention(impl), *inputs)
    assert got["forward"].shape == (2, S + DECODE, 512)
    assert got["tokens"] == want["tokens"] == int((inputs[1] >= 0).sum())
    if dtype == "float32":
        for what in ("encode", "forward", "steps"):
            _close(got[what], want[what], MODEL_TOL)
        assert got["loss"] == pytest.approx(want["loss"], abs=MODEL_TOL)
    else:
        fp32 = by_dtype["float32"][3]
        for what in ("encode", "forward", "steps"):
            _close_bf16(got[what], want[what], fp32[what])
        assert got["loss"] == pytest.approx(want["loss"], abs=1e-2)
    st, ref_st = got["state"], want["state"]
    for f in ("pos", "kpos"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(ref_st, f)))
    assert int(st.pos[0]) == S + DECODE


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_carries_the_cross_kv(runs, impl):
    """The prefill's state holds each decoder layer's cross K/V of the
    encoder output, (L, B, S, KV, hd), the reference's ``xk`` and ``xv``;
    its self-attention cache the prompt's K/V at slots 0 .. S - 1."""
    inputs, by_dtype = runs
    _, _, model, want = by_dtype["float32"]
    got = _port_run(model.with_attention(impl), *inputs)["prefill_state"]
    ref_st = want["prefill_state"]
    cfg = model.cfg
    assert got.xk.shape == (cfg.n_layers, 2, S, cfg.n_kv_heads,
                            cfg.head_dim_)
    for f in ("xk", "xv", "k", "v"):
        _close(getattr(got, f), getattr(ref_st, f), MODEL_TOL)
    assert float(got.xk.abs().max()) > 0


def test_decode_reads_the_carried_cross_kv(runs):
    """A decode step reads the cross K/V from the state and never makes
    them again: with the cross wk and wv zeroed after the prefill its
    logits do not move; with the carried xk and xv zeroed they do."""
    inputs, by_dtype = runs
    toks, _, frames = inputs
    _, _, model, _ = by_dtype["float32"]
    logits, st = model.prefill({"tokens": torch.from_numpy(toks[:, :S]),
                                "frames": torch.from_numpy(frames[:, :S])},
                               budget=S + 4)
    tok = logits.argmax(-1).int()[:, None]

    def copy(state):
        return state._replace(**{f: getattr(state, f).clone()
                                 for f in state._fields})
    want, _ = model.decode_step(copy(st), tok)
    saved = {}
    with torch.no_grad():
        for i, layer in enumerate(model.net["dec_layers"]):
            for w in ("wk", "wv"):
                saved[i, w] = layer["cross"][w]["w"].clone()
                layer["cross"][w]["w"].zero_()
    try:
        same, _ = model.decode_step(copy(st), tok)
    finally:
        with torch.no_grad():
            for (i, w), val in saved.items():
                model.net["dec_layers"][i]["cross"][w]["w"].copy_(val)
    torch.testing.assert_close(same, want, rtol=0, atol=0)
    zeroed = copy(st)
    zeroed.xk.zero_()
    zeroed.xv.zero_()
    moved, _ = model.decode_step(zeroed, tok)
    assert float((moved - want)[:, :512].abs().max()) > 1e-3


def test_frames_and_tokens_of_unequal_length_raise(runs):
    """As in the reference (whose cross-attention reshapes K into chunks of
    the queries' length), prefill, forward and loss take as many frames as
    tokens."""
    inputs, by_dtype = runs
    toks, labels, frames = inputs
    _, _, model, _ = by_dtype["float32"]
    batch = {"tokens": torch.from_numpy(toks[:, :6]),
             "labels": torch.from_numpy(labels[:, :6]),
             "frames": torch.from_numpy(frames[:, :10])}
    for call in (lambda: model.prefill(batch), lambda: model.forward(batch),
                 lambda: model.loss(batch)):
        with pytest.raises(ValueError, match="10 frames for 6 tokens"):
            call()


def test_weights_and_init_carry_the_reference_tree(runs):
    """The module's parameters are the reference's leaves, path for path;
    ``Model.init`` draws the same tree (a generator's draws, each at its
    shape)."""
    _, by_dtype = runs
    _, params, model, _ = by_dtype["float32"]
    ref_leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    n_ref = sum(int(np.prod(a.shape)) for _, a in ref_leaves)
    assert sum(p.numel() for p in model.net.parameters()) == n_ref
    names = dict(model.net.named_parameters())
    np.testing.assert_array_equal(
        names["dec_layers.1.cross.wk.w"].detach().numpy(),
        np.asarray(params["dec_layers"]["cross"]["wk"]["w"][1]))
    np.testing.assert_array_equal(names["ln_enc.bias"].detach().numpy(),
                                  np.asarray(params["ln_enc"]["bias"]))
    cfg = model.cfg
    fresh = build_model(cfg, device="cpu")
    fresh.init(torch.Generator().manual_seed(3))
    pieces = list(encdec.init_pieces(torch.Generator().manual_seed(3), cfg))
    assert [k for k, _ in pieces] == ["embed"] + ["enc_layers"] * 2 + \
        ["dec_layers"] * 2 + ["ln_enc", "ln_f", "unembed"]
    drawn = split_tree(pieces[3][1])[0]["cross"]["wq"]["w"]
    torch.testing.assert_close(
        fresh.net["dec_layers"][0]["cross"]["wq"]["w"], drawn, rtol=0,
        atol=0)
    assert set(fresh.net["dec_layers"][0]) == set(
        params["dec_layers"]) == {"ln_self", "self", "ln_cross", "cross",
                                  "ln_mlp", "mlp"}
    assert set(fresh.net["enc_layers"][0]) == set(params["enc_layers"])
    assert all(bool(torch.isfinite(p).all()) for p in fresh.net.parameters())


def test_paged_paths_are_none_and_decoder_only_stacks_refuse():
    """encdec has neither paged path (serving falls back on what is None),
    and the decoder-only stack and its states refuse it."""
    cfg = get_smoke_config(ARCH)
    tfm.check_family(cfg)
    assert "encdec" in tfm.FAMILIES
    model = build_model(cfg, device="cpu")
    assert isinstance(model.net, encdec.EncDec)
    assert model.decode_paged is None and model.prefill_chunk is None
    with pytest.raises(NotImplementedError, match="paged"):
        tfm.init_paged_state(cfg, 2, 4)
    for call in (lambda: tfm.Transformer(cfg),
                 lambda: tfm.init_state(cfg, 1, 8),
                 lambda: tfm.transformer_init(torch.Generator(), cfg)):
        with pytest.raises(ValueError, match="models.encdec"):
            call()
    with pytest.raises(ValueError, match="paged decode"):
        ContinuousScheduler(model, batch=2)
    st = encdec.encdec_state_init(cfg, 2, 16, 30)
    assert st.k.shape == (2, 2, 16, 4, 12) and st.xk.shape == (2, 2, 30, 4,
                                                               12)
    assert bool((st.kpos == -1).all())


def test_serving_loop_falls_back_to_cohort():
    """A continuous request with chunked prefill and the prefix cache runs
    the cohort loop without either; the cohort builds zero frames at its
    width."""
    model = build_model(get_smoke_config(ARCH), device="cpu")
    model.init(torch.Generator().manual_seed(1))
    loop = ServingLoop(model, batch=2, scheduler="continuous",
                       chunk_tokens=16, prefix_cache=True)
    assert loop.scheduler_kind == "cohort"
    assert isinstance(loop.scheduler, CohortScheduler)
    assert loop.chunk_tokens is None and loop.prefix_cache is False
    rng = np.random.default_rng(2)
    out = loop.run([Request(uid=i, prompt=rng.integers(0, 512, (8 + i,)),
                            max_new=2) for i in range(3)])
    assert all(len(v) == 2 for v in out.values())


@pytest.mark.parametrize("reverse", [False, True], ids=["fifo", "reversed"])
def test_cohort_greedy_matches_reference(reverse):
    """Greedy tokens of the port's ServingLoop (cohort fallback, batch 2,
    ragged prompts left-padded in a cohort over zero frames of its width)
    on the smoke model in fp32: the reference's, token for token."""
    ref, params, model = _model_pair("float32", key=1)
    rng = np.random.default_rng(0)
    lens, new = (12, 7, 9), (3, 4, 3)
    prompts = [rng.integers(0, 512, (n,)).astype(np.int32) for n in lens]

    def reqs(cls):
        arr = [0.0, 1.0, 2.0]
        return [cls(uid=i, prompt=p, max_new=m,
                    arrival=arr[2 - i] if reverse else arr[i])
                for i, (p, m) in enumerate(zip(prompts, new))]
    want = RefServingLoop(ref.cfg, params, batch=2).run(reqs(RefRequest))
    loop = ServingLoop(model, batch=2)
    assert loop.scheduler_kind == "cohort"
    assert loop.run(reqs(Request)) == want
