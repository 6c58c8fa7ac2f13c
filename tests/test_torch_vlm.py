"""The port's vlm family on CPU tensors against the reference's: the
phi-3-vision-4.2b smoke model on the reference's weights
(``load_reference_params``), its patch embeddings (B, P, d) through
``patch_proj`` prepended to the tokens in forward, loss (the labels padded
with -1 over the patch rows), prefill and decode, and its greedy tokens
under the continuous scheduler, which prefills whole prompts only.

Tolerances as tests/test_torch_ssm.py's: fp32 at 1e-4; bf16 (untied logits
of up to ~4, moved by up to 0.054 by rounding flips; the reference's own
bf16 logits differ from its fp32 ones by up to 0.072) at relative l2 3e-2
and each value within 1.5 times the reference's own bf16 - fp32
difference.
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
from repro.serve import Request as RefRequest
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import ServingLoop
from repro_torch.models import build_model
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import load_reference_params
from repro_torch.serve import ContinuousScheduler, Request

ARCH = "phi-3-vision-4.2b"
IMPLS = ["chunked", "flash"]
MODEL_TOL = 1e-4
BF16_REL_L2, BF16_OWN = 3e-2, 1.5
#: prompts of S tokens (after the patch rows), then DECODE teacher-forced
#: steps
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
    """tokens (2, S + DECODE), labels with a masked run, patches."""
    rng = np.random.default_rng(seed)
    cfg = get_smoke_config(ARCH)
    toks = rng.integers(0, 512, (2, S + DECODE)).astype(np.int32)
    labels = toks.copy()
    labels[1, :5] = -1
    patches = rng.normal(size=(2, cfg.n_patches, cfg.d_model)).astype(
        np.float32)
    return toks, labels, patches


def _reference_run(ref, params, toks, labels, patches):
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
             "patches": jnp.asarray(patches)}
    loss, metrics = jax.jit(ref.loss)(params, batch)
    out = {"forward": jax.jit(ref.forward)(params, batch),
           "loss": float(loss), "tokens": int(metrics["tokens"])}
    prefill = jax.jit(ref.prefill, static_argnames="budget")
    logits, st = prefill(params, {"tokens": batch["tokens"][:, :S],
                                  "patches": batch["patches"]},
                         budget=S + DECODE + 8)
    steps = [logits]
    step = jax.jit(ref.decode_step)
    for t in range(S, S + DECODE):
        logits, st = step(params, st, batch["tokens"][:, t:t + 1])
        steps.append(logits)
    out["steps"] = jnp.stack(steps, 1)
    out["state"] = st
    return out


def _port_run(model, toks, labels, patches):
    tb = {"tokens": torch.from_numpy(toks),
          "labels": torch.from_numpy(labels),
          "patches": torch.from_numpy(patches)}
    with torch.no_grad():
        loss, metrics = model.loss(tb)
        out = {"forward": model.forward(tb), "loss": float(loss),
               "tokens": int(metrics["tokens"])}
    logits, st = model.prefill({"tokens": tb["tokens"][:, :S],
                                "patches": tb["patches"]},
                               budget=S + DECODE + 8)
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
    """forward over the patch rows and the tokens (P + S rows of logits),
    the loss over the tokens alone (the labels padded with -1 over the patch
    rows), and a prefill of patches and S tokens then DECODE steps (the
    decode positions count the patch rows)."""
    inputs, by_dtype = runs
    _, _, model, want = by_dtype[dtype]
    got = _port_run(model.with_attention(impl), *inputs)
    cfg = model.cfg
    assert got["forward"].shape[1] == cfg.n_patches + S + DECODE
    assert got["tokens"] == want["tokens"] == int((inputs[1] >= 0).sum())
    if dtype == "float32":
        for what in ("forward", "steps"):
            _close(got[what], want[what], MODEL_TOL)
        assert got["loss"] == pytest.approx(want["loss"], abs=MODEL_TOL)
    else:
        fp32 = by_dtype["float32"][3]
        for what in ("forward", "steps"):
            _close_bf16(got[what], want[what], fp32[what])
        assert got["loss"] == pytest.approx(want["loss"], abs=1e-2)
    st = got["state"]
    np.testing.assert_array_equal(st.pos.numpy(),
                                  np.asarray(want["state"].pos))
    np.testing.assert_array_equal(st.kpos.numpy(),
                                  np.asarray(want["state"].kpos))
    assert int(st.pos[0]) == cfg.n_patches + S + DECODE


def test_patches_reach_the_model(runs):
    """Without patches the logits are the tokens' alone (the reference's
    too); other patches give other logits; patch_proj is a parameter."""
    inputs, by_dtype = runs
    ref, params, model, _ = by_dtype["float32"]
    toks, _, patches = inputs
    with torch.no_grad():
        bare = model.forward({"tokens": torch.from_numpy(toks)})
        other = model.forward({"tokens": torch.from_numpy(toks),
                               "patches": torch.from_numpy(patches * 2)})
        with_p = model.forward({"tokens": torch.from_numpy(toks),
                                "patches": torch.from_numpy(patches)})
    assert bare.shape[1] == toks.shape[1]
    _close(bare, ref.forward(params, {"tokens": jnp.asarray(toks)}),
           MODEL_TOL)
    assert float((other - with_p).abs().max()) > 1e-2
    assert "patch_proj.w" in dict(model.net.named_parameters())


def test_weights_carry_across(runs):
    _, by_dtype = runs
    _, params, model, _ = by_dtype["float32"]
    assert sum(p.numel() for p in model.net.parameters()) == \
        sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    np.testing.assert_array_equal(
        model.net["patch_proj"]["w"].detach().numpy(),
        np.asarray(params["patch_proj"]["w"]))


def test_paged_decode_but_no_chunked_prefill():
    """vlm keeps the paged decode (its state is attention alone) but not
    prefill_chunk (patch rows cannot be chunk-aligned): the reference's
    Model fields (tests/test_serve.py)."""
    model = build_model(get_smoke_config(ARCH), device="cpu")
    assert model.decode_paged is not None and model.prefill_chunk is None
    assert tfm.init_paged_state(model.cfg, 2, 4).k.shape[0] == \
        model.cfg.n_layers
    with pytest.raises(ValueError, match="vlm"):
        ContinuousScheduler(model, batch=1, max_seq=64, block_len=8,
                            chunk_tokens=16)
    loop = ServingLoop(model, batch=2, chunk_tokens=16, prefix_cache=True)
    assert loop.scheduler_kind == "continuous"
    assert loop.chunk_tokens is None and loop.prefix_cache is False


def test_continuous_greedy_matches_reference():
    """Greedy tokens of the port's ServingLoop (continuous, whole-prompt
    prefills with zero patch embeddings, paged decode) on the smoke model
    in fp32: the reference's, token for token, FIFO and reversed."""
    ref, params, model = _model_pair("float32", key=1)
    rng = np.random.default_rng(0)
    lens, new = (12, 7, 9), (3, 4, 3)
    prompts = [rng.integers(0, 512, (n,)).astype(np.int32) for n in lens]

    def reqs(cls, reverse=False):
        arr = [0.0, 1.0, 2.0]
        return [cls(uid=i, prompt=p, max_new=m,
                    arrival=arr[2 - i] if reverse else arr[i])
                for i, (p, m) in enumerate(zip(prompts, new))]
    for reverse in (False, True):
        want = RefServingLoop(ref.cfg, params, batch=2, max_seq=64,
                              block_len=8).run(reqs(RefRequest, reverse))
        loop = ServingLoop(model, batch=2, max_seq=64, block_len=8)
        assert loop.scheduler_kind == "continuous"
        assert loop.run(reqs(Request, reverse)) == want
        assert loop.scheduler.cache.used_blocks == 0
