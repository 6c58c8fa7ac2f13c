"""The port's training path on the CPU: the products' autograd Function
(``layers.KernelLinear``) with the kernel's plain product injected, the
tied embedding's gradient through the logits, remat, one train step of
qwen2-1.5b's smoke model against the reference's ``build_train_step`` from
the same parameters, microbatching and bf16 gradient compression, the
training loop's descent and resume, and the families that still refuse a
loss under autograd on the card (moe and ssm train there:
tests/test_torch_train_families.py).

Tolerances.  The product Function against autograd through torch.matmul in
fp32: 1e-5 of the largest value (the plain product sums K in tiles of 128,
torch.matmul in its own order).  The train step against the reference in
fp32: the loss and the gradient norm to 1e-6 relative and each leaf's
gradient to 1e-5 of its largest value (both compute in f32, with sums in
orders of their own, the port's attention through the flash route's
tiles: 7.6e-8, 4.6e-8 and 1.6e-6 measured); in bf16 (the smoke config's
compute type) each framework rounds its products and elementwise results
to bf16 on its own: the loss to 1e-4, the gradient norm to 2e-3 and each
leaf's relative l2 to 5e-2 (2.0e-5, 3.7e-4 and 2.1e-2 measured, the last
on layer 1's q bias).  The parameters after the update in fp32: the
update's relative l2 to 1e-2 (AdamW's first step is lr x sign(g), so a
gradient value near 0 may flip)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.core.config import RunConfig as RefRunConfig
from repro.distributed.sharding import split_tree as ref_split_tree
from repro.launch.train import build_train_step as ref_build_train_step
from repro.models import build_model as ref_build_model
from repro.optim import adamw_init as ref_adamw_init
from repro_torch.configs import get_smoke_config
from repro_torch.core.config import ArchConfig, AttnConfig, RunConfig
from repro_torch.data import synth_batch
from repro_torch.kernels import matmul
from repro_torch.launch.train import (build_train_step, microbatch_split,
                                      train_loop)
from repro_torch.models import build_model, layers
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import load_reference_params
from repro_torch.models.model import CARD_TRAINING_WAITS
from repro_torch.optim import adamw_init

ARCH = "qwen2-1.5b"


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


def _rel(got, want):
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _close_max(got, want, tol):
    got, want = got.detach().double(), want.detach().double()
    lim = tol * float(want.abs().max())
    assert float((got - want).abs().max()) <= lim


# -- the products' Function --------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(128, 256, 128), (100, 200, 130),
                                   (1, 96, 40)],
                         ids=["blocks", "padded", "one-row"])
@pytest.mark.parametrize("transposed", [False, True], ids=["w", "w.t"])
def test_kernel_linear_matches_autograd_through_matmul(m, k, n, transposed):
    """out, dX and dW of ``KernelLinear`` on ``matmul_plain`` (operands
    padded to 128-row tiles and 128-multiples, as on the card) against
    autograd through torch.matmul, in fp32."""
    g = torch.Generator().manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g)
    w = torch.randn((n, k) if transposed else (k, n), generator=g)
    dy = torch.randn(m, n, generator=g)
    xs, ws = x.clone().requires_grad_(True), torch.nn.Parameter(w.clone())
    out = layers.kernel_linear(xs, ws, torch.float32, transposed,
                               product=matmul.matmul_plain)
    assert out.shape == (m, n) and out.dtype == torch.float32
    out.backward(dy)
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    ref = xr @ (wr.t() if transposed else wr)
    ref.backward(dy)
    _close_max(out, ref, 1e-5)
    _close_max(xs.grad, xr.grad, 1e-5)
    _close_max(ws.grad, wr.grad, 1e-5)
    assert ws.grad.dtype == torch.float32


def test_kernel_linear_rounds_dw_to_the_compute_type():
    """In bf16, dX comes back in x's type and dW is the bf16 rounding of
    the f32 sums, cast to the weight's f32 (the reference's gradient of
    ``w.astype(bf16)``)."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(130, 256, generator=g).bfloat16().requires_grad_(True)
    w = torch.nn.Parameter(torch.randn(256, 200, generator=g))
    dy = torch.randn(130, 200, generator=g)
    layers.kernel_linear(x, w, torch.bfloat16,
                         product=matmul.matmul_plain).backward(dy)
    dyb = dy.bfloat16().float()
    want_dw = (x.detach().float().t() @ dyb).bfloat16().float()
    want_dx = (dyb @ w.detach().bfloat16().float().t()).bfloat16()
    assert x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.float32
    assert torch.equal(w.grad.bfloat16().float(), w.grad)
    _close_max(w.grad, want_dw, 1e-2)
    _close_max(x.grad, want_dx, 1e-2)


def test_linear_on_the_card_gives_the_bias_its_gradient(monkeypatch):
    """The kernel route's bias: under autograd it is cast at the call (the
    kept copy carries no gradient); its gradient is the plain route's."""
    g = torch.Generator().manual_seed(2)
    p = {"w": torch.nn.Parameter(torch.randn(64, 48, generator=g)),
         "b": torch.nn.Parameter(torch.randn(48, generator=g))}
    x = torch.randn(3, 5, 64, generator=g)
    dy = torch.randn(3, 5, 48, generator=g)
    layers.linear(p, x, torch.float32).backward(dy)
    want = {k: v.grad.clone() for k, v in p.items()}
    for v in p.values():
        v.grad = None
    monkeypatch.setattr(layers, "_on_card", lambda x: True)
    layers.linear(p, x, torch.float32).backward(dy)
    for k in p:
        _close_max(p[k].grad, want[k], 1e-5)


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_unembed_gradient_reaches_the_weight_on_the_card(monkeypatch, tied):
    """The logits' product on the card runs ``kernel_linear`` with the
    transposed ``emb`` (tied) or ``unembed.w``: the logits term's gradient
    reaches the weight, equal to the plain route's (no silent zero)."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32",
                              tie_embeddings=tied)
    model = build_model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(3))
    w = model.net["embed"]["emb"] if tied else model.net["unembed"]["w"]
    x = torch.randn(2, 9, cfg.d_model,
                    generator=torch.Generator().manual_seed(4))
    dy = torch.randn(2, 9, layers.padded_vocab(cfg),
                     generator=torch.Generator().manual_seed(5))
    (want,) = torch.autograd.grad((tfm.unembed(model.net, x) * dy).sum(), w)
    monkeypatch.setattr(layers, "_on_card", lambda x: True)
    logits = tfm.unembed(model.net, x)
    assert logits.grad_fn is not None
    (got,) = torch.autograd.grad((logits * dy).sum(), w)
    assert bool(got.abs().sum() > 0)
    _close_max(got, want, 1e-5)


def test_remat_on_and_off_give_the_same_bits():
    model = build_model(get_smoke_config(ARCH), device="cpu")
    model.init(torch.Generator().manual_seed(6))
    batch = {k: torch.from_numpy(v) for k, v in synth_batch(
        model.cfg, batch=2, seq=40, seed=0, step=0).items()}
    params = list(model.net.parameters())
    out = {}
    for remat in (True, False):
        loss, _ = model.loss(batch, remat=remat)
        out[remat] = (loss, torch.autograd.grad(loss, params))
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)


# -- one train step against the reference's -----------------------------------

def _pair(dtype):
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
    ref = ref_build_model(dataclasses.replace(ref_smoke(ARCH), dtype=dtype))
    params, _ = ref_split_tree(ref.init(jax.random.PRNGKey(7)))
    model = build_model(cfg, device="cpu")
    load_reference_params(model, jax.tree.map(np.asarray, params))
    batch = synth_batch(cfg, batch=4, seq=48, seed=1, step=0)
    return cfg, ref, params, model, batch


def _by_name(cfg, tree):
    """A reference tree (gradients, parameters) keyed by the port's
    parameter names: loaded into a model of the port."""
    holder = build_model(cfg, device="cpu")
    load_reference_params(holder, jax.tree.map(np.asarray, tree))
    return {k: v.detach() for k, v in holder.net.named_parameters()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_matches_reference(dtype):
    cfg, ref, params, model, batch = _pair(dtype)
    run = RunConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    ref_run = RefRunConfig(lr=1e-3, warmup_steps=2, total_steps=10,
                           zero1=False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, ref_metrics), ref_grads = jax.value_and_grad(
        lambda p: ref.loss(p, jb), has_aux=True)(params)
    new_p, _, ref_m = jax.jit(ref_build_train_step(ref, ref_run))(
        params, ref_adamw_init(params), jb, jnp.zeros((), jnp.int32))
    before = {k: v.detach().clone()
              for k, v in model.net.named_parameters()}
    step = build_train_step(model, run)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads, metrics = step.gradients(tb)
    opt, m = step(adamw_init(dict(model.net.named_parameters())), tb, 0)
    assert int(opt.step) == 1 and m["lr"] == pytest.approx(float(ref_m["lr"]))
    assert float(m["tokens"]) == float(ref_m["tokens"])
    want = _by_name(cfg, ref_grads)
    assert sorted(grads) == sorted(want)
    if dtype == "float32":
        assert float(m["ce"]) == pytest.approx(float(ref_m["ce"]), rel=1e-6)
        assert float(m["grad_norm"]) == pytest.approx(
            float(ref_m["grad_norm"]), rel=1e-6)
        for k, g in want.items():
            _close_max(grads[k], g, 1e-5)
        old, new = before, dict(model.net.named_parameters())
        for k, w in _by_name(cfg, new_p).items():
            assert _rel(new[k] - old[k], w - old[k]) < 1e-2, k
    else:
        assert float(m["ce"]) == pytest.approx(float(ref_m["ce"]), rel=1e-4)
        assert float(m["grad_norm"]) == pytest.approx(
            float(ref_m["grad_norm"]), rel=2e-3)
        for k, g in want.items():
            assert _rel(grads[k], g) < 5e-2, k
    assert float(metrics["ce"]) == float(m["ce"])


def _cfg(vocab=64):
    return ArchConfig(name="it", family="dense", n_layers=2, d_model=32,
                      n_heads=4, n_kv_heads=2, d_ff=64, vocab=vocab,
                      attn=AttnConfig(chunk=16))


def _step_with(model, params, batch, **run_kw):
    with torch.no_grad():
        for k, p in model.net.named_parameters():
            p.copy_(params[k])
    run = RunConfig(zero1=False, warmup_steps=1, total_steps=10, **run_kw)
    opt, m = build_train_step(model, run)(
        adamw_init(dict(model.net.named_parameters())), batch, 0)
    return ({k: v.detach().clone() for k, v in model.net.named_parameters()},
            float(m["ce"]), float(m["grad_norm"]))


def test_grad_accumulation_matches_single_batch():
    """A = 4 microbatches against A = 1, as tests/test_integration.py asks
    of the reference: loss to 5e-3, gradient norm and the update's size to
    1e-2 and 5e-2 relative."""
    cfg = _cfg()
    model = build_model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    params = {k: v.detach().clone() for k, v in model.net.named_parameters()}
    batch = {k: torch.from_numpy(v) for k, v in
             synth_batch(cfg, batch=8, seq=32, seed=0, step=0).items()}
    assert [mb["tokens"].shape for mb in microbatch_split(batch, 4)] == \
        [(2, 32)] * 4
    outs = {a: _step_with(model, params, batch, microbatches=a,
                          clip_norm=0.0) for a in (1, 4)}
    assert abs(outs[1][1] - outs[4][1]) < 5e-3
    assert abs(outs[1][2] - outs[4][2]) / outs[1][2] < 1e-2

    def moved(p):
        return float(torch.sqrt(sum(((p[k] - params[k]) ** 2).sum()
                                    for k in params)))
    d1, d4 = moved(outs[1][0]), moved(outs[4][0])
    assert abs(d1 - d4) / d1 < 0.05


def test_bf16_grad_compression_close_to_fp32():
    cfg = _cfg()
    model = build_model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    params = {k: v.detach().clone() for k, v in model.net.named_parameters()}
    batch = {k: torch.from_numpy(v) for k, v in
             synth_batch(cfg, batch=8, seq=32, seed=0, step=0).items()}
    outs = {c: _step_with(model, params, batch, microbatches=4,
                          grad_compression=c) for c in ("none", "bf16")}
    assert abs(outs["none"][1] - outs["bf16"][1]) < 2e-2
    # each addition rounded to bf16: the gradients differ, the step moves
    assert any(not torch.equal(outs["none"][0][k], outs["bf16"][0][k])
               for k in params)


def test_bf16_accumulation_rounds_each_addition():
    """The bf16 accumulator is a bf16 sum of bf16 gradients, then divided
    in bf16 and widened: the reference's ``acc + g.astype(bf16)``."""
    cfg = _cfg()
    model = build_model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(1))
    batch = {k: torch.from_numpy(v) for k, v in
             synth_batch(cfg, batch=4, seq=32, seed=0, step=0).items()}
    one = build_train_step(model, RunConfig(microbatches=1))
    per_mb = [one.gradients(mb)[0] for mb in microbatch_split(batch, 2)]
    got, _ = build_train_step(model, RunConfig(
        microbatches=2, grad_compression="bf16")).gradients(batch)
    for k, g in got.items():
        acc = torch.zeros_like(g, dtype=torch.bfloat16)
        for mb in per_mb:
            acc = acc + mb[k].bfloat16()
        assert torch.equal(g, (acc / 2).float()), k


# -- the training loop --------------------------------------------------------

def test_training_descends():
    run = RunConfig(lr=3e-3, warmup_steps=3, total_steps=40, zero1=False)
    _, _, history = train_loop(_cfg(), run, steps=40, batch=8, seq=32,
                               device="cpu")
    first, last = np.mean(history[:5]), np.mean(history[-5:])
    assert last < first - 0.2, (first, last)


def test_checkpoint_resume_is_exact(tmp_path):
    """Training N steps straight == training k, restarting from the
    checkpoint into a fresh model and optimizer, training N - k (the
    reference's rtol 1e-5, atol 1e-6)."""
    cfg = _cfg()
    run = RunConfig(lr=1e-3, warmup_steps=2, total_steps=20, zero1=False)
    straight, _, _ = train_loop(cfg, run, steps=10, batch=4, seq=32,
                                device="cpu")
    d = str(tmp_path / "ck")
    train_loop(cfg, run, steps=6, batch=4, seq=32, ckpt_dir=d, device="cpu")
    resumed, opt, history = train_loop(cfg, run, steps=10, batch=4, seq=32,
                                       ckpt_dir=d, resume=True, device="cpu")
    assert len(history) == 4 and int(opt.step) == 10
    want = dict(straight.net.named_parameters())
    for k, p in resumed.net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[k].detach().numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_train_loop_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_loop(_cfg(), RunConfig(), steps=1)


# -- the families that wait ---------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "xlstm-1.3b",
                                  "phi-3-vision-4.2b", "hymba-1.5b",
                                  "whisper-medium"])
def test_other_families_refuse_a_loss_under_autograd_on_the_card(
        monkeypatch, arch):
    """On the card (a patched ``layers._on_card``) a loss under autograd
    of a family that waits (``CARD_TRAINING_WAITS``: vlm, hybrid, encdec)
    raises ValueError naming what it waits for before any product runs;
    without autograd, or on the CPU, it runs.  moe and ssm train there:
    their loss under autograd runs through the card route (the kernels'
    plain versions on CPU tensors; the expert and headwise products
    through ``layers.ExpertProduct``) and gives the plain route's
    gradients, each leaf to 1e-2 relative l2 in the smoke configs' bf16
    (the two routes round apart; tests/test_torch_train_families.py)."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(8))
    batch = {k: torch.from_numpy(v) for k, v in
             synth_batch(cfg, batch=2, seq=40, seed=0, step=0).items()}
    loss, _ = model.loss(batch)
    assert loss.requires_grad
    family = "encdec" if cfg.is_encdec else cfg.family
    if family in ("moe", "ssm"):
        assert family not in CARD_TRAINING_WAITS
        params = list(model.net.parameters())
        want = torch.autograd.grad(loss, params)
        backward = []
        real = layers.ExpertProduct.backward
        monkeypatch.setattr(layers, "_on_card", lambda x: True)
        monkeypatch.setattr(layers.ExpertProduct, "backward", staticmethod(
            lambda ctx, dy: backward.append(1) or real(ctx, dy)))
        got = torch.autograd.grad(model.loss(batch)[0], params)
        assert backward
        for g, w in zip(got, want):
            assert _rel(g, w) < 1e-2
        return
    products = []
    monkeypatch.setattr(layers, "_on_card", lambda x: True)
    monkeypatch.setattr(layers, "kernel_linear",
                        lambda *a, **kw: products.append(1))
    with pytest.raises(ValueError, match="backward pass") as e:
        model.loss(batch)
    assert CARD_TRAINING_WAITS[family] in str(e.value) and not products
