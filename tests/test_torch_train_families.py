"""Training the moe and ssm families on the card's route, on the CPU: the
batched product's autograd Function (``layers.ExpertProduct``) with the
kernel's plain version injected, the plain version's transposed forms
(the batched kernel's backward), their refusals, and one train step of
the qwen2-moe-a2.7b and xlstm-1.3b smoke models with the card route
patched on (``layers._on_card``) against the reference's
``build_train_step`` from the same parameters.

Tolerances.  The Function against autograd through torch.bmm in fp32:
1e-5 of the largest value, as ``KernelLinear``'s (the plain product sums
K in tiles of 128, bmm in its own order).  The train step in fp32: the
loss and the gradient norm to 1e-6 relative, as the dense family's; each
leaf's gradient to 1e-5 of its largest value for qwen2-moe (1.7e-6
measured) and 3e-5 for xlstm (1.48e-5 measured on layer 1's w_up, and
1.50e-5 by the port's plain route: the chunkwise mLSTM sums in another
order than the reference's scan).  In bf16 each framework rounds its
products and elementwise results on its own, and the reference's fused
CPU code rounds less often: the dense family's 1e-4, 2e-3 and 5e-2 do not
hold for these two models on either of the port's routes (loss 1.03e-4
and 5.6e-5, gradient norm 4.4e-3 and 1.13e-2, the worst leaf's relative
l2 0.22 on qwen2-moe's router and 0.10 on xlstm's w_i, measured through
the card route and through torch.bmm alike).  So in bf16 the loss is
held to 5e-4 and the gradient norm to 3e-2 relative, each leaf to 5e-2
or 1.25 x the port's plain route's own distance to the reference, and
each leaf of the card route to the plain route's to 1e-2 relative l2
(1.2e-3 and 8.3e-5 measured)."""
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
from repro_torch.core.async_pipeline import PipelineSpec, Strategy
from repro_torch.core.config import RunConfig
from repro_torch.data import synth_batch
from repro_torch.kernels import matmul
from repro_torch.launch.train import build_train_step
from repro_torch.models import build_model, layers
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import load_reference_params
from repro_torch.optim import adamw_init


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests (see
    tests/test_torch_train.py)."""
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


def _blocked(calls):
    """``matmul_batched_plain`` that records each call's flags and checks
    that every operand it is handed is padded to the kernel's blocks."""
    def product(a, b, **trans):
        assert all(d % matmul.BLOCK == 0 for d in (*a.shape[1:],
                                                    *b.shape[1:]))
        calls.append(tuple(sorted(k for k, v in trans.items() if v)))
        return matmul.matmul_batched_plain(a, b, **trans)
    return product


# -- the batched product's Function ---------------------------------------

SHAPES = [(4, 128, 256, 128), (6, 171, 200, 130), (3, 1, 96, 40)]
SHAPE_IDS = ["blocks", "padded", "one-row"]


@pytest.mark.parametrize("e,c,k,n", SHAPES, ids=SHAPE_IDS)
def test_expert_product_matches_autograd_through_bmm(e, c, k, n):
    """out, dA and dW of ``ExpertProduct`` on ``matmul_batched_plain``
    (every operand padded to the kernel's blocks, the backward on the
    transposed forms) against autograd through torch.bmm, in fp32."""
    g = torch.Generator().manual_seed(e + c + k + n)
    a = torch.randn(e, c, k, generator=g)
    w = torch.randn(e, k, n, generator=g)
    dy = torch.randn(e, c, n, generator=g)
    calls = []
    a_s, w_s = a.clone().requires_grad_(True), w.clone().requires_grad_(True)
    out = layers.ExpertProduct.apply(a_s, w_s, _blocked(calls))
    assert out.shape == (e, c, n) and out.dtype == torch.float32
    out.backward(dy)
    assert calls == [(), ("trans_b",), ("trans_a",)]
    a_r, w_r = a.clone().requires_grad_(True), w.clone().requires_grad_(True)
    ref = torch.bmm(a_r, w_r)
    ref.backward(dy)
    _close_max(out, ref, 1e-5)
    _close_max(a_s.grad, a_r.grad, 1e-5)
    _close_max(w_s.grad, w_r.grad, 1e-5)


def test_expert_product_rounds_da_and_dw_to_bf16():
    """In bf16 dA and dW are the bf16 roundings of the f32 sums, dW then
    cast to the f32 master by the cast before the call (the reference's
    gradient of ``w.astype(bf16)``)."""
    g = torch.Generator().manual_seed(1)
    a = torch.randn(6, 171, 200, generator=g).bfloat16().requires_grad_(True)
    w = torch.nn.Parameter(torch.randn(6, 200, 130, generator=g))
    dy = torch.randn(6, 171, 130, generator=g)
    layers.ExpertProduct.apply(a, w.bfloat16(),
                               matmul.matmul_batched_plain).backward(dy)
    dyb = dy.bfloat16().float()
    want_dw = torch.bmm(a.detach().float().transpose(1, 2), dyb)
    want_da = torch.bmm(dyb, w.detach().bfloat16().float().transpose(1, 2))
    assert a.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.float32
    assert torch.equal(w.grad.bfloat16().float(), w.grad)
    _close_max(w.grad, want_dw.bfloat16().float(), 1e-2)
    _close_max(a.grad, want_da.bfloat16(), 1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_product_takes_the_card_route(monkeypatch, dtype):
    """``expert_product`` on the card (a patched ``_on_card``): bf16 through
    ``ExpertProduct`` (its backward runs the transposed forms), f32 a
    ``kernel_linear`` a product; either way the gradients are the plain
    route's (torch.bmm in the compute type): f32 to 1e-5 of the largest
    value, bf16 to one rounding (1e-2)."""
    g = torch.Generator().manual_seed(2)
    a = torch.randn(5, 171, 96, generator=g)
    w = torch.randn(5, 96, 40, generator=g)
    dy = torch.randn(5, 171, 40, generator=g)

    def grads():
        a_, w_ = a.clone().requires_grad_(True), w.clone().requires_grad_(True)
        layers.expert_product(a_, w_, dtype).float().backward(dy)
        return a_.grad, w_.grad
    want = grads()
    calls, linear = [], []
    real_bkp, real_kl = layers.batched_kernel_product, layers.kernel_linear
    monkeypatch.setattr(layers, "_on_card", lambda x: True)
    monkeypatch.setattr(layers, "batched_kernel_product",
                        lambda *x, **kw: calls.append(kw) or
                        real_bkp(*x, **kw))
    monkeypatch.setattr(layers, "kernel_linear",
                        lambda *x, **kw: linear.append(1) or
                        real_kl(*x, **kw))
    got = grads()
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for g_, w_ in zip(got, want):
        assert g_.dtype == w_.dtype == torch.float32
        _close_max(g_, w_, tol)
    if dtype == torch.float32:
        assert not calls and len(linear) == 5
    else:
        assert [kw.get("trans_a", False) for kw in calls] == \
            [False, False, True] and not linear


# -- the plain version's transposed forms ---------------------------------

@pytest.mark.parametrize("e,m,k,n", [(1, 128, 128, 128), (3, 128, 256, 384),
                                     (2, 256, 384, 640)])
@pytest.mark.parametrize("form", ["trans_a", "trans_b"])
def test_batched_plain_transposed_forms(form, e, m, k, n):
    """``matmul_batched_plain`` with ``trans_a`` (a stored (E, K, M)) or
    ``trans_b`` (b stored (E, N, K)): the same bits as on contiguous
    transposed copies, and bmm of the transposes to f32 rounding; on CPU
    tensors the wrapper is it, with no launch."""
    g = torch.Generator().manual_seed(e + m + k + n)
    a = torch.randn(e, m, k, generator=g).bfloat16()
    b = torch.randn(e, k, n, generator=g).bfloat16()
    a_s = a.transpose(1, 2).contiguous() if form == "trans_a" else a
    b_s = b.transpose(1, 2).contiguous() if form == "trans_b" else b
    got = matmul.matmul_batched_plain(a_s, b_s, **{form: True})
    assert got.shape == (e, m, n) and got.dtype == torch.float32
    assert torch.equal(got, matmul.matmul_batched_plain(a, b))
    torch.testing.assert_close(got, torch.bmm(a.float(), b.float()),
                               rtol=1e-5, atol=1e-4)
    before = dict(matmul.BATCHED_T_LAUNCHES)
    assert torch.equal(matmul.matmul_batched_cuda(
        a_s, b_s, spec=PipelineSpec(Strategy.TMA, 2), **{form: True}), got)
    assert matmul.BATCHED_T_LAUNCHES == before


@pytest.mark.parametrize("strategy", list(Strategy))
def test_batched_transposed_forms_take_tma_alone(strategy):
    """The transposed forms are built for TMA at a ring of 2 slots or more,
    one flag at a time: the other strategies raise ValueError at the moe
    training shapes, TMA takes them; both flags raise; a wrapper call with
    mismatched operands raises."""
    shapes = ((60, 256, 1408, 2048), (60, 2048, 256, 1408),
              (60, 1408, 256, 2048), (4, 1024, 2048, 1024))
    for form in ("trans_a", "trans_b"):
        for e, m, k, n in shapes:
            if strategy is Strategy.TMA:
                matmul.check_batched_card_config(
                    torch.bfloat16, PipelineSpec(strategy), e, m, k, n,
                    **{form: True})
                continue
            with pytest.raises(ValueError, match="built for TMA"):
                matmul.check_batched_card_config(
                    torch.bfloat16, PipelineSpec(strategy), e, m, k, n,
                    **{form: True})
    with pytest.raises(ValueError, match="not both"):
        matmul.check_batched_card_config(
            torch.bfloat16, PipelineSpec(Strategy.TMA), 4, 128, 128, 128,
            trans_a=True, trans_b=True)
    with pytest.raises(ValueError, match="batched"):
        matmul.matmul_batched_cuda(torch.zeros(2, 256, 128),
                                   torch.zeros(2, 128, 128), trans_a=True)


# -- one train step against the reference's -------------------------------

ARCHS = ["qwen2-moe-a2.7b", "xlstm-1.3b"]
#: each leaf's gradient in fp32, of its largest value (module docstring)
LEAF_F32 = {"qwen2-moe-a2.7b": 1e-5, "xlstm-1.3b": 3e-5}


def _by_name(cfg, tree):
    """A reference tree keyed by the port's parameter names."""
    holder = build_model(cfg, device="cpu")
    load_reference_params(holder, jax.tree.map(np.asarray, tree))
    return {k: v.detach() for k, v in holder.net.named_parameters()}


def _products(cfg) -> int:
    """Batched products a forward: three a moe layer (gate, up, down) or a
    mLSTM layer (headwise q, k, v)."""
    if cfg.family == "moe":
        return 3 * cfg.n_layers
    return 3 * tfm.ssm_layer_counts(cfg)[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_give_the_same_bits(arch):
    """Each moe decoder layer and each xlstm block under
    torch.utils.checkpoint (the reference's jax.checkpoint of a layer):
    the loss and every gradient bit-identical to the run without."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(6))
    batch = {k: torch.from_numpy(v) for k, v in synth_batch(
        cfg, batch=2, seq=40, seed=0, step=0).items()}
    params = list(model.net.parameters())
    out = {}
    for remat in (True, False):
        loss, _ = model.loss(batch, remat=remat)
        out[remat] = (loss, torch.autograd.grad(loss, params))
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_through_the_card_route_matches_reference(
        monkeypatch, arch, dtype):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    ref = ref_build_model(dataclasses.replace(ref_smoke(arch), dtype=dtype))
    params, _ = ref_split_tree(ref.init(jax.random.PRNGKey(7)))
    model = build_model(cfg, device="cpu")
    load_reference_params(model, jax.tree.map(np.asarray, params))
    batch = synth_batch(cfg, batch=4, seq=48, seed=1, step=0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, _), ref_grads = jax.jit(jax.value_and_grad(
        lambda p: ref.loss(p, jb), has_aux=True))(params)
    ref_run = RefRunConfig(lr=1e-3, warmup_steps=2, total_steps=10,
                           zero1=False)
    new_p, _, ref_m = jax.jit(ref_build_train_step(ref, ref_run))(
        params, ref_adamw_init(params), jb, jnp.zeros((), jnp.int32))
    run = RunConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    plain, _ = build_train_step(model, run).gradients(tb)
    before = {k: v.detach().clone()
              for k, v in model.net.named_parameters()}

    forms, experts = [], []
    real_bkp, real_kl = layers.batched_kernel_product, layers.kernel_linear

    def bkp(*args, **kw):
        forms.append(tuple(k for k, v in kw.items() if k != "product" and v))
        return real_bkp(*args, **kw)

    def kl(x, w, *args, **kw):
        if w._base is not None and w._base.dim() == 3:   # a stack's slice
            experts.append(1)
        return real_kl(x, w, *args, **kw)
    monkeypatch.setattr(layers, "_on_card", lambda x: True)
    monkeypatch.setattr(layers, "batched_kernel_product", bkp)
    monkeypatch.setattr(layers, "kernel_linear", kl)
    step = build_train_step(model, run)
    grads, metrics = step.gradients(tb)
    opt, m = step(adamw_init(dict(model.net.named_parameters())), tb, 0)
    monkeypatch.undo()
    assert int(opt.step) == 1 and float(m["ce"]) == float(metrics["ce"])
    assert float(m["tokens"]) == float(ref_m["tokens"])
    # remat: each product forward twice a pass (the layer's recompute),
    # the transposed forms once; two passes (gradients, then the step)
    n = _products(cfg)
    if dtype == "bfloat16":
        assert forms.count(()) == 2 * 2 * n and not experts
        assert forms.count(("trans_a",)) == forms.count(("trans_b",)) == 2 * n
    else:
        width = cfg.moe.n_experts if cfg.family == "moe" else cfg.n_heads
        assert not forms and len(experts) == 2 * 2 * n * width
    want = _by_name(cfg, ref_grads)
    assert sorted(grads) == sorted(want)
    if dtype == "float32":
        assert float(m["ce"]) == pytest.approx(float(ref_m["ce"]), rel=1e-6)
        assert float(m["grad_norm"]) == pytest.approx(
            float(ref_m["grad_norm"]), rel=1e-6)
        for k, g in want.items():
            _close_max(grads[k], g, LEAF_F32[arch])
        new = dict(model.net.named_parameters())
        for k, w in _by_name(cfg, new_p).items():
            assert _rel(new[k] - before[k], w - before[k]) < 1e-2, k
    else:
        assert float(m["ce"]) == pytest.approx(float(ref_m["ce"]), rel=5e-4)
        assert float(m["grad_norm"]) == pytest.approx(
            float(ref_m["grad_norm"]), rel=3e-2)
        for k, g in want.items():
            assert _rel(grads[k], g) < max(5e-2, 1.25 * _rel(plain[k], g)), k
            assert _rel(grads[k], plain[k]) < 1e-2, k
