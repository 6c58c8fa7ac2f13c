"""The port's moe family on CPU tensors against the reference's
(``repro.models.moe``, ``repro.models.transformer``, ``repro.serve``) on the
same numpy inputs and the reference's weights, and the batched matmul
launch's wrapper, its plain version and its padding.

Both moe smoke configs: qwen2-moe (4 heads of 12, 6 experts top-2, two
shared experts behind the sigmoid gate, QKV bias) and qwen3-moe (GQA 4
over 2 heads of 16, 8 experts top-2, no shared experts).

Tolerances.  ``moe_apply`` alone in fp32 is the same arithmetic: 1e-5; in
bf16 each framework rounds its products and elementwise results on its
own: 3e-2, the dense mlp's (tests/test_torch_models.py).  The whole model
runs in fp32 at 1e-4, the other dense archs' tolerance there: a bf16
rounding difference in a hidden value can swap the k-th and (k+1)-th
expert of a token, and then its row differs by a whole expert.  The
inputs are normal draws, so no two router probabilities tie (the two
packages' top-k may break an exact tie differently; neither adds a
tie-break).  A ``capacity_factor`` of 0.3 makes every call drop
assignments, and the outputs hold with the reference's drops.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.distributed.sharding import split_tree as ref_split_tree
from repro.models import build_model as ref_build_model
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tfm
from repro.serve import ContinuousScheduler as RefContinuous
from repro.serve import Request as RefRequest
from repro_torch.configs import get_smoke_config
from repro_torch.core.async_pipeline import PipelineSpec, Strategy
from repro_torch.distributed import split_tree
from repro_torch.kernels import _build, matmul
from repro_torch.models import build_model, layers, moe
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import load_reference_params
from repro_torch.serve import ContinuousScheduler, Request

ARCHS = ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"]
#: the whole model in fp32 (see the module docstring)
MODEL_TOL = 1e-4


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _configs(arch, dtype="float32", **moe_kw):
    """(reference cfg, port cfg) of the smoke config in ``dtype``, its
    MoEConfig fields replaced by ``moe_kw``."""
    out = []
    for cfg in (ref_smoke(arch), get_smoke_config(arch)):
        out.append(dataclasses.replace(
            cfg, dtype=dtype, moe=dataclasses.replace(cfg.moe, **moe_kw)))
    return out


def _moe_params(ref_cfg, seed):
    """The reference's moe parameters: (jnp tree, torch tree)."""
    params, _ = ref_split_tree(ref_moe.moe_init(jax.random.PRNGKey(seed),
                                                ref_cfg))
    return params, jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                                params)


def _x(seed, d, b=2, s=9):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(
        np.float32)


# -- moe_apply alone -----------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, dtype, tol):
    """The block's output and its Switch aux loss, on the same x (in the
    compute type, as the layer hands it over) and weights; the MoE module
    with those weights gives the apply function's bits."""
    ref_cfg, cfg = _configs(arch, dtype)
    params, tparams = _moe_params(ref_cfg, 3)
    x = _x(4, cfg.d_model)
    want, want_aux = ref_moe.moe_apply(
        params, jnp.asarray(x).astype(dtype), ref_cfg, jnp.dtype(dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got, aux = moe.moe_apply(tparams, xt, cfg, getattr(torch, dtype))
    assert got.dtype == xt.dtype and got.shape == xt.shape
    _close(got, want, tol)
    assert abs(float(aux) - float(want_aux)) < 1e-5
    module = moe.MoE(cfg, device="cpu")
    tfm.load_tree(module, tparams)
    with torch.no_grad():
        got_m, aux_m = module(xt, getattr(torch, dtype))
    assert torch.equal(got_m, got) and torch.equal(aux_m, aux)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_match_reference(arch):
    """capacity_factor 0.3: an expert takes max(ceil(T k / E 0.3), 4) rows
    of the call's T k assignments, so most are dropped; the kept ones are
    each expert's first cap in token order (the stable sort), and the
    output with the dropped ones left out is the reference's."""
    ref_cfg, cfg = _configs(arch, capacity_factor=0.3)
    params, tparams = _moe_params(ref_cfg, 5)
    x = _x(6, cfg.d_model, b=2, s=16)
    t, k, n_e = 32, cfg.moe.top_k, cfg.moe.n_experts
    cap = moe.capacity(cfg, t)
    assert cap == max(int(np.ceil(t * k / n_e * 0.3)), 4) == 4
    want, want_aux = ref_moe.moe_apply(params, jnp.asarray(x), ref_cfg,
                                       jnp.float32)
    got, aux = moe.moe_apply(tparams, torch.from_numpy(x), cfg,
                             torch.float32)
    _close(got, want, 1e-5)
    assert abs(float(aux) - float(want_aux)) < 1e-5
    # the kept assignments: each expert's first cap, in token order
    _, _, top_ids = moe._route(torch.from_numpy(x).reshape(t, -1),
                               tparams["router"], cfg, n_e)
    flat_e = top_ids.reshape(-1)
    kept, slot = moe._slots(flat_e, cap, n_e, 0)
    seen = np.zeros(n_e, int)
    for i, e_ in enumerate(flat_e.tolist()):
        assert bool(kept[i]) == (seen[e_] < cap)
        if kept[i]:
            assert int(slot[i]) == e_ * cap + seen[e_]
        else:
            assert int(slot[i]) == n_e * cap
        seen[e_] += 1
    assert 0 < int(kept.sum()) < t * k
    # the same x at the config's own capacity_factor drops less
    assert not torch.equal(got, moe.moe_apply(
        tparams, torch.from_numpy(x), _configs(arch)[1], torch.float32)[0])


def test_init_matches_reference_shapes_and_distributions():
    """moe_init's tree: the reference's paths, shapes and axes, fp32 even
    where param_dtype says bf16; the router and the gate and up stacks at
    1 / sqrt(d), the down stack at 1 / sqrt(ff)."""
    for arch in ARCHS:
        ref_cfg = ref_smoke(arch)
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  param_dtype="bfloat16")
        ref_vals, ref_axes = ref_split_tree(
            ref_moe.moe_init(jax.random.PRNGKey(0), ref_cfg))
        vals, axes = split_tree(moe.moe_init(
            torch.Generator().manual_seed(0), cfg))
        assert jax.tree.map(lambda t: tuple(t.shape), vals) == \
            jax.tree.map(lambda a: a.shape, ref_vals)
        assert axes == ref_axes
        assert all(t.dtype == torch.float32
                   for t in jax.tree.leaves(vals))
        assert moe.padded_experts(cfg) == cfg.moe.n_experts
    big = dataclasses.replace(get_smoke_config(ARCHS[0]), d_model=256,
                              moe=dataclasses.replace(
                                  get_smoke_config(ARCHS[0]).moe,
                                  d_ff_expert=512))
    vals, _ = split_tree(moe.moe_init(torch.Generator().manual_seed(1), big))
    for name, fan_in in (("w_gate", 256), ("w_up", 256), ("w_down", 512)):
        assert abs(float(vals[name].std()) * fan_in ** 0.5 - 1) < 0.05
    module = moe.MoE(big, device="cpu")
    names = [n for n, _ in module.named_parameters()]
    assert sorted(names) == sorted(
        ["w_gate", "w_up", "w_down", "router.w", "shared.gate.w",
         "shared.up.w", "shared.down.w", "shared.sgate.w"])
    assert module["w_gate"] is module.w_gate


# -- the model, with the reference's weights -----------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(reference model, its params, port model with those weights), fp32."""
    ref_cfg, cfg = _configs(request.param)
    ref = ref_build_model(ref_cfg)
    params, _ = ref_split_tree(ref.init(jax.random.PRNGKey(0)))
    model = build_model(cfg, device="cpu")
    load_reference_params(model, jax.tree.map(np.asarray, params))
    return ref, params, model


def _tokens(seed, *shape):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


def test_weights_carry_across(pair):
    """Every leaf by its tree path; the port's count is param_count() and,
    with shared experts, each layer's d x 1 sigmoid gate, which the
    analytic count omits."""
    ref, params, model = pair
    cfg = model.cfg
    n = sum(p.numel() for p in model.net.parameters())
    sgate = cfg.n_layers * cfg.d_model if cfg.moe.n_shared else 0
    assert n == cfg.param_count() + sgate
    w = model.net["layers"][1]["moe"]["w_down"]
    np.testing.assert_array_equal(
        w.detach().numpy(), np.asarray(params["layers"]["moe"]["w_down"][1]))


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_forward_and_loss_match_reference(pair, impl):
    """Logits, and the loss ce + router_aux_weight x aux with aux summed over
    the layers in metrics["aux"]."""
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
    assert abs(float(metrics["aux"]) - float(ref_metrics["aux"])) < 1e-5
    assert float(metrics["aux"]) > 0
    assert abs(float(metrics["ce"]) - float(ref_metrics["ce"])) < 1e-4
    assert abs(float(loss) - float(want)) < 1e-4
    assert abs(float(loss) - float(metrics["ce"]) - model.cfg.moe
               .router_aux_weight * float(metrics["aux"])) < 1e-6


def test_prefill_and_decode_match_reference(pair):
    ref, params, model = pair
    toks = _tokens(12, 2, 24)
    s = 20
    want, st = ref.prefill(params, {"tokens": jnp.asarray(toks[:, :s])},
                           budget=24)
    got, tst = model.prefill({"tokens": torch.from_numpy(toks[:, :s])},
                             budget=24)
    _close(got, want, MODEL_TOL)
    for t in range(s, 24):
        step = toks[:, t:t + 1]
        want, st = ref.decode_step(params, st, jnp.asarray(step))
        got, tst = model.decode_step(tst, torch.from_numpy(step))
        _close(got, want, MODEL_TOL)
    np.testing.assert_array_equal(tst.pos.numpy(), np.asarray(st.pos))


def test_prefill_chunk_and_decode_paged_match_reference(pair):
    """Two slots prefilled in chunks of 8 over blocks of 4 (prompts of 19
    and 10), then 3 paged decode steps at different positions.  Capacity
    counts a chunk's pad rows, as the reference's does."""
    ref, params, model = pair
    cfg = model.cfg
    ref_cfg = dataclasses.replace(ref_smoke(cfg.name.removesuffix("-smoke")),
                                  dtype="float32")
    prompts = [_tokens(13, 19), _tokens(14, 10)]
    tables = np.array([[1, 2, 3, 4, 5, 6, 7], [8, 9, 10, 11, -1, -1, -1]],
                      np.int32)
    ref_paged = ref_tfm.init_paged_state(ref_cfg, 12, 4)
    paged = tfm.init_paged_state(cfg, 12, 4, device="cpu")
    width = 8
    for slot, prompt in enumerate(prompts):
        table = tables[slot:slot + 1]
        for start in range(0, len(prompt), width):
            real = prompt[start:start + width]
            chunk = np.zeros((1, width), np.int32)
            chunk[0, :len(real)] = real
            want, ref_paged = ref.prefill_chunk(
                params, ref_paged, jnp.asarray(chunk), jnp.asarray(table),
                jnp.int32(start), jnp.int32(len(real)))
            got, paged = model.prefill_chunk(
                paged, torch.from_numpy(chunk), torch.from_numpy(table),
                start, len(real))
            _close(got, want, MODEL_TOL)
    np.testing.assert_array_equal(paged.pos.numpy(), np.asarray(ref_paged.pos))
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


def test_bf16_forward_matches_reference():
    """qwen2-moe's smoke model in its own bf16 at the dense model's 3e-2
    (no routing flip at these inputs)."""
    ref = ref_build_model(ref_smoke(ARCHS[0]))
    params, _ = ref_split_tree(ref.init(jax.random.PRNGKey(2)))
    model = build_model(get_smoke_config(ARCHS[0]), device="cpu")
    load_reference_params(model, jax.tree.map(np.asarray, params))
    toks = _tokens(15, 2, 20)
    with torch.no_grad():
        got = model.forward({"tokens": torch.from_numpy(toks)})
    _close(got, ref.forward(params, {"tokens": jnp.asarray(toks)}), 3e-2)


def test_cpu_model_launches_nothing_and_builds_nothing(pair):
    _, _, model = pair
    before = matmul.BATCHED_LAUNCHES
    with torch.no_grad():
        model.forward({"tokens": torch.from_numpy(_tokens(16, 1, 12))})
    assert matmul.BATCHED_LAUNCHES == before
    assert _build._libs == {}


def test_continuous_greedy_matches_reference():
    """Greedy tokens of the port's ContinuousScheduler (batch 2, and each
    request alone) on qwen2-moe's smoke model in fp32: the reference
    scheduler's, token for token."""
    ref_cfg, cfg = _configs(ARCHS[0])
    ref = ref_build_model(ref_cfg)
    params, _ = ref_split_tree(ref.init(jax.random.PRNGKey(1)))
    model = build_model(cfg, device="cpu")
    load_reference_params(model, jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(0)
    lens, new = (12, 7, 9), (3, 4, 3)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in lens]

    def reqs(cls):
        return [cls(uid=i, prompt=p, max_new=m)
                for i, (p, m) in enumerate(zip(prompts, new))]
    want = RefContinuous(ref_cfg, params, batch=2, max_seq=64,
                         block_len=8).run(reqs(RefRequest))
    sched = ContinuousScheduler(model, batch=2, max_seq=64, block_len=8)
    assert sched.run(reqs(Request)) == want
    assert sched.cache.used_blocks == 0
    solo = {}
    for r in reqs(Request):
        solo.update(ContinuousScheduler(model, batch=2, max_seq=64,
                                        block_len=8).run([r]))
    assert solo == want


# -- the batched launch: wrapper, plain version, padding -----------------------

SPEC = PipelineSpec(Strategy.TMA, 2)


@pytest.mark.parametrize("dtype,e,m,k,n,why", [
    (torch.float32, 4, 128, 128, 128, "built for bfloat16"),
    (torch.float16, 4, 128, 128, 128, "built for bfloat16"),
    (torch.bfloat16, 4, 64, 128, 128, "multiples of 128"),
    (torch.bfloat16, 4, 200, 128, 128, "multiples of 128"),
    (torch.bfloat16, 4, 128, 96, 128, "multiples of 128"),
    (torch.bfloat16, 4, 128, 128, 100, "multiples of 128"),
    (torch.bfloat16, 0, 128, 128, 128, "multiples of 128"),
    (torch.bfloat16, 65536, 128, 128, 128, "65535"),
    (torch.bfloat16, 60000, 128 * 300, 128, 128, "2\\^31")])
def test_batched_card_config_refusals(dtype, e, m, k, n, why):
    """What the batched launch is not built for raises ValueError, on any
    device (the check takes no tensor)."""
    with pytest.raises(ValueError, match=why):
        matmul.check_batched_card_config(dtype, SPEC, e, m, k, n)


@pytest.mark.parametrize("strategy", list(Strategy))
def test_batched_card_config_takes_the_model_shapes(strategy):
    """qwen2-moe-a2.7b's expert products at decode (128 rows) and prefill
    (256) take every strategy's seed ring; a ring of 8 slots (where the
    strategy keeps a ring) is past shared memory, the 2-D kernel's
    refusal."""
    for m, k, n in ((128, 2048, 1408), (256, 2048, 1408), (256, 1408, 2048)):
        matmul.check_batched_card_config(torch.bfloat16,
                                         PipelineSpec(strategy), 60, m, k, n)
    if strategy in (Strategy.OVERLAP, Strategy.DROP_OFF, Strategy.TMA):
        with pytest.raises(ValueError, match="shared memory"):
            matmul.check_batched_card_config(
                torch.bfloat16, PipelineSpec(strategy, 8), 60, 128, 128, 128)


def test_batched_wrapper_refuses_bad_operands():
    with pytest.raises(ValueError, match="batched"):
        matmul.matmul_batched_cuda(torch.zeros(128, 128), torch.zeros(128, 128))
    with pytest.raises(ValueError, match="batched"):
        matmul.matmul_batched_cuda(torch.zeros(2, 128, 128),
                                   torch.zeros(3, 128, 128))
    with pytest.raises(ValueError, match="batched"):
        matmul.matmul_batched_cuda(torch.zeros(2, 128, 128),
                                   torch.zeros(2, 256, 128))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,m,k,n", [(1, 128, 128, 128), (3, 128, 384, 256),
                                     (5, 256, 256, 128)])
def test_batched_plain_matches_einsum(dtype, e, m, k, n):
    """The plain version: f32 sums over K tiles of 128 of each product
    (bf16 operands: exact products in f32), ``matmul_plain`` product by
    product; on CPU tensors the wrapper is it, with no launch or build."""
    g = torch.Generator().manual_seed(e + m + k + n)
    a = torch.randn(e, m, k, generator=g).to(dtype)
    b = torch.randn(e, k, n, generator=g).to(dtype)
    got = matmul.matmul_batched_plain(a, b)
    assert got.dtype == torch.float32 and got.shape == (e, m, n)
    torch.testing.assert_close(
        got, torch.einsum("emk,ekn->emn", a.float(), b.float()),
        rtol=1e-5, atol=1e-4)
    for i in range(e):
        assert torch.equal(got[i], matmul.matmul_plain(a[i], b[i]))
    before = matmul.BATCHED_LAUNCHES
    assert torch.equal(matmul.matmul_batched_cuda(a, b, spec=SPEC), got)
    assert matmul.BATCHED_LAUNCHES == before and _build._libs == {}


def test_batched_launch_counts_one(monkeypatch):
    """matmul_batched_cuda hands the C launcher (E, M, K, N) and the
    spec's ring, and adds one to BATCHED_LAUNCHES once it returns success;
    LAUNCHES (the 2-D kernel's) does not move.  A stand-in library takes
    the launch."""
    calls = []

    class Lib:
        def matmul_batched_launch(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(matmul, "BATCHED_LAUNCHES", 0)
    monkeypatch.setattr(matmul, "LAUNCHES", {"float32": 0, "bfloat16": 0})
    monkeypatch.setattr(matmul, "_check_batched", lambda *args: True)
    monkeypatch.setattr(_build, "library", lambda name: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    out = matmul.matmul_batched_cuda(
        torch.zeros(3, 256, 128, dtype=torch.bfloat16),
        torch.zeros(3, 128, 384, dtype=torch.bfloat16), spec=SPEC)
    assert out.shape == (3, 256, 384) and out.dtype == torch.float32
    (args,) = calls
    assert args[1:4] == (4, 1, 2)           # TMA, ahead 1, depth 2
    assert args[7:11] == (3, 256, 128, 384)
    # the budget of 256-row tiles: two 48 KB slots and two mbarriers each
    assert args[11] == matmul.batched_smem(SPEC, 256) == \
        matmul.RING_ALIGN + 2 * 49152 + 2 * 16
    assert matmul.BATCHED_LAUNCHES == 1
    assert matmul.LAUNCHES == {"float32": 0, "bfloat16": 0}


@pytest.mark.parametrize("m,rows", [(128, 128), (256, 256), (384, 128),
                                    (512, 256), (2048, 256), (640, 128)])
@pytest.mark.parametrize("strategy", list(Strategy))
def test_batched_tile_by_m(strategy, m, rows):
    """256-row tiles where M divides by 256 (qwen2-moe's prefill, xlstm's
    headwise products), 128 otherwise (a decode step), 128 columns wide
    but under TMA at 128 rows, where a tile is 256 columns (one strip a
    consumer warpgroup); the slot is A's tile rows of 128 bytes and B's 64
    K rows of the tile's columns."""
    cols = 256 if strategy is Strategy.TMA and rows == 128 else 128
    assert matmul.batched_tile_rows(m) == rows
    assert matmul.batched_tile_cols(m, strategy) == cols
    assert matmul.batched_tiles(m, strategy) == (rows * 128, 64 * 2 * cols)


@pytest.mark.parametrize("m", [128, 256])
@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("strategy", list(Strategy))
def test_batched_smem_is_the_kernel_layout(strategy, depth, m):
    """batched_smem is MatmulBf16BatchedLaunch's need at the tile of M:
    1024 bytes for the ring base's rounding, the ring's slots (SYNC and
    REGISTER_BYPASS one) of 48 KB (32 KB at 128 x 128), and under TMA a
    full and an empty mbarrier a slot; every depth 1-4 fits a block at
    both heights."""
    spec = PipelineSpec(strategy, depth)
    slot = sum(matmul.batched_tiles(m, strategy))
    assert slot == (32768 if m == 128 and strategy is not Strategy.TMA
                    else 49152)
    slots = 1 if strategy in (Strategy.SYNC, Strategy.REGISTER_BYPASS) \
        else max(depth, 2)
    bars = 16 * slots if strategy is Strategy.TMA else 0
    assert matmul.batched_smem(spec, m) == 1024 + slots * slot + bars
    matmul.check_batched_card_config(torch.bfloat16, spec, 60, m, 2048, 1408)


@pytest.mark.parametrize("strategy", list(Strategy))
def test_batched_ring_of_5_refused_at_48_kb_slots(strategy):
    """Five 48 KB slots (240 KB) are past a block's 227 KB: a ring
    strategy at depth 5 raises ValueError at 256-row tiles, and TMA at
    128 rows too (its 128 x 256 tiles' slots are 48 KB); the other ring
    strategies pass at 128 rows (five 32 KB slots); SYNC and
    REGISTER_BYPASS keep one slot."""
    spec = PipelineSpec(strategy, 5)
    for m in (128, 256):
        refused = strategy in (Strategy.OVERLAP, Strategy.DROP_OFF) and \
            m == 256 or strategy is Strategy.TMA
        if not refused:
            matmul.check_batched_card_config(torch.bfloat16, spec, 60, m,
                                             2048, 1408)
            continue
        with pytest.raises(ValueError, match="tiles needs .* shared"):
            matmul.check_batched_card_config(torch.bfloat16, spec, 60, m,
                                             2048, 1408)


def test_batched_launch_signature_unchanged():
    """The C launcher keeps its arguments (device, strategy, ahead, depth,
    a, b, c, E, M, K, N, smem, stream), so that bench.ab times a checkout
    from before the redesign through the same call."""
    p, i = _build.ctypes.c_void_p, _build.ctypes.c_int
    assert _build.SIGNATURES["matmul"]["matmul_batched_launch"] == \
        [i, i, i, i, p, p, p, i, i, i, i, i, p]


@pytest.mark.parametrize("e,c,k,n", [(6, 1, 48, 32), (6, 4, 32, 48),
                                     (60, 171, 256, 128), (2, 130, 140, 200)])
def test_batched_kernel_product_padding_equals_unpadded(e, c, k, n):
    """Each product's rows padded to the 128-row tile, K and N to
    multiples of 128, with zeros, sliced back: the unpadded products, to
    f32 rounding; bf16 operands give exact products summed in f32."""
    g = torch.Generator().manual_seed(e + c + k + n)
    a = torch.randn(e, c, k, generator=g).bfloat16()
    w = torch.randn(e, k, n, generator=g).bfloat16()
    got = layers.batched_kernel_product(a, w)
    assert got.shape == (e, c, n) and got.dtype == torch.float32
    torch.testing.assert_close(
        got, torch.einsum("eck,ekn->ecn", a.float(), w.float()),
        rtol=1e-5, atol=1e-4)
    # the CPU route of the model: bmm in the compute type
    assert torch.equal(layers.expert_product(a, w), torch.bmm(a, w))
    assert layers.expert_product(a.float(), w, torch.float32).dtype == \
        torch.float32
