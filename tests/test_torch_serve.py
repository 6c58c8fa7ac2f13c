"""The port's serving path on CPU tensors against the reference's
(``repro.serve``, ``repro.launch.serve``, ``repro.bench.serving``), at the
reference test's config (tests/test_serve.py: 2 layers, d_model 32, 4 q
heads over 2 kv heads, d_ff 64, vocab 128) in float32, with the
reference's weights carried across by ``load_reference_params``.

What is held: the arrival traces and block hashes equal the reference's;
one scripted allocator sequence leaves both packages' PagedKVCache in the
same state; greedy tokens equal the reference scheduler's, token for
token, for the continuous scheduler at batch 2, alone, reversed and at
batch 3, chunked with and without the prefix cache, and cohort at equal
lengths; temperature > 0 does not depend on scheduling (within the port:
its per-request torch.Generator draws are not the reference's);
ServingLoop's fallbacks; the nine serve/* cells; and the serving rows of
``run_serve_scenario`` through ``obs.compare``.  Step 0's products: on the
CPU ``linear`` and ``unembed`` are ``torch.matmul`` and the kernel's
padding helper equals the unpadded product.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.bench import scenario as ref_scenario
from repro.core.config import ArchConfig as RefArchConfig
from repro.core.config import AttnConfig as RefAttnConfig
from repro.distributed.sharding import split_tree as ref_split_tree
from repro.models import build_model as ref_build_model
from repro.serve import CohortScheduler as RefCohort
from repro.serve import ContinuousScheduler as RefContinuous
from repro.serve import PagedKVCache as RefCache
from repro.serve import Request as RefRequest
from repro.serve import block_hashes as ref_block_hashes
from repro.serve import make_trace as ref_make_trace
from repro_torch.bench import runner, scenario
from repro_torch.bench.results import BenchReport
from repro_torch.bench.serving import run_serve_scenario
from repro_torch.configs import get_smoke_config
from repro_torch.core.config import ArchConfig, AttnConfig
from repro_torch.launch.serve import ServingLoop
from repro_torch.models import build_model
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import load_reference_params
from repro_torch.obs.compare import compare_reports
from repro_torch.serve import (ARRIVALS, CohortScheduler,
                               ContinuousScheduler, PagedKVCache, Request,
                               block_hashes, make_trace, next_pow2)

#: the serve/* cells' deterministic counts on any device and weights
#: (experiments/baselines/BENCH_serve.json: "tokens", "cache_hit_ratio"):
#: tokens are the trace's max_new (no EOS), the hit ratio its scheduling
UNIFORM_TOKENS = 35
PREFIX_TOKENS = 269
PREFIX_HIT_RATIO = 0.6100


def _cfg_kwargs(vocab=128):
    return dict(name="sv", family="dense", n_layers=2, d_model=32,
                n_heads=4, n_kv_heads=2, d_ff=64, vocab=vocab,
                dtype="float32")


@pytest.fixture(scope="module")
def served():
    """(reference cfg, reference params, port model with those weights)."""
    ref_cfg = RefArchConfig(**_cfg_kwargs(), attn=RefAttnConfig(chunk=16))
    ref_model = ref_build_model(ref_cfg)
    params, _ = ref_split_tree(ref_model.init(jax.random.PRNGKey(1)))
    cfg = ArchConfig(**_cfg_kwargs(), attn=AttnConfig(chunk=16))
    model = build_model(cfg, device="cpu")
    load_reference_params(model, jax.tree.map(np.asarray, params))
    return ref_cfg, params, model


def _reqs(cls, vocab, lens, max_new, seed=0, arrivals=None):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(0, vocab,
                                           (int(n),)).astype(np.int32),
                max_new=int(m),
                arrival=0.0 if arrivals is None else float(arrivals[i]))
            for i, (n, m) in enumerate(zip(lens, max_new))]


# -- traces and hashes -------------------------------------------------------

TRACE_CASES = [(kind, rate, dict()) for kind in ARRIVALS
               for rate in (0.0, 0.5)] + [
    ("bursty", 0.25, dict(burst=3)),
    ("poisson", 0.25, dict(prefix_len=20, prefix_group=3)),
    ("uniform", 1.0, dict(prefix_len=8))]


@pytest.mark.parametrize("kind,rate,extra", TRACE_CASES,
                         ids=[f"{k}-{r}-{sorted(e)}" for k, r, e in
                              TRACE_CASES])
def test_make_trace_matches_reference(kind, rate, extra):
    kw = dict(vocab=97, rate=rate, seed=3, prompt_lens=(4, 30),
              max_new=(2, 9), **extra)
    got, want = make_trace(kind, 11, **kw), ref_make_trace(kind, 11, **kw)
    assert [(r.uid, r.max_new, r.arrival) for r in got] == \
        [(r.uid, r.max_new, r.arrival) for r in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.prompt, w.prompt)
        assert g.prompt.dtype == w.prompt.dtype


def test_make_trace_rejects_what_the_reference_rejects():
    for kw in (dict(kind="steady"), dict(rate=-1.0),
               dict(kind="bursty", burst=0)):
        kind = kw.pop("kind", "poisson")
        for fn in (make_trace, ref_make_trace):
            with pytest.raises(ValueError):
                fn(kind, 3, vocab=10, **kw)


def test_block_hashes_match_reference():
    toks = np.random.default_rng(4).integers(0, 1000, 100).astype(np.int32)
    for n, bl in ((0, 8), (3, 8), (12, 8), (6, 16)):
        assert block_hashes(toks, n, bl) == ref_block_hashes(toks, n, bl)
    with pytest.raises(ValueError):
        block_hashes(toks, 7, 16)
    assert [next_pow2(n) for n in (0, 1, 2, 3, 17, 64)] == \
        [1, 1, 2, 4, 32, 64]


# -- the allocator -----------------------------------------------------------

def _alloc_state(c):
    return dict(tables=c.tables.tolist(), ref=c._ref.tolist(),
                free=c.free_blocks, evictable=c.evictable_blocks,
                reserved=c.reserved_blocks, used=c.used_blocks,
                hit=c.hit_tokens, miss=c.miss_tokens,
                pos=np.asarray(c.state.pos).tolist())


def _script(cache, req_cls):
    """One sequence of every lifecycle call; the state after each."""
    rng = np.random.default_rng(7)
    head = rng.integers(0, 128, 24).astype(np.int32)
    a = np.concatenate([head, rng.integers(0, 128, 5).astype(np.int32)])
    b = np.concatenate([head, rng.integers(0, 128, 9).astype(np.int32)])
    states = []

    def note(out=None):
        states.append((out, _alloc_state(cache)))

    note(cache.admit(0, 16, 24))
    note(cache.append(0, 16))
    note(cache.append(0, 17))
    note(cache.free_slot(0))
    note(cache.admit_shared(0, a, len(a) + 4, max_match_rows=24,
                            granule_rows=8))
    cache.extend_to(0, len(a))
    note(cache.register_prefix(0, a, 24))
    note(cache.admit_shared(1, b, len(b) + 4, max_match_rows=32,
                            granule_rows=8))
    note(cache.extend_match(1, b, max_match_rows=32, granule_rows=8))
    note(cache.fork_slot(0, 2, len(a), len(a) + 6))
    note(cache.append(2, len(a)))               # copy-on-write
    note(cache.free_slot(0))
    note(cache.free_slot(1))
    note(cache.free_slot(2))
    note(cache.match_prefix(b, 32))
    note(cache.admit(1, 40, 48))                # evicts retained blocks
    note(cache.free_slot(1))
    note(cache.reset_prefix_cache())
    return states


def test_allocator_script_matches_reference(served):
    ref_cfg, _, model = served
    kw = dict(batch=3, total_tokens=80, max_seq=48, block_len=8,
              prefix_cache=True)
    got = _script(PagedKVCache(model.cfg, device="cpu", **kw), Request)
    want = _script(RefCache(ref_cfg, **kw), RefRequest)
    assert len(got) == len(want)
    for i, ((go, gs), (wo, ws)) in enumerate(zip(got, want)):
        assert go == wo, (i, go, wo)
        assert gs == ws, i


def test_allocator_guards_match_reference(served):
    ref_cfg, _, model = served
    for make in (lambda: PagedKVCache(model.cfg, 2, total_tokens=32,
                                      max_seq=32, block_len=8,
                                      device="cpu"),
                 lambda: RefCache(ref_cfg, 2, total_tokens=32, max_seq=32,
                                  block_len=8)):
        c = make()
        c.admit(0, 8, 16)
        with pytest.raises(RuntimeError):
            c.admit(0, 8, 8)                    # already admitted
        with pytest.raises(RuntimeError):
            c.append(0, 24)                     # non-contiguous
        assert not c.can_admit(33)
        c.free_slot(0)
        assert c.used_blocks == 0 and c.free_blocks == c.n_blocks - 1


# -- greedy tokens against the reference scheduler ---------------------------

LENS, NEW = (12, 7, 9), (3, 4, 3)


@pytest.fixture(scope="module")
def ref_greedy(served):
    ref_cfg, params, _ = served
    return RefContinuous(ref_cfg, params, batch=2, max_seq=64,
                         block_len=8).run(
        _reqs(RefRequest, 128, LENS, NEW))


def _continuous(model, batch, **kw):
    return ContinuousScheduler(model, batch=batch, max_seq=64, block_len=8,
                               **kw)


@pytest.mark.parametrize("case", ["batch2", "solo", "reversed", "batch3"])
def test_continuous_greedy_matches_reference(served, ref_greedy, case):
    _, _, model = served
    reqs = _reqs(Request, 128, LENS, NEW)
    if case == "solo":
        got = {}
        for r in reqs:
            got.update(_continuous(model, 1).run([r]))
    else:
        sched = _continuous(model, 3 if case == "batch3" else 2)
        got = sched.run(reqs[::-1] if case == "reversed" else reqs)
        assert sched.cache.used_blocks == 0
    assert got == ref_greedy


@pytest.mark.parametrize("prefix", [False, True])
def test_chunked_greedy_matches_reference(served, prefix):
    """Chunks of 16 over blocks of 8; requests sharing a 24-token head."""
    ref_cfg, params, model = served
    rng = np.random.default_rng(12)
    head = rng.integers(0, 128, 24).astype(np.int32)

    def mk(cls, order):
        arr = {u: float(j) for j, u in enumerate(order)}
        out = []
        for u, tail in enumerate((5, 9, 3)):
            t = np.random.default_rng(30 + u).integers(0, 128, tail)
            out.append(cls(uid=u, prompt=np.concatenate(
                [head, t.astype(np.int32)]), max_new=3, arrival=arr[u]))
        return out

    kw = dict(max_seq=64, block_len=8, chunk_tokens=16, prefix_cache=prefix)
    ref_sched = RefContinuous(ref_cfg, params, batch=2, **kw)
    want = ref_sched.run(mk(RefRequest, [0, 1, 2]))
    hits = []
    for order in ([0, 1, 2], [2, 1, 0]):
        sched = ContinuousScheduler(model, batch=2, **kw)
        assert sched.run(mk(Request, order)) == want
        assert sched.cache.used_blocks == 0
        hits.append(sched.cache.hit_tokens)
    # the FIFO run shares exactly what the reference's shares
    assert hits[0] == ref_sched.cache.hit_tokens
    assert (hits[0] > 0) == prefix


def test_cohort_greedy_matches_reference_equal_lengths(served):
    ref_cfg, params, model = served
    want = RefCohort(ref_cfg, params, batch=2).run(
        _reqs(RefRequest, 128, (10, 10), (3, 3), seed=2))
    got = CohortScheduler(model, batch=2).run(
        _reqs(Request, 128, (10, 10), (3, 3), seed=2))
    assert got == want
    assert _continuous(model, 2).run(
        _reqs(Request, 128, (10, 10), (3, 3), seed=2)) == want


def test_cohort_ragged_runs_to_max_new(served):
    _, _, model = served
    out = CohortScheduler(model, batch=2).run(
        _reqs(Request, 128, (5, 11, 8), (2, 4, 3), seed=5,
              arrivals=(0, 0, 1)))
    assert {u: len(v) for u, v in out.items()} == {0: 2, 1: 4, 2: 3}


@pytest.mark.parametrize("chunk", [None, 16])
def test_sampling_is_scheduling_independent(served, chunk):
    """temperature > 0: each request draws from its own generator, seeded
    from (seed, uid), so batch width and order change no token."""
    _, _, model = served
    mk = lambda: _reqs(Request, 128, LENS, NEW, seed=9)
    a = _continuous(model, 2, seed=5, chunk_tokens=chunk).run(
        mk(), temperature=0.9)
    solo = {}
    for r in mk():
        solo.update(_continuous(model, 1, seed=5, chunk_tokens=chunk).run(
            [r], temperature=0.9))
    assert a == solo
    other = _continuous(model, 2, seed=6, chunk_tokens=chunk).run(
        mk(), temperature=0.9)
    assert other != a
    greedy = _continuous(model, 2).run(mk())
    assert greedy != a


# -- ServingLoop and scheduler validation -------------------------------------

def test_serving_loop_falls_back_to_cohort(served):
    """A model without a paged decode path runs the cohort scheduler, with
    chunked prefill and the prefix cache dropped."""
    _, _, model = served

    @dataclasses.dataclass(frozen=True)
    class NoPaged(type(model)):
        decode_paged = None

    flat = NoPaged(cfg=model.cfg, net=model.net, attention=model.attention)
    loop = ServingLoop(flat, batch=2, chunk_tokens=16, prefix_cache=True)
    assert loop.scheduler_kind == "cohort"
    assert loop.chunk_tokens is None and loop.prefix_cache is False
    out = loop.run(_reqs(Request, 128, (8, 8), (2, 2)))
    assert all(len(v) == 2 for v in out.values())
    with pytest.raises(ValueError):
        ContinuousScheduler(flat, batch=2)
    with pytest.raises(ValueError):
        ServingLoop(model, batch=2, scheduler="fifo")


def test_serving_loop_disables_chunking_for_patch_rows(served):
    _, _, model = served
    vlm = dataclasses.replace(
        model, cfg=dataclasses.replace(model.cfg, n_patches=4))
    loop = ServingLoop(vlm, batch=2, chunk_tokens=16, prefix_cache=True)
    assert loop.scheduler_kind == "continuous"
    assert loop.chunk_tokens is None and loop.prefix_cache is False
    with pytest.raises(ValueError):
        ContinuousScheduler(vlm, batch=2, chunk_tokens=16)
    loop = ServingLoop(model, batch=2, scheduler="cohort", chunk_tokens=16)
    assert loop.chunk_tokens is None
    for bad in (4, 12):
        with pytest.raises(ValueError):
            _continuous(model, 2, chunk_tokens=bad)
    assert _continuous(model, 2, prefix_cache=True).chunk_tokens == 8


# -- the serve/* cells --------------------------------------------------------

def test_serve_scenarios_match_reference_registry():
    want = {sc.name: sc for sc in ref_scenario.scenarios(tag="serve")}
    got = {sc.name: sc for sc in scenario.scenarios(tag="serve")}
    assert len(got) == 9 and set(got) == set(want)
    for name, sc in got.items():
        assert sc.is_serving and sc.kernel == scenario.SERVE_KERNEL
        assert sc.workload == want[name].workload
        assert sc.shape == want[name].shape and sc.tags == want[name].tags
        assert sc.section == "serve"
        with pytest.raises(TypeError):
            sc.make_args("cpu")
    with pytest.raises(ValueError):
        scenario.ServeScenario(name="x", kernel="stream")
    with pytest.raises(ValueError):
        runner.project_scenario(got["serve/uniform/cohort"], "H100-SXM")


@pytest.fixture(scope="module")
def serve_rows():
    opts = runner.RunOptions(device="cpu")
    return {name: runner.run_scenario(scenario.get_scenario(name), opts)
            for name in ("serve/uniform/continuous", "serve/prefix/shared")}


def test_run_serve_scenario_counts(serve_rows):
    uni = serve_rows["serve/uniform/continuous"]
    m = uni.metrics
    assert m["tokens"] == UNIFORM_TOKENS and m["requests"] == 6
    assert uni.strategy == "continuous" and uni.backend == "cpu"
    assert uni.config["attention"] == "flash" and uni.kind == "measured"
    assert m["us_median"] > 0 and len(m["times_us"]) > 0
    assert 0 < m["occupancy_mean"] <= 1 and m["tokens_per_s"] > 0
    assert "cache_hit_ratio" not in m
    shared = serve_rows["serve/prefix/shared"].metrics
    assert shared["tokens"] == PREFIX_TOKENS
    assert round(shared["cache_hit_ratio"], 4) == PREFIX_HIT_RATIO
    assert shared["outputs_equal"] is True
    assert shared["prefix_hit_tokens"] > 0


def test_sweep_measures_serving_cells_without_projection(serve_rows):
    sc = scenario.get_scenario("serve/uniform/cohort")
    rep = runner.sweep([sc], ["H100-SXM"], runner.RunOptions(device="cpu"))
    assert [r.kind for r in rep.results] == ["measured"]
    assert rep.results[0].metrics["tokens"] == UNIFORM_TOKENS


def test_compare_gates_a_port_serving_row(serve_rows):
    row = serve_rows["serve/prefix/shared"]
    base = BenchReport()
    base.add(row)
    res = compare_reports(base, base)
    assert res.n_regressions == 0
    assert {v.verdict for v in res.verdicts} == {"pass"}
    slow = dataclasses.replace(row, metrics=dict(
        row.metrics, tokens_per_s=row.metrics["tokens_per_s"] * 0.5,
        cache_hit_ratio=row.metrics["cache_hit_ratio"] - 0.2))
    new = BenchReport()
    new.add(slow)
    by = {v.scenario: v.verdict for v in compare_reports(base,
                                                         new).verdicts}
    assert by["serve/prefix/shared:tokens_per_s"] == "regress"
    assert by["serve/prefix/shared:cache_hit_ratio"] == "regress"


# -- Step 0: the products on the CPU ------------------------------------------

def test_linear_and_unembed_stay_torch_matmul_on_cpu():
    cfg = get_smoke_config("qwen2-1.5b")
    g = torch.Generator().manual_seed(0)
    model = build_model(cfg, device="cpu")
    model.init(g)
    x = torch.randn(3, 5, cfg.d_model, generator=g).bfloat16()
    p = model.net["layers"][0]["mlp"]["up"]
    assert torch.equal(layers.linear(p, x),
                       torch.matmul(x, p["w"].bfloat16()))
    wq = model.net["layers"][0]["attn"]["wq"]
    assert torch.equal(layers.linear(wq, x),
                       torch.matmul(x, wq["w"].bfloat16())
                       + wq["b"].bfloat16())
    got = tfm.unembed(model.net, x)
    xf = model.net["ln_f"](x).float()
    want = torch.matmul(xf, model.net["embed"]["emb"].float().t())
    want[..., cfg.vocab:] = -1e30
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,k,n", [(1, 48, 140), (4, 140, 48), (64, 48, 512),
                                   (130, 256, 128)])
def test_kernel_product_padding_equals_unpadded(m, k, n):
    """Rows padded to the 128-row tile, K and N to multiples of 128, with
    zeros, sliced back: the unpadded product, to f32 rounding (the plain
    version sums K in tiles of 128, ``torch.matmul`` in its own order:
    1.3e-5 at K = 256 on products of magnitude ~16)."""
    g = torch.Generator().manual_seed(m + k + n)
    a = torch.randn(m, k, generator=g)
    w = torch.nn.Parameter(torch.randn(k, n, generator=g))
    op = layers.kernel_operand(w, torch.float32)
    assert layers.kernel_operand(w, torch.float32) is op       # kept
    assert op.shape == (-(-k // 128) * 128, -(-n // 128) * 128)
    assert torch.equal(op[:k, :n], w.detach()) and not op[k:].any() \
        and not op[:, n:].any()
    got = layers.kernel_product(a, op)[:, :n]
    assert got.shape == (m, n) and got.dtype == torch.float32
    torch.testing.assert_close(got, a @ w.detach(), rtol=1e-5, atol=1e-4)
    # bf16 operands: exact products, f32 sums
    op16 = layers.kernel_operand(w, torch.bfloat16)
    got16 = layers.kernel_product(a.bfloat16(), op16)[:, :n]
    torch.testing.assert_close(
        got16, a.bfloat16().float() @ w.detach().bfloat16().float(),
        rtol=1e-5, atol=1e-4)
    # the transposed operand (tied unembedding) and its refresh on a write
    opt = layers.kernel_operand(w, torch.float32, transpose=True)
    assert torch.equal(opt[:n, :k], w.detach().t())
    with torch.no_grad():
        w.mul_(2)
    assert torch.equal(layers.kernel_operand(w, torch.float32)[:k, :n],
                       w.detach())
