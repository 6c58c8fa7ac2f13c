"""The port's LUD on CPU tensors (its plain torch versions) against the
reference's Pallas kernels in interpret mode and its jnp oracle, on the same
numpy inputs.

On a CUDA tensor the same wrappers launch csrc/lud.cu; those kernels are
held to the plain versions on the card by ``chip_smoke.py``."""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                         # noqa: E402

from repro.core import PipelineSpec as RefSpec                  # noqa: E402
from repro.core import Strategy as RefStrategy                  # noqa: E402
from repro.kernels import lud as ref_lud                        # noqa: E402
from repro.kernels import ops as ref_ops                        # noqa: E402
from repro.kernels import ref as ref_ref                        # noqa: E402
from repro.tuning import search_space as ref_space              # noqa: E402
from repro_torch.bench import runner, scenario                  # noqa: E402
from repro_torch.core.async_pipeline import (                   # noqa: E402
    SMEM_PER_BLOCK, PipelineSpec, Strategy)
from repro_torch.kernels import _build, lud, ops, ref           # noqa: E402
from repro_torch.tuning import search_space                     # noqa: E402

STRATEGIES = [s.value for s in RefStrategy]
#: the reference's LUD tolerance (tests/test_kernels.py::test_lud)
TOL = 2e-4


def _matrix(n, seed):
    """U[0, 1) + n I, the reference's LUD input (diagonally dominant)."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(n, n)) + n * np.eye(n)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32, order="C"))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("bs", [16, 32])
def test_diagonal_matches_pallas(bs):
    block = _matrix(bs, 1)
    want = ref_lud.lud_diagonal(jnp.asarray(block), interpret=True)
    got = lud.lud_diagonal_cuda(_t(block))
    _close(got, want)
    _close(lud.lud_diagonal_plain(_t(block)), want)


def _diag_and_strip(shape, seed):
    diag = np.asarray(ref_ref.lud_ref(jnp.asarray(_matrix(32, seed))))
    strip = np.random.default_rng(seed + 1).uniform(
        size=shape).astype(np.float32)
    return diag, strip


@pytest.mark.parametrize("w", [32, 128])
def test_perimeter_row_matches_pallas(w):
    diag, strip = _diag_and_strip((32, w), 2)
    want = ref_lud.lud_perimeter_row(jnp.asarray(diag), jnp.asarray(strip),
                                     interpret=True)
    _close(lud.lud_perimeter_row_cuda(_t(diag), _t(strip)), want)


@pytest.mark.parametrize("h", [32, 128])
def test_perimeter_col_matches_pallas(h):
    diag, strip = _diag_and_strip((h, 32), 3)
    want = ref_lud.lud_perimeter_col(jnp.asarray(diag), jnp.asarray(strip),
                                     interpret=True)
    _close(lud.lud_perimeter_col_cuda(_t(diag), _t(strip)), want)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_internal_matches_pallas(strategy):
    rng = np.random.default_rng(4)
    l = (rng.uniform(size=(128, 32)) / 128).astype(np.float32)
    u = rng.uniform(size=(32, 128)).astype(np.float32)
    c = rng.uniform(size=(128, 128)).astype(np.float32)
    want = ref_lud.lud_internal(jnp.asarray(l), jnp.asarray(u),
                                jnp.asarray(c), spec=RefSpec(strategy),
                                interpret=True)
    c_t = _t(c)
    got = lud.lud_internal_cuda(_t(l), _t(u), c_t,
                                spec=PipelineSpec(strategy))
    assert got is c_t                                   # updated in place
    _close(got, want)


def test_whole_lud_matches_pallas():
    a = _matrix(64, 5)
    want = ref_ops.lud(jnp.asarray(a), bs=32, strategy="overlap")
    got = ops.lud(_t(a), bs=32, strategy="overlap")
    _close(got, want)


@pytest.mark.parametrize("n", [64, 128, 192, 256])
def test_whole_lud_matches_oracle(n):
    """192 and 256 are sizes the reference's kernels refuse at bs=32 (their
    128-wide tiles must divide the trailing width); the port takes any
    n % bs == 0, held here to the reference's oracle."""
    a = _matrix(n, 6)
    got = ops.lud(_t(a), bs=32).numpy()
    _close(got, ref_ref.lud_ref(jnp.asarray(a)))
    lower = np.tril(got, -1) + np.eye(n)
    np.testing.assert_allclose(lower @ np.triu(got), a, rtol=TOL, atol=2e-3)


def test_lud_ref_matches_reference_oracle():
    a = _matrix(48, 7)
    _close(ref.lud_ref(_t(a)), ref_ref.lud_ref(jnp.asarray(a)), tol=1e-5)


@pytest.mark.parametrize("n,bs", [(96, 64), (64, 128), (64, 0)])
def test_bad_block_size_raises_value_error(n, bs):
    with pytest.raises(ValueError, match="not divisible"):
        ops.lud(_t(_matrix(n, 8)), bs=bs)


@pytest.mark.parametrize("call", [
    lambda: lud.lud_cuda(torch.zeros(64, 32)),
    lambda: lud.lud_cuda(torch.zeros(64, 64, device="meta")),
    lambda: lud.lud_internal_cuda(torch.zeros(64, 32), torch.zeros(16, 64),
                                  torch.zeros(64, 64)),
    lambda: lud.lud_perimeter_row_cuda(torch.zeros(16, 16),
                                       torch.zeros(32, 64))])
def test_invalid_calls_raise_value_error(call):
    with pytest.raises(ValueError):
        call()


def test_installed_bs_falls_back_to_seed():
    a = _t(_matrix(96, 9))
    try:
        ops.set_default_config("lud", bs=64)            # 96 % 64 != 0
        got = ops.lud(a)
    finally:
        ops.reset_default_configs()
    torch.testing.assert_close(got, lud.lud_plain(a, 32))
    with pytest.raises(ValueError):                     # explicit: no retry
        ops.lud(a, bs=64)


def test_cpu_calls_launch_nothing_and_build_nothing():
    for k in lud.LAUNCHES:
        lud.LAUNCHES[k] = 0
    ops.lud(_t(_matrix(64, 10)), bs=16)
    lud.lud_internal_cuda(torch.rand(8, 16), torch.rand(16, 8),
                          torch.rand(8, 8))
    assert set(lud.LAUNCHES.values()) == {0}
    assert _build._libs == {}


@pytest.mark.parametrize("name", ["smoke/lud", "fig4/lud/overlap"])
def test_lud_cells_check_ok_on_cpu(name):
    from repro.bench import scenario as ref_scenario
    sc = scenario.get_scenario(name)
    ref_sc = ref_scenario.get_scenario(name)
    assert (sc.kernel, sc.shape, sc.dtype, sc.workload) == \
        (ref_sc.kernel, ref_sc.shape, ref_sc.dtype, ref_sc.workload)
    row = runner.run_scenario(sc, runner.RunOptions(device="cpu", repeats=2,
                                                    warmup=0))
    assert row.metrics["check_ok"] is True
    assert row.metrics["max_err"] < 1e-6


def test_lud_error_sees_a_wrong_entry():
    a = _t(_matrix(64, 11))
    out = lud.lud_plain(a, 32)
    sc = scenario.get_scenario("smoke/lud")
    assert scenario.check_output(sc, (a,), out) < 1e-6
    out[40, 50] += 0.01 * out.abs().max()
    assert scenario.check_output(sc, (a,), out) > scenario.CHECK_TOL["lud"]


@pytest.mark.parametrize("fault", [
    lambda l, u, c: c.clone(),                  # the update never runs
    lambda l, u, c: c + l @ u,                  # C += L U, not C -= L U
], ids=["skipped", "sign"])
def test_lud_error_sees_a_wrong_internal_update(fault, monkeypatch):
    """At n=1024 the diagonal (~n) dwarfs every other entry; a wrong
    trailing update still reads far beyond the limit, and a sound LU far
    inside it."""
    n = 1024
    sc = scenario.Scenario(name="test/lud", kernel="lud", shape=(n,))
    (a,) = sc.make_args("cpu", seed=12)
    tol = scenario.CHECK_TOL["lud"]
    assert scenario.check_output(sc, (a,), lud.lud_plain(a, 32)) < tol / 10
    monkeypatch.setattr(lud, "lud_internal_plain", fault)
    assert scenario.check_output(sc, (a,), lud.lud_plain(a, 32)) > 100 * tol


def test_lud_spec_matches_reference():
    spec, want = search_space.SPECS["lud"], ref_space.SPECS["lud"]
    for n, bs in ((64, 32), (8192, 32), (256, 64)):
        cfg = dict(bs=bs)
        assert spec.flops_bytes((n,), "float32", cfg) == \
            pytest.approx(want.flops_bytes((n,), "float32", cfg))
        assert spec.n_tiles((n,), cfg) == want.n_tiles((n,), cfg)
    (a,) = spec.make_args((64,), "float32", torch.Generator().manual_seed(0),
                          "cpu")
    assert a.shape == (64, 64) and bool((a.diagonal() >= 64).all())
    assert float(a.max()) < 65 and float((a - 64 * torch.eye(64)).min()) >= 0


@pytest.mark.parametrize("bs", lud.CARD_BS)
def test_internal_smem_fits_every_checked_shape(bs):
    """Every (strategy, depth, out_depth) chip_smoke.py checks fits a block
    at the widest region (a kept side of PANEL - bs, tiles of TILE along
    the other, the resident operand beside them); the reference's 128 x
    128 tiles would not fit at depth 2."""
    for s in Strategy:
        for depth in (2, 3, 4):
            for od in (1, 2, 3, 4):
                smem = lud.internal_smem(PipelineSpec(s, depth, None, od), bs)
                assert 0 < smem <= SMEM_PER_BLOCK
    slot, out, l_tile = (32 + 128) * 128 * 4, 128 * 128 * 4, 128 * 32 * 4
    assert 2 * slot + 2 * out + l_tile > SMEM_PER_BLOCK


def test_build_registers_every_launcher():
    """Each library's SIGNATURES name exactly its source's extern "C"
    launchers, with one argtype per parameter."""
    assert set(_build.SIGNATURES) == set(_build.SOURCES)
    for name, fns in _build.SIGNATURES.items():
        text = (_build.CSRC / f"{name}.cu").read_text()
        found = {m.group(1): m.group(2) for m in re.finditer(
            r'extern "C" int (\w+)\(([^)]*)\)', text)}
        assert set(found) == set(fns), name
        for fn, params in found.items():
            assert len(params.split(",")) == len(fns[fn]), fn
    assert {"lud_launch", "lud_diagonal_launch", "lud_perimeter_row_launch",
            "lud_perimeter_col_launch", "lud_perimeters_launch",
            "lud_internal_launch", "lud_internal_pair_launch",
            "lud_internal_panel_launch"} == set(_build.SIGNATURES["lud"])


def _tma_internal(l, u, c):
    """lud_internal under TMA as csrc/lud.cu runs it, in numpy: a region
    whose width is at most PANEL - bs is tall (U resident, boxes of TILE
    rows of L and C), else wide (L resident, boxes of TILE columns of U and
    C); a box past the matrix's edge holds zeros (the TMA unit's fill); C -
    L U over the whole box; the store writes back only the box's part
    inside the matrix."""
    (h, bs), w, t = l.shape, u.shape[1], lud.TILE
    out = c.copy()
    if w <= lud.PANEL - bs:
        for row0 in range(0, h, t):
            rows = min(t, h - row0)
            lbox = np.zeros((t, bs), np.float32)
            lbox[:rows] = l[row0:row0 + rows]
            cbox = np.zeros((t, w), np.float32)
            cbox[:rows] = c[row0:row0 + rows]
            out[row0:row0 + rows] = (cbox - lbox @ u)[:rows]
    else:
        assert h <= lud.PANEL - bs
        for col0 in range(0, w, t):
            width = min(t, w - col0)
            ubox = np.zeros((bs, t), np.float32)
            ubox[:, :width] = u[:, col0:col0 + width]
            cbox = np.zeros((h, t), np.float32)
            cbox[:, :width] = c[:, col0:col0 + width]
            out[:, col0:col0 + width] = (cbox - l @ ubox)[:, :width]
    return out


@pytest.mark.parametrize("h,w,bs", [(64, 64, 16), (96, 160, 32),
                                    (32, 200, 32), (160, 36, 64),
                                    (8, 4, 16)])
def test_internal_tma_boxes_cover_ragged_tiles(h, w, bs):
    """Whole boxes with zeros past a ragged last tile, stored back on the
    tile's own rows and columns, give the plain update; the slot holds the
    full boxes, so the shared-memory layout is the same at every tile:
    ring, out ring and mbarriers (the ring's and the resident's), then at
    the next 128 bytes the resident (bs, PANEL - bs) or (PANEL - bs, bs)."""
    rng = np.random.default_rng(h + w + bs)
    l, u, c = (rng.uniform(size=s).astype(np.float32)
               for s in ((h, bs), (bs, w), (h, w)))
    want = lud.lud_internal_plain(_t(l), _t(u), _t(c)).numpy()
    np.testing.assert_allclose(_tma_internal(l, u, c), want, rtol=1e-5,
                               atol=1e-5)
    t, m = lud.TILE, lud.PANEL - bs
    for depth in (2, 3, 4):
        for od in (1, 2, 4):
            slot = t * bs * 4 + t * m * 4              # the boxes' bytes
            laid = depth * slot + od * t * m * 4 + 8 * depth + 8
            assert lud.internal_smem(PipelineSpec(Strategy.TMA, depth, None,
                                                  od), bs) == \
                (laid + 127) // 128 * 128 + bs * m * 4


# -- the panel schedule ----------------------------------------------------------

@pytest.mark.parametrize("n,bs", [(64, 32), (128, 32), (160, 32), (64, 16)])
def test_panel_schedule_matches_pallas(n, bs):
    """The panel schedule over the plain versions against the reference's
    rank-bs loop in interpret mode (n = 160: a full panel, its trailing
    update, and a ragged last panel of 32 columns)."""
    a = _matrix(n, 20 + n + bs)
    want = ref_lud.lud_pallas(jnp.asarray(a), bs=bs,
                              spec=RefSpec(RefStrategy.OVERLAP),
                              interpret=True)
    _close(lud.lud_plain(_t(a), bs), want)


@pytest.mark.parametrize("n,bs", [(n, bs) for n in (96, 192, 320, 384)
                                  for bs in (16, 32, 64) if n % bs == 0])
def test_panel_schedule_matches_oracle(n, bs):
    """Every n % PANEL case (96: one ragged panel; 192, 320: a ragged last
    one; 384: whole panels) at every card bs, against the reference's
    unblocked oracle, and L U against the input."""
    a = _matrix(n, 30 + n + bs)
    got = lud.lud_plain(_t(a), bs).numpy()
    _close(got, ref_ref.lud_ref(jnp.asarray(a)))
    lower = np.tril(got, -1) + np.eye(n)
    np.testing.assert_allclose(lower @ np.triu(got), a, rtol=TOL, atol=2e-3)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_internal_at_panel_width_matches_pallas(strategy):
    """The trailing update's shape, K = PANEL: the reference's lud_internal
    takes it as one 128-wide strip."""
    rng = np.random.default_rng(21)
    l = (rng.uniform(size=(256, lud.PANEL)) / 256).astype(np.float32)
    u = rng.uniform(size=(lud.PANEL, 256)).astype(np.float32)
    c = rng.uniform(size=(256, 256)).astype(np.float32)
    want = ref_lud.lud_internal(jnp.asarray(l), jnp.asarray(u),
                                jnp.asarray(c), spec=RefSpec(strategy),
                                interpret=True)
    c_t = _t(c)
    got = lud.lud_internal_cuda(_t(l), _t(u), c_t,
                                spec=PipelineSpec(strategy))
    assert got is c_t                                   # updated in place
    _close(got, want)


def _walked_launches(n, bs):
    """The launches of the panel schedule, counted by running lud_plain
    with every plain kernel counting its calls; a trailing update is an
    internal call at K = PANEL."""
    counts = dict.fromkeys(("diagonal", "row", "col", "internal", "panel",
                            "pair"), 0)
    plain = {name: getattr(lud, f"lud_{name}_plain")
             for name in ("diagonal", "perimeter_row", "perimeter_col",
                          "internal", "internal_pair")}

    def counting(key, fn):
        def call(*args):
            counts[key] += 1
            if key == "internal" and args[0].shape[1] == lud.PANEL:
                counts["panel"] += 1
            return fn(*args)
        return call

    mp = pytest.MonkeyPatch()
    for key, name in (("diagonal", "diagonal"), ("row", "perimeter_row"),
                      ("col", "perimeter_col"), ("internal", "internal"),
                      ("pair", "internal_pair")):
        mp.setattr(lud, f"lud_{name}_plain", counting(key, plain[name]))
    try:
        lud.lud_plain(_t(_matrix(n, 40)), bs)
    finally:
        mp.undo()
    return counts


@pytest.mark.parametrize("n,bs", [(16, 16), (64, 16), (128, 32), (160, 32),
                                  (256, 64), (320, 16), (448, 64),
                                  (416, 32)])
def test_lud_launches_counts_the_schedule(n, bs):
    """Each step's two perimeter solves are one launch (the last slot),
    none alone; each sub-step's two K = bs updates are one launch (a
    pair), of which the last panel's have no wide region."""
    counts = _walked_launches(n, bs)
    assert counts["row"] == counts["col"]
    assert lud.lud_launches(n, bs) == (
        counts["diagonal"], 0, 0, counts["pair"], counts["panel"],
        counts["row"])
    last = (n - (-(-n // lud.PANEL) - 1) * lud.PANEL) // bs
    assert counts["internal"] - counts["panel"] == \
        2 * counts["pair"] - (last - 1)
    assert len(lud.internal_substeps(n, bs)) == counts["pair"]
    assert len(lud.lud_launches(n, bs)) == len(lud.LAUNCHES)


def test_lud_launches_at_the_h100_cell():
    """h100/lud: 256 diagonal, 192 launches of both K = bs updates, 63
    trailing updates and 255 launches of both perimeter solves, 766
    launches a call."""
    assert lud.lud_launches(8192, 32) == (256, 0, 0, 192, 63, 255)
    assert sum(lud.lud_launches(8192, 32)) == 766


def test_panel_width_is_the_sources():
    """PANEL and PANEL_TILE are csrc/lud.cu's kPanel and LP_BM, LP_BN."""
    text = (_build.CSRC / "lud.cu").read_text()
    assert int(re.search(r"constexpr int kPanel = (\d+);", text).group(1)) \
        == lud.PANEL
    tiles = re.search(r"constexpr int LP_BM = (\d+), LP_BN = (\d+);", text)
    assert tuple(map(int, tiles.groups())) == (lud.PANEL_TILE,) * 2


@pytest.mark.parametrize("strategy", list(Strategy))
def test_panel_smem_matches_its_layout(strategy):
    """The panel body's budget, as csrc/lud.cu's lud_panel_smem lays it
    out: slices of 32 K rows (4 under DROP_OFF) of U (128 wide) and L (128
    tall), rows padded by 16 bytes except under TMA, whose ring starts on
    1024 bytes; every checked depth fits a block, TMA's ring holds the
    128 x 128 tile it stages for its reduction into C, and the budget does
    not depend on out_depth."""
    kc = 4 if strategy is Strategy.DROP_OFF else 32
    tma = strategy is Strategy.TMA
    for depth in (2, 3, 4):
        spec = PipelineSpec(strategy, depth)
        slot = kc * 512 + 128 * kc * 4 if tma else \
            kc * (512 + 16) + 128 * (kc * 4 + 16)
        ring = spec.ring_depth * slot
        want = 1024 + ring + 8 * spec.ring_depth if tma else ring
        for od in (1, 4):
            assert lud.internal_smem(PipelineSpec(strategy, depth, None, od),
                                     lud.PANEL) == want
        assert want <= SMEM_PER_BLOCK
        if tma:
            assert ring >= 128 * 128 * 4


@pytest.mark.parametrize("call", [
    lambda: lud.lud_internal_cuda(torch.zeros(64, 48), torch.zeros(32, 64),
                                  torch.zeros(64, 64)),
    lambda: lud.internal_smem(PipelineSpec(Strategy.OVERLAP, 7), lud.PANEL),
    lambda: lud.internal_smem(PipelineSpec(Strategy.OVERLAP), 96)])
def test_panel_misfits_raise_value_error(call):
    """Shapes that do not fit, a ring past a block's shared memory, and a K
    that is neither a card bs nor PANEL (no body of the card takes it)."""
    with pytest.raises(ValueError):
        call()


def test_panel_plain_leaves_the_trailing_matrix_to_its_update():
    """lud_panel_plain factors the first panel and touches nothing right of
    it below its rows; one trailing update then gives what lud_plain has
    after that panel, which is the whole LU when two panels remain none."""
    n, bs = 256, 32
    a = _t(_matrix(n, 23))
    x = a.clone()
    assert lud.lud_panel_plain(x, 0, bs) == lud.PANEL
    torch.testing.assert_close(x[lud.PANEL:, lud.PANEL:],
                               a[lud.PANEL:, lud.PANEL:], rtol=0, atol=0)
    p = lud.PANEL
    x[p:, p:] = lud.lud_internal_plain(x[p:, :p], x[:p, p:], x[p:, p:])
    assert lud.lud_panel_plain(x, p, bs) == n
    torch.testing.assert_close(x, lud.lud_plain(a, bs), rtol=0, atol=0)


# -- the perimeter solves ----------------------------------------------------------

def _perimeter_diag(bs, seed, dominant):
    """A factored (bs, bs) diagonal block: the Doolittle LU, in float64 and
    without pivoting, of U[0, 1) + bs I (diagonally dominant, as the LUD
    input) or of U[0, 1) + (bs / 4) I (not dominant: a row's other entries
    sum to about bs / 2), rounded to float32."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(bs, bs)) + (bs if dominant else bs / 4) * np.eye(bs)
    for k in range(bs - 1):
        a[k + 1:, k] /= a[k, k]
        a[k + 1:, k + 1:] -= np.outer(a[k + 1:, k], a[k, k + 1:])
    return a.astype(np.float32)


def _lud_constant(name):
    """A ``constexpr int`` of csrc/lud.cu."""
    text = (_build.CSRC / "lud.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


#: threads of a perimeter block, entries of a vector a lane holds
PERIM_THREADS = _lud_constant("kPerimThreads")
PERIM_ENTRIES = _lud_constant("kPerimEntries")


def _perimeter_replay(diag, vectors, unit):
    """csrc/lud.cu's perim_solve, lane by lane, in plain torch: each row of
    ``vectors`` (N, bs) is one vector over G = bs / 8 lanes of eight
    entries (kPerimEntries), each with a sum that starts at 0.  Step c:
    every lane forms its entry c % 8 less its sum (times the float32
    reciprocal of U_cc, or nothing at a unit diagonal), lane o = c // 8's
    goes to the group (the shuffle), and every lane adds it times its
    m[c, 8g:8g+8] to its eight sums as FFMAs (the product and sum in
    float64, then float32: one FMA rounding but for a rare double
    rounding).  m[c, j] is entry c's coefficient in entry j > c, zero
    elsewhere: U above its diagonal (column solve) or L^T above it (row
    solve, unit).  After the loop every entry is its input less its sum
    (times its reciprocal)."""
    e = PERIM_ENTRIES
    d = torch.from_numpy(diag)
    bs = d.shape[0]
    m = torch.triu(d.T if unit else d, 1).double().reshape(bs, bs // e, e)
    rcp = 1.0 / torch.diagonal(d)                        # float32, IEEE
    lanes = vectors.clone().reshape(-1, bs // e, e)
    sums = torch.zeros_like(lanes)
    for c in range(bs):
        o, i = divmod(c, e)
        v = lanes[:, o, i] - sums[:, o, i]
        if not unit:
            v = v * rcp[c]
        xc = v.double()[:, None, None]                   # __shfl_sync
        sums = (sums.double() + xc * m[c]).float()
    lanes = lanes - sums
    if not unit:
        lanes = lanes * rcp.reshape(bs // e, e)
    return lanes.reshape(-1, bs)


def _perimeter_errors(got, plain, exact):
    """max |got - exact| and max |plain - exact|, exact in float64."""
    return (float((got.double() - exact).abs().max()),
            float((plain.double() - exact).abs().max()))


@pytest.mark.parametrize("dominant", [True, False],
                         ids=["dominant", "not_dominant"])
@pytest.mark.parametrize("h", [8160, 97, 32])
@pytest.mark.parametrize("bs", lud.CARD_BS)
def test_perimeter_col_replay(bs, h, dominant):
    """The column solve as the kernel runs it, against the reference's
    Pallas kernel in interpret mode and a float64 solve; its error against
    float64 is at most 4x the plain substitution's (which divides).  h =
    8160 is the first step of n = 8192, 97 no multiple of a block's rows."""
    diag = _perimeter_diag(bs, 50 + bs + h, dominant)
    strip = np.random.default_rng(h + bs).uniform(
        size=(h, bs)).astype(np.float32)
    got = _perimeter_replay(diag, _t(strip), unit=False)
    want = ref_lud.lud_perimeter_col(jnp.asarray(diag), jnp.asarray(strip),
                                     bh=h, interpret=True)
    _close(got, want)
    exact = torch.linalg.solve_triangular(
        torch.from_numpy(np.triu(diag)).double(), _t(strip).double(),
        upper=True, left=False)
    err, plain_err = _perimeter_errors(
        got, lud.lud_perimeter_col_plain(_t(diag), _t(strip)), exact)
    print(f"col bs={bs} h={h} dominant={dominant}: replay {err:.3g}, plain "
          f"{plain_err:.3g} against float64")
    assert err <= 4 * plain_err


@pytest.mark.parametrize("dominant", [True, False],
                         ids=["dominant", "not_dominant"])
@pytest.mark.parametrize("w", [8160, 97, 32])
@pytest.mark.parametrize("bs", lud.CARD_BS)
def test_perimeter_row_replay(bs, w, dominant):
    """The row solve as the kernel runs it (a column of the strip is one
    vector, L^T its coefficients), against the reference's Pallas kernel
    in interpret mode and a float64 solve; its error against float64 is at
    most 4x the plain substitution's."""
    diag = _perimeter_diag(bs, 60 + bs + w, dominant)
    strip = np.random.default_rng(w + bs + 1).uniform(
        size=(bs, w)).astype(np.float32)
    got = _perimeter_replay(diag, _t(strip).T, unit=True).T
    want = ref_lud.lud_perimeter_row(jnp.asarray(diag), jnp.asarray(strip),
                                     bw=w, interpret=True)
    _close(got, want)
    exact = torch.linalg.solve_triangular(
        torch.from_numpy(np.tril(diag, -1) + np.eye(bs)).double(),
        _t(strip).double(), upper=False, unitriangular=True)
    err, plain_err = _perimeter_errors(
        got, lud.lud_perimeter_row_plain(_t(diag), _t(strip)), exact)
    print(f"row bs={bs} w={w} dominant={dominant}: replay {err:.3g}, plain "
          f"{plain_err:.3g} against float64")
    assert err <= 4 * plain_err


@pytest.mark.parametrize("n,bs", [(8192, 32), (8192, 16), (8192, 64),
                                  (320, 16), (320, 32), (320, 64)])
def test_perimeter_blocks_cover_every_vector_once(n, bs):
    """A model of the fused launch's grid (csrc/lud.cu launch_perimeters,
    perim_row_part and perim_col_part) at every step of the schedule: per
    = kPerimThreads * 8 / bs vectors a block, the row strip's ceil(w /
    per) blocks, then the column strip's ceil(h / per); thread t is lane t
    % (bs / 8) of vector t // (bs / 8), with entries 8 lane .. 8 lane + 7
    (kPerimEntries = 8).  Every entry of both strips is written exactly
    once, and each vector's lanes share a warp."""
    e = PERIM_ENTRIES
    g_lanes = bs // e
    assert 32 % g_lanes == 0
    t = np.arange(PERIM_THREADS)
    lane, vec = t % g_lanes, t // g_lanes
    per = PERIM_THREADS * e // bs
    assert vec.max() + 1 == per
    assert (t // 32 == (vec * g_lanes) // 32).all()     # a group in a warp
    for c1 in range(bs, n, bs):
        h = w = n - c1
        row_blocks, col_blocks = -(-w // per), -(-h // per)
        cover = {"row": np.zeros((bs, w), np.int64),
                 "col": np.zeros((h, bs), np.int64)}
        for b in range(row_blocks + col_blocks):
            part, blk = ("row", b) if b < row_blocks else \
                ("col", b - row_blocks)
            v = blk * per + vec
            keep = v < (w if part == "row" else h)
            for k in range(e):
                if part == "row":
                    np.add.at(cover["row"], (e * lane[keep] + k, v[keep]), 1)
                else:
                    np.add.at(cover["col"], (v[keep], e * lane[keep] + k), 1)
        assert (cover["row"] == 1).all() and (cover["col"] == 1).all(), c1


def test_perimeters_on_cpu_are_both_plain_solves():
    """lud_perimeters_cuda on CPU tensors solves both strips in place with
    the plain versions, and launches nothing."""
    for k in lud.LAUNCHES:
        lud.LAUNCHES[k] = 0
    diag = torch.from_numpy(_perimeter_diag(32, 70, True))
    a = _t(np.random.default_rng(71).uniform(size=(96, 96)))
    row, col = a[:32, 32:].clone(), a[32:, :32].clone()
    got_row, got_col = lud.lud_perimeters_cuda(diag, row, col)
    assert got_row is row and got_col is col
    torch.testing.assert_close(row, lud.lud_perimeter_row_plain(
        diag, a[:32, 32:]), rtol=0, atol=0)
    torch.testing.assert_close(col, lud.lud_perimeter_col_plain(
        diag, a[32:, :32]), rtol=0, atol=0)
    assert set(lud.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError):
        lud.lud_perimeters_cuda(diag, row, torch.zeros(64, 16))


# -- the K = bs update: both regions of a sub-step in one launch ----------------

#: SMs of the H100 the grid is sized for (csrc/lud.cu reads the card's)
H100_SMS = 132
#: tiles a block takes at most
INTERNAL_MAX_TILES = _lud_constant("kMaxTiles")


def _internal_blocks(tall, wide, sms=H100_SMS):
    """The grid of one launch, as LudInternalLaunch::run and lud_region lay
    it out: per block (region, first tile, tiles, part), where a region
    (h, w) is streamed along h (tall) or w (wide) in tiles of TILE and a
    ragged last tile of `part` rows or columns is a block of its own."""
    t = lud.TILE
    extent = {"tall": tall[0], "wide": wide[1]}
    full = {k: e // t for k, e in extent.items()}
    tiles = max(1, min(INTERNAL_MAX_TILES,
                       -(-(full["tall"] + full["wide"]) // (2 * sms))))
    blocks = []
    for kind in ("tall", "wide"):
        nf = full[kind]
        for b in range(-(-nf // tiles) + (extent[kind] % t > 0)):
            j0 = b * tiles
            if j0 >= nf:
                blocks.append((kind, nf, 1, extent[kind] - nf * t))
            else:
                blocks.append((kind, j0, min(tiles, nf - j0), t))
    return tiles, blocks


def _thread_cover(kind, m, part, bs):
    """How often the body writes each entry of one output tile that the
    store then writes back (tall: part rows x m; wide: m rows x part
    columns).  A thread owns 4 rows x 4 columns: tall, warp w rows
    4w..4w+3 and lane j columns 4j..4j+3 (a lane past m / 4 idles); wide,
    rows 16w + 4(j // 8) .. +3 and columns 4(j % 8) .. +3 (a warp past m /
    16 idles); rows past the tile's are not written, columns past `part`
    never stored."""
    t = lud.TILE
    rows, cols = (part, m) if kind == "tall" else (m, t)
    cover = np.zeros((part, m) if kind == "tall" else (m, part), np.int64)
    for tid in range(256):
        warp, lane = divmod(tid, 32)
        r0, c0 = (4 * warp, 4 * lane) if kind == "tall" else \
            (16 * warp + 4 * (lane // 8), 4 * (lane % 8))
        if r0 >= rows or c0 >= cols:
            continue
        for r in range(r0, min(r0 + 4, rows)):
            for c in range(c0, c0 + 4):
                if c < cover.shape[1]:
                    cover[r, c] += 1
    assert t == 32 and 4 * 32 >= lud.PANEL - 16 and 16 * 8 >= lud.PANEL - 16
    return cover


@pytest.mark.parametrize("n,bs", [(8192, 32), (8192, 16), (8192, 64),
                                  (320, 16), (320, 32), (320, 64)])
def test_internal_blocks_cover_every_entry_once(n, bs):
    """A model of the one-launch grid at every sub-step of the schedule:
    the blocks' tiles cover each region's streamed side once, and the
    threads of a tile (each shape a sub-step gives: full and ragged, tall
    and wide) write each entry of it once, so every entry of both regions
    is written exactly once.  At n = 8192, bs = 32 the first sub-step's
    grid is about two blocks an SM, two tiles a block."""
    t = lud.TILE
    shapes = {}
    for c, c1, end in lud.internal_substeps(n, bs):
        tall, wide = (n - c1, end - c1), (end - c1, n - end)
        m = end - c1
        assert m <= lud.PANEL - bs
        tiles, blocks = _internal_blocks(tall, wide)
        for kind, extent in (("tall", tall[0]), ("wide", wide[1])):
            seen = np.zeros(-(-extent // t), np.int64)
            for k_, j0, n_tiles, part in blocks:
                if k_ != kind:
                    continue
                assert n_tiles >= 1 and 0 < part <= t and part % 4 == 0
                seen[j0:j0 + n_tiles] += 1
                shapes[(kind, m, part)] = None
            assert (seen == 1).all(), (c, kind)
        if (n, bs, c) == (8192, 32, 0):
            assert tiles == 2 and len(blocks) == 254
    for kind, m, part in shapes:
        assert (_thread_cover(kind, m, part, bs) == 1).all(), (kind, m, part)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_internal_pair_matches_pallas(strategy):
    """Both updates in one call (on the CPU, the plain versions) against
    the reference's lud_internal in interpret mode, run once a region, at
    (H, K, W) = (128, 32, 128)."""
    rng = np.random.default_rng(24)
    regions = [((rng.uniform(size=(128, 32)) / 128).astype(np.float32),
                rng.uniform(size=(32, 128)).astype(np.float32),
                rng.uniform(size=(128, 128)).astype(np.float32))
               for _ in range(2)]
    want = [ref_lud.lud_internal(*map(jnp.asarray, r), spec=RefSpec(strategy),
                                 interpret=True) for r in regions]
    tall, wide = (tuple(map(_t, r)) for r in regions)
    got = lud.lud_internal_pair_cuda(tall, wide,
                                     spec=PipelineSpec(strategy))
    assert got[0] is tall[2] and got[1] is wide[2]     # updated in place
    for g_, w_ in zip(got, want):
        _close(g_, w_)


def test_internal_pair_on_cpu_is_both_plain_updates():
    """lud_internal_pair_cuda on CPU tensors updates both regions of a
    sub-step in place with the plain versions, or the tall one alone in
    the last panel, and launches nothing."""
    for k in lud.LAUNCHES:
        lud.LAUNCHES[k] = 0
    n, bs = 320, 32
    a = _t(_matrix(n, 72))
    for c, c1, end in (lud.internal_substeps(n, bs)[0],
                       lud.internal_substeps(n, bs)[-1]):
        x = a.clone()
        wide = (x[c1:end, c:c1], x[c:c1, end:], x[c1:end, end:]) \
            if end < n else None
        got = lud.lud_internal_pair_cuda(
            (x[c1:, c:c1], x[c:c1, c1:end], x[c1:, c1:end]), wide)
        torch.testing.assert_close(got[0], lud.lud_internal_plain(
            a[c1:, c:c1], a[c:c1, c1:end], a[c1:, c1:end]), rtol=0, atol=0)
        if wide is None:
            assert got[1] is None and end == n
        else:
            torch.testing.assert_close(got[1], lud.lud_internal_plain(
                a[c1:end, c:c1], a[c:c1, end:], a[c1:end, end:]),
                rtol=0, atol=0)
        untouched = torch.ones(n, n, dtype=torch.bool)
        untouched[c1:, c1:end] = False
        untouched[c1:end, end:] = False
        assert torch.equal(x[untouched], a[untouched])
    assert set(lud.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError):                     # K differs
        lud.lud_internal_pair_cuda(
            (a[:8, :16], a[:16, :8], a[:8, :8].clone()),
            (a[:8, :32], a[:32, :8], a[:8, :8].clone()))


def test_internal_bytes_at_the_h100_cell():
    """The K = bs updates of one call at n = 8192, bs = 32: 192 sub-steps
    whose L, U and C read and C written are 1.003 GB, 0.2994 ms at 3.35
    TB/s (the bound PERF.md gives the whole call's updates)."""
    n, bs = 8192, 32
    total = 0
    for c, c1, end in lud.internal_substeps(n, bs):
        for h, w in ((n - c1, end - c1), (end - c1, n - end)):
            if w:
                total += 4 * (h * bs + bs * w + 2 * h * w)
    assert len(lud.internal_substeps(n, bs)) == 192
    assert total == 1_002_938_368
    assert total / 3.35e12 * 1e3 == pytest.approx(0.2994, abs=1e-4)
