"""Declarative benchmark scenarios: kernel x shape x dtype x strategy.

The counterpart of ``repro.bench.scenario`` for the ported kernels.  It
registers the reference's own parity cells under the same names and shapes
(``smoke/*``, ``fig3/stream/*``, ``fig4/{hotspot,pathfinder,nw,lud}/*``),
whose working sets fit the H100's 50 MB L2, and the ``h100/*`` cells at
HBM scale, each over 4x the L2:

  h100/stream/<strategy>   (16384, 4096) f32, iters=1, tile_rows=16,
                           n_tiles=8: 256 MiB in + 256 MiB out
  h100/hotspot/<strategy>  (8192, 8192) f32, iters=1, grid=32 row bands x
                           32 column tiles = 1024 blocks (7.8 per SM):
                           256 MiB each of temp, power and out
  h100/lud/<strategy>      (8192, 8192) f32, bs=32: 256 diagonal steps on a
                           256 MiB matrix (Rodinia ships 8000^2; 8192 is
                           the nearest n with n % 32 == 0)
  h100/pathfinder/<s>      wall (1001, 100000) int32, tile_rows=8: 400.4 MB
                           (Rodinia 3.1 runs `pathfinder 100000 100 20`;
                           its width, 10x its rows, (rows-1) % 8 == 0)
  h100/nw/<strategy>       n = 8192, penalty 10, tile_rows=8: 268.4 MB of
                           scores and 268.5 MB of table (Rodinia runs
                           `needle 2048 10`; 4x its side, h100/lud's n)
  h100/matmul/<strategy>   (M, K, N) = (8192, 1536, 8960) bf16 in, f32 out:
                           qwen2-1.5b's gate/up projection (d_model 1536 ->
                           d_ff 8960) over 8,192 prefill tokens; 346.3 MB
  h100/flash_attention/<s> (b, h, kvh, s, d) = (4, 12, 2, 4096, 128) f32,
                           causal: qwen2-1.5b's attention (12 q heads, 2 KV
                           heads, head_dim 128) over four 4,096-token
                           prefills; 234.9 MB

and, at the same shapes, the paper's remaining cells:

  h100/stream/<s>/iters=32 Fig. 3's intensity axis: h100/stream/<s> at
                           iters=32 (the reference's fig3/stream/*/iters=32)
  regime/<kernel>/sync     the regime map (``bench.regime``) under the
  regime/<kernel>/<a>/d<n> reference's names: each kernel's h100 cell under
                           SYNC, and under OVERLAP (DROP_OFF for pathfinder)
                           and TMA at ring depths 2, 3 and 4
  tuned/<kernel>           each kernel's h100 cell with no strategy or
                           config, so that its config is the tuning
                           registry's winner whole (every h100 and regime
                           cell pins its strategy); the workload the tuner
                           runs (stream at STREAM_ITERS)
  serve/<arrival>/<sched>  the reference's nine serving cells, the same
  serve/prefix/<variant>   names and workloads (``ServeScenario``): the
                           smoke qwen2-1.5b served by the continuous and
                           cohort schedulers under uniform, poisson and
                           bursty traces, and a shared-prefix trace
                           monolithic, chunked and chunked + shared

``args_from_numpy`` and ``config_from_reference`` carry inputs and configs
across from the reference package, which is how the tests hold the two to
each other.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.async_pipeline import Strategy, parse_strategy
from ..kernels import ops, ref
from ..tuning.search_space import KERNELS, SPECS, STREAM_ITERS

__all__ = ["Scenario", "ServeScenario", "register", "get_scenario",
           "scenarios", "call_kernel", "check_output", "CALLERS", "ORACLES",
           "CHECKS", "CHECK_TOL", "KERNELS", "SERVE_KERNEL",
           "args_from_numpy", "config_from_reference"]

#: pseudo-kernel name marking end-to-end serving scenarios: they run the
#: model serving loop (bench.serving), not one kernel, so they bypass
#: SPECS, CALLERS and the roofline projection
SERVE_KERNEL = "serve"


@dataclass(frozen=True)
class Scenario:
    """One runnable benchmark cell."""
    name: str                            # unique, hierarchical: "fig3/..."
    kernel: str                          # key into SPECS / ops
    shape: Tuple[int, ...]
    dtype: str = "float32"
    strategy: Optional[Strategy] = None  # None -> the resolved default
    config: Dict[str, Any] = field(default_factory=dict)   # tile overrides
    workload: Dict[str, Any] = field(default_factory=dict) # iters/grid/..
    tags: Tuple[str, ...] = ()
    smoke: bool = False
    section: str = ""                    # paper figure/table it feeds

    def __post_init__(self):
        if self.kernel not in SPECS:
            raise KeyError(f"unknown kernel {self.kernel!r}; "
                           f"known: {tuple(SPECS)}")
        object.__setattr__(self, "shape",
                           tuple(int(s) for s in self.shape))

    def make_args(self, device: Any = "cuda", seed: int = 0) -> Tuple:
        """The inputs, drawn on ``device`` from a generator seeded with
        ``seed``."""
        g = torch.Generator(device=device).manual_seed(seed)
        return SPECS[self.kernel].make_args(self.shape, self.dtype, g,
                                            device)

    @property
    def is_serving(self) -> bool:
        return self.kernel == SERVE_KERNEL

    def matches(self, *, only: Optional[str] = None,
                kernel: Optional[str] = None,
                strategy: Optional[Strategy] = None,
                tag: Optional[str] = None,
                smoke: Optional[bool] = None) -> bool:
        if only is not None and not any(
                tok and tok in self.name for tok in only.split(",")):
            return False
        if kernel is not None and kernel != self.kernel:
            return False
        if strategy is not None and self.strategy not in (None, strategy):
            return False
        if tag is not None and tag not in self.tags:
            return False
        if smoke is not None and self.smoke != smoke:
            return False
        return True


@dataclass(frozen=True)
class ServeScenario(Scenario):
    """An end-to-end serving workload: scheduler x arrival trace.

    ``workload`` carries the trace/scheduler parameters consumed by
    ``bench.serving.run_serve_scenario``: scheduler ("continuous" |
    "cohort"), arrival ("uniform" | "poisson" | "bursty"), n_requests,
    batch, rate, burst, prompt_lens [lo, hi], max_new [lo, hi], seed,
    block_len, arch, and chunk_tokens, prefix_len, prefix_group,
    prefix_cache, check_outputs.  ``shape`` is (batch, n_requests) for
    display."""
    kernel: str = SERVE_KERNEL
    shape: Tuple[int, ...] = ()

    def __post_init__(self):
        # no SPECS entry: serving scenarios are not kernel cells
        if self.kernel != SERVE_KERNEL:
            raise ValueError(f"ServeScenario.kernel must be "
                             f"{SERVE_KERNEL!r}, got {self.kernel!r}")
        object.__setattr__(self, "shape",
                           tuple(int(s) for s in self.shape))

    def make_args(self, device: Any = "cuda", seed: int = 0):
        raise TypeError("serving scenarios have no kernel args; run them "
                        "via bench.serving.run_serve_scenario")


#: kernel -> fn(args, config, workload) -> tensor.  The config dict holds
#: exactly the KERNEL_DEFAULTS keys; workload holds the problem parameters
#: a figure sweeps.
CALLERS: Dict[str, Callable[..., Any]] = {
    "stream": lambda a, cfg, w: ops.stream(
        a[0], iters=w.get("iters", 4), **cfg),
    "hotspot": lambda a, cfg, w: ops.hotspot(
        a[0], a[1], iters=w.get("iters", 1), grid=w.get("grid", 1), **cfg),
    "pathfinder": lambda a, cfg, w: ops.pathfinder(a[0], **cfg),
    "nw": lambda a, cfg, w: ops.nw(a[0], penalty=w.get("penalty", 10), **cfg),
    "lud": lambda a, cfg, w: ops.lud(a[0], **cfg),
    "matmul": lambda a, cfg, w: ops.matmul(a[0], a[1], **cfg),
    "flash_attention": lambda a, cfg, w: ops.flash_attention(
        a[0], a[1], a[2], causal=w.get("causal", True),
        window=w.get("window", 0), **cfg),
}


def _attention_oracle(a, w):
    """``ref.attention_ref`` on q (..., H, S, D) and k, v (..., KVH, S, D):
    the KV heads repeated for GQA and the leading dims flattened into the
    heads."""
    q, k, v = a
    k, v = (t.repeat_interleave(q.shape[-3] // k.shape[-3], dim=-3)
            for t in (k, v))
    out = ref.attention_ref(*(t.reshape(-1, *t.shape[-2:]) for t in (q, k, v)),
                            causal=w.get("causal", True),
                            window=w.get("window", 0))
    return out.reshape(q.shape)

#: kernel -> fn(args, workload) -> reference output (kernels.ref oracle).
ORACLES: Dict[str, Callable[..., Any]] = {
    "stream": lambda a, w: ref.stream_ref(a[0], iters=w.get("iters", 4)),
    "hotspot": lambda a, w: ref.hotspot_ref(a[0], a[1],
                                            iters=w.get("iters", 1)),
    "pathfinder": lambda a, w: ref.pathfinder_ref(a[0]),
    "nw": lambda a, w: ref.nw_ref(a[0], w.get("penalty", 10)),
    "lud": lambda a, w: ref.lud_ref(a[0]),
    "matmul": lambda a, w: ref.matmul_ref(a[0], a[1]),
    "flash_attention": _attention_oracle,
}


def _oracle(kernel: str, args, workload, kept: Optional[Dict] = None):
    """``ORACLES[kernel](args, workload)``.  With ``kept`` (a dict its
    caller owns and drops), an oracle is kept with its inputs and reused
    for a later call whose inputs are equal (``torch.equal``): the cells of
    a kernel that differ only in strategy or ring depth draw the same
    seeded inputs, so a sweep, or the h100 cells of every strategy, need
    each oracle once."""
    if kept is None:
        return ORACLES[kernel](args, workload)
    key = (kernel, repr(sorted(workload.items())),
           tuple((tuple(a.shape), a.dtype) for a in args))
    hit = kept.get(key)
    if hit is not None and all(torch.equal(a, b)
                               for a, b in zip(hit[0], args)):
        return hit[1]
    want = ORACLES[kernel](args, workload)
    kept[key] = (tuple(args), want)
    return want


def _max_abs_error(kernel: str) -> Callable[..., float]:
    """max |out - oracle|; pathfinder's kernel returns a (1, cols) row and
    its oracle the row itself, so its row 0 is compared."""
    def check(args, out, workload, kept=None) -> float:
        want = _oracle(kernel, args, workload, kept)
        got = out[0] if kernel == "pathfinder" else out
        return float((got.float() - want.float()).abs().max())
    return check


def _by_part(err: torch.Tensor, scale: torch.Tensor) -> float:
    """The largest of max err / max scale over the strict lower triangle,
    the diagonal and the strict upper triangle of square matrices (plain
    max err where a part's scale is 0)."""
    worst = 0.0
    for part in (lambda t: torch.tril(t, -1), torch.diagonal,
                 lambda t: torch.triu(t, 1)):
        e, s = float(part(err).max()), float(part(scale).max())
        worst = max(worst, e / s if s else e)
    return worst


def _lud_error(args, out, workload, kept=None) -> float:
    """The larger of two errors, each ``_by_part``: ``out`` against the
    oracle run in float64, and the reconstruction L U - a against a."""
    a = args[0].double()
    want = _oracle("lud", (a,), workload, kept)
    got = out.double()
    lower = torch.tril(got, -1) + torch.eye(a.shape[0], dtype=a.dtype,
                                            device=a.device)
    residual = lower @ torch.triu(got) - a
    return max(_by_part((got - want).abs(), want.abs()),
               _by_part(residual.abs(), a.abs()))


#: kernel -> fn(args, out, workload, kept) -> the error ``check_output``
#: reports (``kept``: see ``_oracle``):
#: max |kernel - oracle| for every kernel but lud, ``_lud_error`` for lud
CHECKS: Dict[str, Callable[..., float]] = {
    k: _lud_error if k == "lud" else _max_abs_error(k) for k in CALLERS}

#: the limit on each kernel's ``CHECKS`` error: the reference's absolute
#: values for stream, hotspot, pathfinder, nw, matmul and flash_attention.  For lud the reference's
#: absolute 1e-2 cannot hold at n=8192: U's diagonal grows to ~n, where an
#: f32 ulp is ~1e-3, and two f32 LUs summed in different orders part by more
#: than that there.  Nor can one scale serve the whole matrix: on the benchmark's
#: U[0, 1) + n I the diagonal is ~n, U's other entries < 1 and L's ~1/n, so
#: an error measured against the diagonal lets a wrong update of the rest
#: through.  Each part (L, U's diagonal, U's other entries) is therefore
#: held to its own largest entry.  A sound f32 LU reads 1e-6 to 1e-5 there
#: (7.5e-7 at n=1024 on a CPU, 5.1e-6 at n=8192 on an H100, bs=32).  An
#: internal update skipped reads 0.17-0.26 and one added with the wrong
#: sign 0.63-1.0 at those sizes, as the missing sums are of the order of
#: U's entries at any n.  1e-4 lies between, with room for summation order.
CHECK_TOL: Dict[str, float] = {"stream": 1e-5, "hotspot": 1e-2,
                               "pathfinder": 0.5, "nw": 1e-3, "lud": 1e-4,
                               "matmul": 1e-2, "flash_attention": 2e-2}


def call_kernel(sc: Scenario, args: Tuple, config: Dict[str, Any]):
    return CALLERS[sc.kernel](args, config, sc.workload)


def check_output(sc: Scenario, args: Tuple, out,
                 oracles: Optional[Dict] = None) -> float:
    """The ``CHECKS`` error of ``out`` against the plain-torch oracle;
    ``oracles``, a dict the caller owns, keeps each oracle for later calls
    on equal inputs (``_oracle``)."""
    return CHECKS[sc.kernel](args, out, sc.workload, oracles)


def args_from_numpy(kernel: str, arrays: Sequence[np.ndarray],
                    device: Any = "cuda") -> Tuple[torch.Tensor, ...]:
    """The port's arguments for ``kernel`` from numpy arrays (bfloat16
    arrays, as numpy receives them from JAX, keep their bits)."""
    if kernel not in SPECS:
        raise KeyError(f"unknown kernel {kernel!r}; known: {tuple(SPECS)}")
    out = []
    for a in arrays:
        a = np.array(a, order="C")      # a writable copy torch may own
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        out.append(t.to(device))
    return tuple(out)


def config_from_reference(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The port's config for a reference config dict; ``strategy`` may be
    the reference's enum or its string."""
    out = dict(cfg)
    if "strategy" in out:
        s = out["strategy"]
        out["strategy"] = parse_strategy(getattr(s, "value", s))
    return out


_SCENARIOS: Dict[str, Scenario] = {}


def register(sc: Scenario) -> Scenario:
    """Add ``sc`` to the registry; re-registering a name with a different
    definition is an error."""
    existing = _SCENARIOS.get(sc.name)
    if existing is not None and existing != sc:
        raise ValueError(f"scenario {sc.name!r} already registered "
                         f"with a different definition")
    _SCENARIOS[sc.name] = sc
    return sc


def get_scenario(name: str) -> Scenario:
    try:
        return _SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; run "
                       f"`python -m repro_torch.bench.cli list`") from None


def scenarios(*, only: Optional[str] = None, kernel: Optional[str] = None,
              strategy: Optional[Strategy] = None, tag: Optional[str] = None,
              smoke: Optional[bool] = None) -> List[Scenario]:
    return [s for _, s in sorted(_SCENARIOS.items())
            if s.matches(only=only, kernel=kernel, strategy=strategy,
                         tag=tag, smoke=smoke)]


def _register_defaults() -> None:
    register(Scenario(name="smoke/stream", kernel="stream", shape=(256, 256),
                      workload={"iters": 4}, tags=("smoke",), smoke=True,
                      section="smoke"))
    register(Scenario(name="smoke/hotspot", kernel="hotspot",
                      shape=(32, 126), workload={"iters": 2},
                      tags=("smoke",), smoke=True, section="smoke"))
    register(Scenario(name="smoke/pathfinder", kernel="pathfinder",
                      shape=(33, 128), tags=("smoke",), smoke=True,
                      section="smoke"))
    register(Scenario(name="smoke/nw", kernel="nw", shape=(32,),
                      tags=("smoke",), smoke=True, section="smoke"))
    register(Scenario(name="smoke/lud", kernel="lud", shape=(64,),
                      tags=("smoke",), smoke=True, section="smoke"))
    register(Scenario(name="smoke/matmul", kernel="matmul",
                      shape=(256, 256, 256), tags=("smoke",), smoke=True,
                      section="smoke"))
    register(Scenario(name="smoke/flash_attention", kernel="flash_attention",
                      shape=(2, 256, 64), tags=("smoke",), smoke=True,
                      section="smoke"))
    for strategy in Strategy:
        # paper Fig. 3 and Fig. 4 parity cells, as the reference has them
        for iters in (1, 32):
            register(Scenario(
                name=f"fig3/stream/{strategy.value}/iters={iters}",
                kernel="stream", shape=(256, 256), strategy=strategy,
                config={"tile_rows": 16, "n_tiles": 8},
                workload={"iters": iters},
                tags=("fig3", "paper"), section="fig3"))
        register(Scenario(
            name=f"fig4/hotspot/{strategy.value}", kernel="hotspot",
            shape=(32, 126), strategy=strategy, workload={"iters": 2},
            tags=("fig4", "paper"), section="fig4"))
        register(Scenario(
            name=f"fig4/pathfinder/{strategy.value}", kernel="pathfinder",
            shape=(33, 128), strategy=strategy, tags=("fig4", "paper"),
            section="fig4"))
        register(Scenario(
            name=f"fig4/nw/{strategy.value}", kernel="nw", shape=(32,),
            strategy=strategy, tags=("fig4", "paper"), section="fig4"))
        register(Scenario(
            name=f"fig4/lud/{strategy.value}", kernel="lud", shape=(64,),
            strategy=strategy, tags=("fig4", "paper"), section="fig4"))
        # HBM-scale cells: ~10x the L2, every SM holding several blocks
        register(Scenario(
            name=f"h100/stream/{strategy.value}", kernel="stream",
            shape=(16384, 4096), strategy=strategy,
            config={"tile_rows": 16, "n_tiles": 8}, workload={"iters": 1},
            tags=("h100",), section="fig3"))
        register(Scenario(
            name=f"h100/hotspot/{strategy.value}", kernel="hotspot",
            shape=(8192, 8192), strategy=strategy,
            workload={"iters": 1, "grid": 32}, tags=("h100",),
            section="fig4"))
        register(Scenario(
            name=f"h100/lud/{strategy.value}", kernel="lud", shape=(8192,),
            strategy=strategy, tags=("h100",), section="fig4"))
        register(Scenario(
            name=f"h100/pathfinder/{strategy.value}", kernel="pathfinder",
            shape=(1001, 100000), strategy=strategy,
            config={"tile_rows": 8}, tags=("h100",), section="fig4"))
        register(Scenario(
            name=f"h100/nw/{strategy.value}", kernel="nw", shape=(8192,),
            strategy=strategy, config={"tile_rows": 8},
            workload={"penalty": 10}, tags=("h100",), section="fig4"))
        # qwen2-1.5b's widths (src/repro/configs/qwen2_1_5b.py), the model
        # of every serve/* cell
        register(Scenario(
            name=f"h100/matmul/{strategy.value}", kernel="matmul",
            shape=(8192, 1536, 8960), dtype="bfloat16", strategy=strategy,
            tags=("h100",), section="models"))
        register(Scenario(
            name=f"h100/flash_attention/{strategy.value}",
            kernel="flash_attention", shape=(4, 12, 2, 4096, 128),
            strategy=strategy, workload={"causal": True, "window": 0},
            tags=("h100",), section="models"))
        # Fig. 3's intensity axis at HBM scale
        h100 = get_scenario(f"h100/stream/{strategy.value}")
        register(replace(h100, name=f"{h100.name}/iters=32",
                         config=dict(h100.config), workload={"iters": 32}))
    # the regime map at HBM scale: the reference's cells
    # (src/repro/bench/scenario.py, "regime map"), each at its kernel's h100
    # cell; the reference's own shapes fit in the L2
    for kernel in KERNELS:
        strat = (Strategy.DROP_OFF if kernel == "pathfinder"
                 else Strategy.OVERLAP)
        cells = [(Strategy.SYNC, None)] + [
            (s, depth) for depth in (2, 3, 4) for s in (strat, Strategy.TMA)]
        for s, depth in cells:
            h100 = get_scenario(f"h100/{kernel}/{s.value}")
            config = dict(h100.config)
            if depth is not None:
                config["depth"] = depth
            register(replace(
                h100, name=f"regime/{kernel}/{s.value}" + (
                    f"/d{depth}" if depth is not None else ""),
                config=config, workload=dict(h100.workload),
                tags=("regime",), section="regime"))
    # one unpinned cell a kernel, at its h100 cell's shape and dtype
    for kernel in KERNELS:
        h100 = get_scenario(f"h100/{kernel}/sync")
        workload = {"iters": STREAM_ITERS} if kernel == "stream" \
            else dict(h100.workload)
        register(Scenario(name=f"tuned/{kernel}", kernel=kernel,
                          shape=h100.shape, dtype=h100.dtype,
                          workload=workload, tags=("tuned",),
                          section="tuned"))
    # serving (the reference's cells, src/repro/bench/scenario.py): the
    # continuous scheduler against the static-cohort baseline under three
    # deterministic arrival traces, then one shared-prefix poisson trace
    # (prefix 64 in groups of 4) run monolithic, chunked (16 = 2 blocks)
    # and chunked with prefix sharing, whose ``check_outputs`` replays it
    # unshared and fails unless the greedy tokens are the same
    serve_traces = {
        "uniform": dict(n_requests=6, batch=2, rate=0.5,
                        prompt_lens=[5, 16], max_new=[4, 8]),
        "poisson": dict(n_requests=16, batch=4, rate=0.5,
                        prompt_lens=[5, 24], max_new=[8, 40]),
        "bursty": dict(n_requests=8, batch=2, rate=0.5, burst=4,
                       prompt_lens=[5, 16], max_new=[4, 12]),
    }
    for arrival, wl in serve_traces.items():
        for sched in ("continuous", "cohort"):
            register(ServeScenario(
                name=f"serve/{arrival}/{sched}",
                shape=(wl["batch"], wl["n_requests"]),
                workload={"scheduler": sched, "arrival": arrival,
                          "seed": 0, "block_len": 8,
                          "arch": "qwen2-1.5b", **wl},
                tags=("serve",), section="serve"))
    prefix_wl = dict(n_requests=16, batch=4, rate=0.25, seed=0,
                     block_len=8, arch="qwen2-1.5b", arrival="poisson",
                     prompt_lens=[5, 24], max_new=[8, 24],
                     prefix_len=64, prefix_group=4)
    for variant, extra in (
            ("baseline", {}),
            ("chunked", {"chunk_tokens": 16}),
            ("shared", {"chunk_tokens": 16, "prefix_cache": True,
                        "check_outputs": True})):
        register(ServeScenario(
            name=f"serve/prefix/{variant}",
            shape=(prefix_wl["batch"], prefix_wl["n_requests"]),
            workload={"scheduler": "continuous", **prefix_wl, **extra},
            tags=("serve", "prefix"), section="serve"))


_register_defaults()
