"""Compare the kernels of this checkout with another checkout's on one card.

    PYTHONPATH=src python -m repro_torch.bench.ab BASE [--only SUBSTRING]

BASE is the root of another checkout of the repository, for instance the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists.  Both ``src/repro_torch/csrc`` trees are built with
the same flags (BASE's into ``BASE/build/kernels``), all ``nvcc`` at once.
Then:

  * ``sass``: for each library, how many of BASE's kernel functions have
    the same SASS as a function built here (addresses, encodings and names
    left out), and which differ;
  * ``time``: each case of ``CASES`` (hotspot, the f32 and bf16 matmul,
    the batched bf16 launch at a prefill and a decode step,
    lud_internal at K = bs, a launch a region and both regions in one
    launch, the trailing update at K = PANEL, the whole lud, flash
    attention in f32 and bf16, nw, pathfinder) at
    the h100 shapes and every strategy's default spec (the flash
    backward, in bf16 and f32 at the flash cell and in bf16 at phase 12's
    layer shape, takes no strategy: ``STRATEGY_FREE``, timed once),
    launched through this checkout's wrappers with BASE's library and
    with this one's, in turns base, here, here, base: the median device
    time of 20 calls,
    each timed with CUDA events (``bench.timing.time_callable``), and
    beside them the one PyTorch call that computes the same function
    (``torch.mm``, ``addmm``, ``lu_factor``, SDPA, SDPA's backward; none
    for hotspot, nw and pathfinder) and here's time over it.  A library of
    ``OWN_WRAPPER`` (hotspot, pathfinder and flash attention, whose C
    interfaces differ between checkouts, matmul, whose batched launch
    budgets its shared memory by its tile height, and the flash backward,
    whose scratch grew with its bf16 design) is
    timed on BASE's side through
    BASE's own wrapper module, imported from BASE, with BASE's build, so
    that each side's time is a whole wrapper call (hotspot's BASE: its
    edge pad and its kernel), wherever BASE has that module (a variant
    that copies ``csrc/`` alone runs through here's wrapper, its library
    swapped in); with ``--busy`` its lines are followed by a ``busy`` line
    each side: the device time of one call's kernels from torch.profiler
    (pathfinder's own kernel; every kernel of a hotspot call), the kernels
    a call, and their share of the call's CUDA-event time.  The first
    sub-step's K = bs updates (``BUSY``) are shorter than the host's time
    to launch them: their time, and their
    ``addmm``'s, is device time from torch.profiler, as below.  The cases
    of ``ONCE`` take no strategy and are timed once: lud's perimeter
    solves at the first step of n = 8192, bs = 32
    (h = w = 8160) and at a late one (h = w = 1024), the row and the
    column solve each through its launcher and both through the launch of
    both (which BASE may lack), beside ``solve_triangular``; they are
    shorter than the host's time to launch them, so their time is the
    device time of one call from torch.profiler (the summed time of the
    perimeter kernels in 50 calls, over 50).  Each call first restores
    its strips (a copy left out of the time): solved again and again in
    place, the column strip would shrink into subnormals, where a
    division takes its slow path.
    Each line ends with the SM clock (median) and the power draw (most)
    that ``nvidia-smi`` read during its turns.  ``--only`` times only
    the cases whose name holds SUBSTRING (say, "matmul f32").
    ``--rounds N`` takes the four turns N times over, and the line adds
    here/base of each round (its two here over its two base): the
    least, the median and the most; both sides' median, base's
    quartiles, and in how many pairs (a base turn and the here turn
    beside it) here was faster: what a gain must clear.

Only a library whose C interface is the same in both checkouts can be
timed so; a launch that BASE's library refuses, or a launcher it lacks,
shows as an error on that line.  The wrappers pass here's shared-memory
budget, except that BASE's flash attention gets the card's whole block
(``SMEM_PER_BLOCK``): its layout may need more than here's, and both run
one block an SM either way; and BASE's lud gets what BASE's own
``kernels/lud.py`` budgets (``internal_smem``, imported from BASE), since
its K = bs body may lay its shared memory out otherwise.  The whole lud
is timed through ``lud._lud_launch``, which leaves out ``lud_cuda``'s
check of the launch counts, so that a BASE with another schedule runs
too.  Only the libraries of the cases ``--only`` selects are built and
compared, or with ``--sass-all`` every library of ``_build.SOURCES``
(stream's too, which no case times).  Exits 1 with no card.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import shutil
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..core.async_pipeline import SMEM_PER_BLOCK, PipelineSpec, Strategy
from ..kernels import (_build, flash_attention, hotspot, lud, matmul, nw,
                       pathfinder)
from . import sass
from .timing import time_callable

__all__ = ["CASES", "ONCE", "OWN_WRAPPER", "compare_sass", "main"]


def _matmul_f32(gen):
    a, b = (torch.rand(s, generator=gen, device="cuda")
            for s in ((8192, 1536), (1536, 8960)))
    return (lambda spec, module=matmul: module.matmul_cuda(a, b, spec=spec),
            lambda: torch.mm(a, b))


def _matmul_bf16(gen):
    a, b = (torch.rand(s, generator=gen, device="cuda").bfloat16()
            for s in ((8192, 1536), (1536, 8960)))
    return (lambda spec, module=matmul: module.matmul_cuda(a, b, spec=spec),
            lambda: torch.mm(a, b))


def _matmul_batched(gen, rows=256):
    """qwen2-moe-a2.7b's gate product in bf16: 60 experts of K 2048, N
    1408, at a prefill of 4 x 512 tokens (256 rows an expert, 171 padded)
    or a decode step of 4 (``rows`` 128, 4 padded); BASE without
    ``matmul_batched_launch`` prints its error."""
    a = torch.rand((60, rows, 2048), generator=gen, device="cuda").bfloat16()
    b = torch.rand((60, 2048, 1408), generator=gen, device="cuda").bfloat16()
    return (lambda spec, module=matmul:
            module.matmul_batched_cuda(a, b, spec=spec),
            lambda: torch.bmm(a, b))


def _lud_matrix(gen, n=8192):
    return torch.rand((n, n), generator=gen, device="cuda") + \
        n * torch.eye(n, device="cuda")


def _lud_internal(gen, bs=32):
    """The two K = bs updates of the schedule's first sub-step: the
    panel's columns below its first block row, and the panel's rows right
    of it."""
    x, p = _lud_matrix(gen), lud.PANEL
    views = [(x[bs:, :bs], x[:bs, bs:p], x[bs:, bs:p]),
             (x[bs:p, :bs], x[:bs, p:], x[bs:p, p:])]

    def call(spec):
        for col, row, c in views:
            lud.lud_internal_cuda(col, row, c, spec=spec)

    def library():
        for col, row, c in views:
            torch.addmm(c, col, row, alpha=-1)

    return call, library


def _lud_internal_pair(gen, bs=32):
    """The same two updates in one launch (``lud_internal_pair_cuda``,
    which a BASE from before it lacks)."""
    x, p = _lud_matrix(gen), lud.PANEL
    tall = (x[bs:, :bs], x[:bs, bs:p], x[bs:, bs:p])
    wide = (x[bs:p, :bs], x[:bs, p:], x[bs:p, p:])

    def library():
        for col, row, c in (tall, wide):
            torch.addmm(c, col, row, alpha=-1)

    return (lambda spec: lud.lud_internal_pair_cuda(tall, wide, spec=spec),
            library)


def _lud_panel(gen, bs=32):
    x = _lud_matrix(gen)
    lud.lud_panel_plain(x, 0, bs)
    p = lud.PANEL
    col, row, c = x[p:, :p], x[:p, p:], x[p:, p:]
    return (lambda spec: lud.lud_internal_cuda(col, row, c, spec=spec),
            lambda: torch.addmm(c, col, row, alpha=-1))


def _lud(gen, bs=32):
    a = _lud_matrix(gen)
    return (lambda spec: lud._lud_launch(
        a.clone(memory_format=torch.contiguous_format), bs, spec),
        lambda: torch.linalg.lu_factor(a, pivot=False))


def _lud_perimeters(gen, bs=32, n=8192):
    """(label, call, library call) of each perimeter launch at two steps:
    the first (h = w = n - bs) and a late one (h = w = 1024), in place on
    views of one matrix, each step's diagonal block factored; a call
    first restores its strips from the input."""
    a = _lud_matrix(gen, n)
    x, out = a.clone(), []
    for hw in (n - bs, 1024):
        c, c1 = n - bs - hw, n - hw
        dg, row, col = x[c:c1, c:c1], x[c:c1, c1:], x[c1:, c:c1]
        row0, col0 = a[c:c1, c1:], a[c1:, c:c1]
        dg.copy_(lud.lud_diagonal_plain(a[c:c1, c:c1]))

        def solve_row(dg=dg, row0=row0):
            return torch.linalg.solve_triangular(dg, row0, upper=False,
                                                 unitriangular=True)

        def solve_col(dg=dg, col0=col0):
            return torch.linalg.solve_triangular(dg, col0, upper=True,
                                                 left=False)

        def run_row(dg=dg, row=row, row0=row0):
            row.copy_(row0)
            lud.lud_perimeter_row_cuda(dg, row)

        def run_col(dg=dg, col=col, col0=col0):
            col.copy_(col0)
            lud.lud_perimeter_col_cuda(dg, col)

        def run_both(dg=dg, row=row, col=col, row0=row0, col0=col0):
            row.copy_(row0)
            col.copy_(col0)
            lud.lud_perimeters_cuda(dg, row, col)

        out += [(f"row w={hw}", run_row, solve_row),
                (f"col h={hw}", run_col, solve_col),
                (f"both h=w={hw}", run_both,
                 lambda f=solve_row, g=solve_col: (f(), g()))]
    return out


def _flash(gen, dtype=torch.float32):
    """The h100 cell's (4, 12, 2, 4096, 128) causal attention in ``dtype``
    (the model path's bf16 too), at the key count S; the call takes the
    wrapper module, so that BASE's side runs BASE's own
    ``kernels/flash_attention.py`` (whose launchers may take other
    arguments)."""
    q = torch.randn((4, 12, 4096, 128), generator=gen, device="cuda")
    k, v = (torch.randn((4, 2, 4096, 128), generator=gen, device="cuda")
            for _ in range(2))
    q, k, v = (t.to(dtype) for t in (q, k, v))

    def call(spec, module=flash_attention):
        return module.flash_attention_cuda(q, k, v, spec=spec)

    return call, lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True)


def _flash_bwd(gen, dtype=torch.bfloat16, shape=(4, 12, 2, 4096, 128)):
    """The backward of the h100 cell's causal attention (or of ``shape``)
    in ``dtype``, on the forward kernel's output and an f32 output
    gradient; the call takes the wrapper module (BASE's side: BASE's own
    ``kernels/flash_attention.py``, whose scratch may be smaller) and no
    strategy; beside it SDPA's backward, K and V repeated to H."""
    b, h, kvh, s, d = shape
    q = torch.randn((b, h, s, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, kvh, s, d), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    o = flash_attention.flash_attention_cuda(q, k, v)
    dout = torch.randn((b, h, s, d), generator=gen, device="cuda")
    leaves = [t.detach().clone().requires_grad_(True) for t in (
        q, k.repeat_interleave(h // kvh, 1), v.repeat_interleave(h // kvh, 1))]
    sdpa = torch.nn.functional.scaled_dot_product_attention(*leaves,
                                                            is_causal=True)
    dsdpa = dout.to(dtype)

    def call(spec, module=flash_attention):
        return module.flash_attention_bwd_cuda(q, k, v, o, dout)

    return call, lambda: torch.autograd.grad(sdpa, leaves, dsdpa,
                                             retain_graph=True)


def _nw(gen, tile_rows=8):
    scores = torch.randint(-3, 4, (8192, 8192), generator=gen,
                           device="cuda").float()
    return (lambda spec: nw.nw_cuda(scores, 10, spec=spec,
                                    tile_rows=tile_rows), None)


def _hotspot(gen):
    """The h100 cell: (8192, 8192) f32, grid 32, one step; the call takes
    the wrapper module, so that BASE's side runs BASE's own
    ``kernels/hotspot.py``."""
    temp, power = (torch.rand((8192, 8192), generator=gen, device="cuda")
                   * scale + shift for scale, shift in ((100.0, 300.0),
                                                        (1.0, 0.0)))

    def call(spec, module=hotspot):
        return module.hotspot_step_cuda(temp, power, spec=spec, grid=32)

    return call, None


def _pathfinder(gen, tile_rows=8, rows=1001, depth=None):
    """The h100 cell's wall (rows - 1 a multiple of tile_rows: 1,009 rows
    at 16), at each strategy's default ring or at ``depth``; the call
    takes the wrapper module, so that BASE's side runs BASE's own
    ``kernels/pathfinder.py`` (and its PipelineSpec)."""
    wall = torch.randint(0, 10, (rows, 100000), generator=gen, device="cuda",
                         dtype=torch.int32)

    def call(spec, module=pathfinder):
        if depth is not None:
            spec = type(spec)(spec.strategy, depth, spec.wait_group,
                              spec.out_depth)
        return module.pathfinder_cuda(wall, spec=spec, tile_rows=tile_rows)

    return call, None


_FIRST = "lud_internal n=8192 bs=32 first sub-step (8160, 96) + (96, 8064)"
_FIRST_PAIR = "lud_internal_pair n=8192 bs=32 first sub-step, one launch"

#: (library, case, maker): maker(generator) -> (call(spec), the one
#: PyTorch call of the same function, or None where there is none)
CASES: List[Tuple[str, str, Callable]] = [
    ("hotspot", "hotspot (8192, 8192) grid=32", _hotspot),
    ("matmul", "matmul f32 (8192, 1536, 8960)", _matmul_f32),
    ("matmul", "matmul bf16 (8192, 1536, 8960)", _matmul_bf16),
    ("matmul", "matmul bf16 batched (60, 256, 2048, 1408)",
     _matmul_batched),
    ("matmul", "matmul bf16 batched decode (60, 128, 2048, 1408)",
     lambda gen: _matmul_batched(gen, 128)),
    ("lud", _FIRST, _lud_internal),
    ("lud", _FIRST_PAIR, _lud_internal_pair),
    ("lud", "lud_internal_panel n=8192 first panel (8064, 8064, 128)",
     _lud_panel),
    ("lud", "lud n=8192 bs=32", _lud),
    ("flash_attention", "flash_attention f32 (4, 12, 2, 4096, 128) causal",
     _flash),
    ("flash_attention", "flash_attention bf16 (4, 12, 2, 4096, 128) causal",
     lambda gen: _flash(gen, torch.bfloat16)),
    # the backward at the cell, and at phase 12's layer (4 x 512 tokens)
    ("flash_attention_bwd",
     "flash_attention_bwd bf16 (4, 12, 2, 4096, 128) causal", _flash_bwd),
    ("flash_attention_bwd",
     "flash_attention_bwd f32 (4, 12, 2, 4096, 128) causal",
     lambda gen: _flash_bwd(gen, torch.float32)),
    ("flash_attention_bwd",
     "flash_attention_bwd bf16 (4, 12, 2, 512, 128) causal",
     lambda gen: _flash_bwd(gen, shape=(4, 12, 2, 512, 128))),
    # the h100 cell's 8 rows a tile, and 16: the same rows in half the
    # tiles, which splits a call between rows and tiles where the two
    # sizes hand seeds over alike
    ("nw", "nw n=8192 tile_rows=8", _nw),
    ("nw", "nw n=8192 tile_rows=16", lambda gen: _nw(gen, 16)),
    # the h100 cell's 8 rows a tile, and 16 (over 1,008 DP rows)
    ("pathfinder", "pathfinder (1001, 100000) tile_rows=8", _pathfinder),
    ("pathfinder", "pathfinder (1009, 100000) tile_rows=16",
     lambda gen: _pathfinder(gen, 16, 1009)),
    # a ring of four: three tiles in flight where the default has one
    ("pathfinder", "pathfinder depth=4 (1001, 100000) tile_rows=8",
     lambda gen: _pathfinder(gen, depth=4))]

#: libraries whose BASE side runs through BASE's own wrapper module (its C
#: interface may differ from here's), with a ``busy`` line after each
#: time line under ``--busy``; their case's call takes (spec, module).
#: By library, what the busy line counts: the device events whose name
#: holds this ("": every kernel of the call, hotspot's BASE's edge pad
#: with its kernel)
OWN_WRAPPER = {"pathfinder": "pathfinder_", "hotspot": "",
               "flash_attention": "flash_", "matmul": "matmul_",
               "flash_attention_bwd": "fa_bwd"}

#: the wrapper module of a library whose name is not its module's
WRAPPER_MODULE = {"flash_attention_bwd": "flash_attention"}

#: libraries whose launches take no strategy: their cases are timed once
STRATEGY_FREE = {"flash_attention_bwd"}

#: cases shorter than the host's time to launch them, by the name of the
#: kernel whose device time (torch.profiler, as ``ONCE``) is theirs; their
#: library calls are timed the same way
BUSY = {_FIRST: "lud_internal_kernel", _FIRST_PAIR: "lud_internal_kernel"}

#: (library, case, maker): maker(generator) -> [(label, call(), the
#: PyTorch calls of the same function)], strategy-free, timed once
ONCE: List[Tuple[str, str, Callable]] = [
    ("lud", "lud perimeters n=8192 bs=32", _lud_perimeters)]


def compare_sass(base: Dict[str, List[str]],
                 here: Dict[str, List[str]]) -> Tuple[int, List[str]]:
    """(BASE's functions whose SASS some function here has, the names of
    those it has not)."""
    built = {tuple(v) for v in here.values()}
    differ = [name for name, v in base.items() if tuple(v) not in built]
    return len(base) - len(differ), differ


def _base_module(base: Path, kernel: str):
    """BASE's ``repro_torch.kernels.<kernel>`` module and its PipelineSpec,
    imported as a package of another name, beside this checkout's."""
    name = "_ab_base_repro_torch"
    if name not in sys.modules:
        root = base / "src" / "repro_torch"
        spec = importlib.util.spec_from_file_location(
            name, root / "__init__.py", submodule_search_locations=[str(root)])
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return (importlib.import_module(f"{name}.kernels.{kernel}"),
            importlib.import_module(
                f"{name}.core.async_pipeline").PipelineSpec)


@contextlib.contextmanager
def _base_budget(lib_name: str, base: Optional[Path] = None):
    """Inside the block BASE's flash attention launches with the card's
    whole block of shared memory, and BASE's lud (given the root of a
    checkout, not a variant's copy of csrc/ alone) with the budget of
    BASE's own ``internal_smem`` (see the top)."""
    if lib_name == "flash_attention":
        module, name = flash_attention, "flash_smem"
        budget = lambda spec, d, dtype=None: SMEM_PER_BLOCK     # noqa: E731
    elif lib_name == "lud" and base is not None and \
            (base / "src" / "repro_torch" / "kernels" / "lud.py").exists():
        base_lud, base_spec = _base_module(base, "lud")
        module, name = lud, "internal_smem"

        def budget(spec, k):
            return base_lud.internal_smem(base_spec(
                spec.strategy.value, spec.depth, spec.wait_group,
                spec.out_depth), k)
    else:
        yield
        return
    here = getattr(module, name)
    setattr(module, name, budget)
    try:
        yield
    finally:
        setattr(module, name, here)


def _device_ms(fn) -> float:
    return time_callable(fn, warmup=3, repeats=20).median / 1e3


def _busy_ms(fn, reps: int = 50, attempts: int = 8, name: str = "") -> float:
    """Device time of one call: the summed time of the device events
    torch.profiler saw in ``reps`` calls whose name holds ``name``, over
    ``reps``.  A trace must hold ``reps`` times the most events that
    single-call traces show; one with fewer (the profiler loses device
    activity now and then) is taken again.  A trace opens and closes with
    a marker, a ``torch.cuda._sleep`` kernel (ATen's ``spin_kernel``) left
    out of the count, 2 ms of idle card on each side (the profiler has
    lost one kernel of every trace, the only one of a one-kernel call's)."""
    return _kernels_of(fn, reps, attempts, name)[0]


def _kernels_of(fn, reps: int = 50, attempts: int = 8,
                name: str = "") -> Tuple[float, int]:
    """(``_busy_ms``, the device events a call: the most that single-call
    traces show)."""
    from torch.profiler import ProfilerActivity, profile

    def marker():
        torch.cuda.synchronize()
        time.sleep(0.002)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.002)

    def trace(calls):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            marker()
            for _ in range(calls):
                fn()
            marker()
        return [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and name in e.name and "spin_kernel" not in e.name]

    fn()
    torch.cuda.synchronize()
    per_call = max(len(trace(1)) for _ in range(3))
    want = reps * per_call
    seen = []
    for _ in range(attempts):
        seen = trace(reps)
        if seen and len(seen) >= want:
            return sum(seen) / reps, per_call
    raise RuntimeError(f"torch.profiler saw {len(seen)} device events in "
                       f"{reps} calls, not {want}")


def _card_during(fn):
    """``fn()``'s result, and what ``nvidia-smi`` reads of the first card
    while it runs: (median SM clock MHz, highest power draw W), or None
    without nvidia-smi or a reading."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return fn(), None
    reads, done = [], threading.Event()

    def poll():
        while not done.is_set():
            out = subprocess.run([smi, "--query-gpu=clocks.sm,power.draw",
                                  "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True, timeout=30)
            try:
                clock, power = out.stdout.splitlines()[0].split(",")
                reads.append((float(clock), float(power)))
            except (IndexError, ValueError):
                pass
            done.wait(0.05)

    poller = threading.Thread(target=poll)
    poller.start()
    try:
        result = fn()
    finally:
        done.set()
        poller.join()
    if not reads:
        return result, None
    return result, (statistics.median(c for c, _ in reads),
                    max(w for _, w in reads))


def _turns(label: str, lib_name: str, base_lib, measure, library_ms,
           base: Optional[Path] = None, base_measure=None,
           rounds: int = 1) -> str:
    """The time line of ``measure()`` (ms) in turns base, here, here, base,
    ``rounds`` times: base with BASE's library swapped in for ``lib_name``
    (and, given BASE's root, its budget: ``_base_budget``), or, given
    ``base_measure``, that instead (BASE's own wrapper)."""
    times, refused = {"base": [], "here": []}, {}

    def turns():
        for where in ("base", "here", "here", "base") * rounds:
            if where in refused:
                continue
            try:
                if where == "here":
                    times[where].append(measure())
                    continue
                if base_measure is not None:
                    times[where].append(base_measure())
                    continue
                with _build.swapped(lib_name, base_lib), \
                        _base_budget(lib_name, base):
                    times[where].append(measure())
            except (RuntimeError, ValueError, AttributeError) as e:
                refused[where] = f"{type(e).__name__}: {e}"

    _, card = _card_during(turns)
    parts = []
    for where in ("base", "here"):
        if where in refused:
            parts.append(f"{where} {refused[where]}")
        else:
            parts.append(f"{where} " + " ".join(
                f"{t:.4f}" for t in times[where]) + " ms")
    line = f"time {label}: " + ", ".join(parts)
    if not refused:
        b, h = (sum(times[w]) / len(times[w]) for w in ("base", "here"))
        line += f", here/base {h / b:.3f}"
        if rounds > 1:
            each = sorted(sum(times["here"][2 * i:2 * i + 2])
                          / sum(times["base"][2 * i:2 * i + 2])
                          for i in range(rounds))
            wins = sum(h < b for h, b in zip(times["here"], times["base"]))
            q1, _, q3 = statistics.quantiles(times["base"], n=4)
            line += (f" (by round: least {each[0]:.3f}, median "
                     f"{statistics.median(each):.3f}, most {each[-1]:.3f}; "
                     f"medians here {statistics.median(times['here']):.4f}, "
                     f"base {statistics.median(times['base']):.4f}, base's "
                     f"quartiles {q1:.4f}-{q3:.4f}; here faster in {wins} "
                     f"of {len(times['here'])} pairs)")
    if "here" not in refused and library_ms is not None:
        line += (f", here/library "
                 f"{sum(times['here']) / len(times['here']) / library_ms:.3f}")
    if card is not None:
        line += f"; card {card[0]:.0f} MHz, up to {card[1]:.1f} W"
    return line


def _busy_line(label: str, fn, name: str) -> str:
    """One call's kernels from torch.profiler against its CUDA-event time
    (the device's busy share of the call)."""
    try:
        busy, per_call = _kernels_of(fn, reps=20, name=name)
        wall = _device_ms(fn)
    except (RuntimeError, ValueError, AttributeError) as e:
        return f"busy {label}: {type(e).__name__}: {e}"
    return (f"busy {label}: {per_call} kernels a call, {busy:.4f} ms of "
            f"device time in a {wall:.4f} ms call ({busy / wall:.1%})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base", type=Path, help="root of the other checkout")
    ap.add_argument("--only", default="", metavar="SUBSTRING",
                    help="time only the cases whose name holds SUBSTRING")
    ap.add_argument("--busy", action="store_true",
                    help="after each time line of a library of OWN_WRAPPER, "
                         "a busy line a side (torch.profiler)")
    ap.add_argument("--rounds", type=int, default=1, metavar="N",
                    help="the turns base, here, here, base N times a line")
    ap.add_argument("--sass-all", action="store_true",
                    help="compare the SASS of every library, not only of "
                         "the cases --only selects")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    names = sorted({lib for lib, case, _ in CASES + ONCE
                    if args.only in case}
                   | (set(_build.SOURCES) if args.sass_all else set()))
    base_csrc = args.base / "src" / "repro_torch" / "csrc"
    # a library whose source the other checkout lacks is new here
    base_names = [n for n in names if (base_csrc / f"{n}.cu").exists()]
    with ThreadPoolExecutor(2) as pool:
        here_job = pool.submit(_build.build_all, names)
        base_job = pool.submit(_build.build_all, base_names, base_csrc,
                               args.base / "build" / "kernels")
        here, base = here_job.result(), base_job.result()
    for name in names:
        ours = sass.functions(here[name])
        if name not in base:
            print(f"sass {name}: new here ({len(ours)} kernels; the base "
                  f"has no {name}.cu)", flush=True)
            continue
        theirs = sass.functions(base[name])
        same, differ = compare_sass(theirs, ours)
        print(f"sass {name}: {same} of {len(theirs)} base kernels have the "
              f"same SASS here ({len(ours)} kernels here)"
              + (f"; differ: {', '.join(differ)}" if differ else ""),
              flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for lib_name, case, maker in CASES:
        if args.only not in case:
            continue
        call, library = maker(gen)
        kernel = BUSY.get(case)
        library_ms = None
        if library is not None:
            library_ms, card = _card_during(
                lambda: _device_ms(library) if kernel is None
                else _busy_ms(library))
            print(f"time {case} library: {library_ms:.4f} ms" + (
                f"; card {card[0]:.0f} MHz, up to {card[1]:.1f} W" if card
                else ""), flush=True)
        base_lib = _build.load(base[lib_name], lib_name, missing_ok=True)
        own = None
        module = WRAPPER_MODULE.get(lib_name, lib_name)
        if lib_name in OWN_WRAPPER and (
                args.base / "src" / "repro_torch" / "kernels"
                / f"{module}.py").exists():
            own = _base_module(args.base, module)
        for s in [None] if lib_name in STRATEGY_FREE else Strategy:
            spec = PipelineSpec() if s is None else PipelineSpec(s)
            base_call = None
            if own is not None:
                bspec = own[1](spec.strategy.value, spec.depth,
                               spec.wait_group, spec.out_depth)
                base_call = (lambda bspec=bspec: call(bspec, own[0]))
            label = case if s is None else f"{case} {s.value}"
            print(_turns(label, lib_name, base_lib,
                         lambda spec=spec: _device_ms(lambda: call(spec))
                         if kernel is None else
                         _busy_ms(lambda: call(spec), name=kernel),
                         library_ms, args.base,
                         None if base_call is None else
                         (lambda f=base_call: _device_ms(f)), args.rounds),
                  flush=True)
            if base_call is not None and args.busy:
                kname = OWN_WRAPPER[lib_name]
                for where, fn in (("base", base_call),
                                  ("here", lambda spec=spec: call(spec))):
                    print(_busy_line(f"{label} {where}", fn, kname),
                          flush=True)
    for lib_name, case, maker in ONCE:
        if args.only not in case:
            continue
        base_lib = _build.load(base[lib_name], lib_name, missing_ok=True)
        for label, call, library in maker(gen):
            library_ms, card = _card_during(lambda: _busy_ms(library))
            print(f"time {case} {label} library: {library_ms:.4f} ms" + (
                f"; card {card[0]:.0f} MHz, up to {card[1]:.1f} W" if card
                else ""), flush=True)
            print(_turns(f"{case} {label}", lib_name, base_lib,
                         lambda: _busy_ms(call, name="lud_perimeter"),
                         library_ms, args.base), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
