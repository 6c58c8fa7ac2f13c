#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py [--out DIR]

Phases, each reported on its own lines:

  1. the card's name and power limit (nvidia-smi), then one nvcc per CUDA
     source, all started together, and the build time, with each f32
     matmul and flash attention kernel's registers and spills from ptxas;
     then cuobjdump -sass of the hotspot, matmul, lud, nw, pathfinder and
     flash attention libraries: the count of HGMMA (wgmma), HMMA (mma.sync),
     UTMALDG (a tensor-map TMA load), UBLKCP (a 1-D bulk copy), FFMA, LDS,
     STL/LDL (local memory: spills), MUFU.RCP (a reciprocal) and LDG in
     each kernel instantiation.  It fails if cuobjdump is missing, if a
     bf16 matmul kernel has no HGMMA, if a flash attention kernel has no
     HMMA, if a hotspot, f32 matmul, flash attention, lud_internal (K = bs)
     or pathfinder kernel other than DROP_OFF's, any nw kernel or the lud
     perimeter kernel uses local memory, if the lud
     perimeter kernel (both solves) has bs MUFU.RCP or more (a division a
     step of the column solve), or if a TMA kernel of the matmul (bf16 or f32),
     lud_internal or lud_internal_panel has no UTMALDG;
  2. every kernel x strategy held against its plain torch version on the
     card, at the parity shapes and at the h100/* shapes, at ring depths
     2/3/4, wait_group 0 and None, and out_depth 1/2/4 (pathfinder, which
     has no out ring, skips the out_depth variants; hotspot also at widths
     1, 3, 4, 126, 128, 255, 256, 257, 260, 300 and 513, grids 1-3,
     tile_rows 1, 2, 8 and 16 (where DROP_OFF must raise ValueError) and
     iters 1-3, then 8 calls a strategy at (8192, 8192), each equal to the
     first; pathfinder and nw also
     at ragged sizes, and both must equal their plain versions exactly;
     pathfinder also where rows - 1 is no multiple of its 32-row step and
     where a block walks two or more spans, at tile_rows 32, where DROP_OFF
     must raise ValueError, and 8 calls a strategy at (1001, 100000), each
     equal to the first and to the plain version;
     nw also across many strips at tile_rows 4 and 64, where the specs
     the card refuses (DROP_OFF above 16 rows, a ring past the shared
     memory) must raise ValueError, and 8 calls a strategy at n = 8192,
     each equal to the first and to the plain version;
     lud: the whole
     factorisation and lud_internal at n = 64 (bs 16, 32), 128, 192 (a
     ragged last tile and panel), 256 (bs 64), 320 (bs 16), internal also
     at n = 8192: each at the first sub-step's one or two updates, the
     shapes the schedule gives it (at n = 8192, (8160, 96) and (96,
     8064)); lud_internal_panel, the trailing update, at the first panel
     of n = 8192, (8064, 8064, 128), and at a ragged (200, 196, 128); the
     diagonal at the first step of n = 8192; the perimeter solves (each
     alone, and both in one launch) at every step of n = 320 and the first
     and last three steps of n = 8192, at bs 16, 32 and 64, then 8 calls
     of each at n = 8192's first step, each equal to the first; the whole
     lud at n = 8192 at each strategy's depth 2, against the plain panel
     schedule; the K = bs update as the schedule launches it, both regions
     of a sub-step in one launch, at every sub-step of n = 192 (a ragged
     panel) and n = 320 and the first and last three of n = 8192, at bs
     16, 32 and 64, then 8 calls a strategy at n = 8192's first sub-step,
     each equal to the first);
     then the lud check at n = 8192 on a sound LU and on two planted
     faults of the trailing update; matmul (f32 and bf16) and flash
     attention (f32: causal, non-causal, window 256, GQA 12/2 and 8/1, a
     batch, D 64 and 128) at the reference's test shapes and the h100/*
     shapes, at every spec but the out_depth variants (neither has an out
     ring); then their checks at the h100/* shapes on the kernels' results
     and on planted faults (a K tile, a KV tile skipped); then 8 flash
     attention calls a strategy at the h100 shape, each equal to the
     first; flash attention also in bf16 at every case, spec and stress
     call above (the model path's type, against the plain version of the
     same bf16 inputs at 2e-5);
  3. each kernel's time (median of 5 batches of 20 back-to-back calls)
     at the h100/* shape (lud: each kernel at its first step of n = 8192,
     bs = 32, lud_internal as the first sub-step's two updates, a launch
     each and both in one launch, the trailing update at the first panel,
     and the whole factorisation beside lu_factor; matmul also in f32;
     then the K = bs updates of a whole lud call: their bytes and, as
     addmm, their device time) beside its
     bound (bf16 matmul at the bf16 tensor-core rate; f32 flash
     attention's three TF32 products at the TF32 rate, with its FFMA floor
     and the floor at the TF32 rate a probe kernel of mma.sync reaches;
     bf16 flash attention's function at the bf16 rate, Q.K^T one bf16
     product and P.V three, with this design's two TF32 products each
     beside it), its plain
     version's time and one PyTorch call for the same function where there
     is one; the strategy-free lud kernels (the diagonal, each perimeter
     solve, both in one launch), too short for the host
     to keep up with, are timed by their device time per call from
     torch.profiler (their plain versions and library calls likewise); then
     at the parity shapes; hotspot's bytes as its copies request them
     against the bound; one nw and one pathfinder call alone as the main
     path times them, beside the wrapper's host time; then where one lud,
     one hotspot, one nw and one pathfinder call's device time goes, by
     kernel and gap, from torch.profiler (hotspot, nw and pathfinder: the
     one kernel, the other device work (none for hotspot) and the gaps; a
     profile that fails fails the run);
  4. the main path: repro_torch.bench.runner.run_scenarios over the h100/*
     cells of each strategy (stream at iters 1 and 32), and the h100/matmul
     cell in f32, with the kernels' launch counters set to 0 just before
     and read just after (each must equal the calls of the cells times the
     launches of one call: stream's, pathfinder's, nw's, the bf16 matmul's
     and flash attention's one a call, hotspot's one a step, the f32
     matmul's its launch plan, lud's lud_launches);
  5. the analysis path: repro_torch.bench.cli sweep --tag regime (the 49
     regime cells at the h100 shapes, each checked, timed and projected on
     the 16 catalog chips, and one regime verdict a kernel, printed beside
     the card line), with the launch counters set to 0 just before and read
     just after; obs.cli compare of its report against itself (every cell
     "pass", exit 0) and against a copy with one cell twice as slow (that
     cell "regress", exit 1); bench.cli lineage (0 "over", 0 "under");
     the phase's seconds;
  6. the autotuner: repro_torch.tuning on each kernel's tuned/<kernel>
     cell (its h100 cell's shape and dtype; stream at iters 4), into a
     registry in --out: a line a kernel with the candidates, those pruned
     by the card, by break-even and as dominated, the winner and its time,
     the seed config's time and the speedup over it, and the winner's rank
     by predicted time; then an exhaustive search of every candidate the
     card takes, whether the pruning dropped its winner and the range of
     measured / predicted; a second tune of each, which must be a cache
     hit with no launch; each candidate the card refuses, called once,
     which must raise ValueError before any launch; and the seven tuned/*
     cells through bench.runner with that registry (config_source "tuned",
     check_ok, launches = calls x its config's launches a call), beside
     phase 4's cell of the same strategy; the phase's seconds.  Phases 4
     and 5 never read a registry (use_tuned=False, --no-tuned);
  7. the model path: qwen2-1.5b at full width (28 layers, d_model 1536,
     12 q heads over 2 kv heads of 128, d_ff 8960, vocab 151936, weights
     from a seeded generator) through the model's entry points with
     attention="flash", the launch counters set to 0 just before and read
     just after: its parameter count against param_count(); a prefill of
     4 prompts of 512 at each strategy's bf16 flash kernel (28 launches
     each) and one of 300, held against attention="chunked"; 32 greedy
     decode steps, 4 of them held against forward over the whole
     sequence; the prompts through prefill_chunk and 8 decode_paged steps,
     held against the dense-cache path (all within MODEL_ATOL, 0.12, and
     relative l2 MODEL_REL_L2, 0.04: bf16 at 28 layers, see their note);
     whether prefill chunks of 64 and 128 write bit-identical rows, and
     which of layer 0's products gives a row another value at M = 64 than
     at 128 (reported, not failed); prefill, decode and paged decode times
     beside their bounds, and the flash kernel's share of a prefill from
     torch.profiler; then, after the counters are read: layer 0's flash
     call at S = 512 and 300 (384 padded) against the plain version on the
     model's own q, k, v at 2e-5; two planted faults in layer 0's call
     (window 1, causal off), each of which the logits check must reject;
     and Model.loss under autograd, which must raise ValueError before any
     launch (the kernel has no backward pass);
  8. a {"kernels": [...]} line, the card line, and the last line
     {"ok": true, "device": {...}}.

Any failed phase exits non-zero before the last line.  With no CUDA device,
or without the repository's src/ beside it, it exits 1 and prints no result.
--out DIR also writes the main path's schema-v2 report, the build logs,
the analysis phase's files (sweep_regime.json and .log, the compare
verdicts, lineage.json) and the tuning registries (tuning_registry_torch
.json, the exhaustive search's tuning_all.json) there; without it those
phases write them to a temporary directory, never the working directory.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

#: H100 SXM HBM3 rate (NVIDIA data sheet), the bytes bound of every kernel
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM float32 rate outside the tensor cores (data sheet; the
#: catalog's 66.91 TFLOP/s in repro_torch.core.hardware), the operations
#: bound
F32_OPS_PER_S = 66.91e12
#: H100 SXM dense bf16 tensor-core rate (data sheet), the bf16 matmul's
#: operations bound
BF16_TC_OPS_PER_S = 989e12
#: H100 SXM dense TF32 tensor-core rate (data sheet) and the TF32 products
#: flash attention runs for each f32 product (3xTF32: lo hi, hi lo, hi hi):
#: its operations bound is FLASH_TF32_PRODUCTS x its operations at this rate
TF32_TC_OPS_PER_S = 495e12
FLASH_TF32_PRODUCTS = 3
#: the TF32 products of the bf16 kernel: a bf16 K or V value is exact in
#: TF32, so its split's lo term is 0 (lo hi and hi hi remain)
FLASH_BF16_TF32_PRODUCTS = 2
#: the bf16 products that give bf16 flash attention's f32 products, the
#: function's bound: Q.K^T is one (the product of two bf16 values is exact
#: in f32, accumulated in f32, the scale applied to S after), P.V three (P
#: in f32 split into three bf16 parts of 8 significand bits each)
FLASH_BF16_QK_PRODUCTS, FLASH_BF16_PV_PRODUCTS = 1, 3
#: independent mma.sync steps a warp of the rate probe (kRateChains in
#: csrc/flash_attention.cu), and its loop count
MMA_RATE_CHAINS, MMA_RATE_ITERS = 8, 20000
#: seconds the card idles beside each marker of a torch.profiler trace,
#: and the name of the marker's kernel (``torch.cuda._sleep``'s, ATen's
#: ``spin_kernel``), left out of the trace's events
PROFILE_PAD_S = 0.002
PROFILE_MARKER = "spin_kernel"

#: trials of each cell in the analysis phase's sweep (bench.cli's default)
SWEEP_REPEATS = 5

FAILURES = []
#: trace markers torch.profiler lost, of those launched (device_events)
MARKERS_LOST = [0, 0]

#: the TPU kernel each kernel replaces, and the source that replaces it
SOURCES = {"stream": ("src/repro_torch/csrc/stream.cu",
                      "src/repro/kernels/stream.py:62"),
           "hotspot": ("src/repro_torch/csrc/hotspot.cu",
                       "src/repro/kernels/hotspot.py:68"),
           "pathfinder": ("src/repro_torch/csrc/pathfinder.cu",
                          "src/repro/kernels/pathfinder.py:57"),
           "nw": ("src/repro_torch/csrc/nw.cu", "src/repro/kernels/nw.py:89"),
           "matmul": ("src/repro_torch/csrc/matmul.cu",
                      "src/repro/kernels/matmul.py:63"),
           "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention.py:107")}
SOURCES["matmul-f32"] = SOURCES["matmul"]
SOURCES["flash_attention-bf16"] = SOURCES["flash_attention"]
LUD_REPLACES = {"lud_diagonal": "src/repro/kernels/lud.py:43",
                "lud_perimeter_row": "src/repro/kernels/lud.py:65",
                "lud_perimeter_col": "src/repro/kernels/lud.py:96",
                # both solves in one launch: the row (:65) and column solve
                "lud_perimeters": "src/repro/kernels/lud.py:96",
                "lud_internal": "src/repro/kernels/lud.py:152",
                # both regions of a sub-step in one launch of lud_internal
                "lud_internal_pair": "src/repro/kernels/lud.py:152",
                "lud_internal_panel": "src/repro/kernels/lud.py:152"}


def fail(msg: str) -> None:
    """Report a failed phase on both streams (a caller that keeps only the
    end of standard error still sees why the run failed)."""
    print(f"FAIL {msg}", flush=True)
    print(f"FAIL {msg}", file=sys.stderr, flush=True)
    FAILURES.append(msg)


def smi_line() -> str:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi not found"
    out = subprocess.run([smi, "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi failed: {out.stderr.strip()}"


#: SASS mnemonics the instruction phase counts
SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "UBLKCP", "FFMA", "LDS", "STL",
            "LDL", "MUFU.RCP", "LDG")


def sass_counts(path) -> dict:
    """{kernel instantiation: {mnemonic: count}} of one built library, from
    ``cuobjdump -sass``; raises RuntimeError without cuobjdump."""
    from repro_torch.bench import sass
    pattern = re.compile(rf"\b({'|'.join(map(re.escape, SASS_OPS))})\b")
    counts = {}
    for fn, instructions in sass.functions(path).items():
        counts[fn] = dict.fromkeys(SASS_OPS, 0)
        for text in instructions:
            for op in pattern.findall(text):
                counts[fn][op] += 1
    return counts


def kernel_label(fn: str):
    """``matmul_f32_kernel<2,1,0,256>`` and its template arguments for a
    mangled hotspot, matmul, lud, nw, pathfinder or flash attention kernel
    name; (None, None) for another."""
    m = re.search(r"((?:matmul|lud|pathfinder)_\w*?_kernel|nw_kernel|"
                  r"hotspot_kernel|flash_kernel)I((?:Li\d+E)+)", fn)
    if m is None:
        return None, None
    targs = [int(t) for t in re.findall(r"Li(\d+)E", m.group(2))]
    return f"{m.group(1)}<{','.join(map(str, targs))}>", targs


def check_sass(libs) -> None:
    """The instruction phase: print each hotspot, matmul, lud, nw,
    pathfinder and flash attention kernel's counts and fail a bf16 matmul
    kernel without HGMMA; a flash attention kernel without HMMA; a bf16 or
    f32 matmul, lud_internal or lud_internal_panel TMA kernel without
    UTMALDG; a hotspot, f32 matmul, flash attention, lud_internal or
    pathfinder kernel other than DROP_OFF's, an nw kernel or
    the lud perimeter kernel with local memory (STL or LDL: a spill, or the
    row loop's arrays); and a perimeter kernel with a division in each of the
    column solve's bs steps (bs MUFU.RCP or more: the design takes bs
    reciprocals once a block and multiplies)."""
    tma, drop_off = 4, 3             # StrategyCode in async_pipeline.cuh
    seen = {"matmul_bf16_kernel": 0, "matmul_f32_kernel": 0, "tma": 0,
            "nw_kernel": 0, "flash_kernel": 0, "perimeter": 0,
            "pathfinder_spans_kernel": 0, "hotspot_kernel": 0}
    for name in ("hotspot", "matmul", "lud", "nw", "pathfinder",
                 "flash_attention"):
        try:
            counts = sass_counts(libs[name])
        except (RuntimeError, OSError, subprocess.SubprocessError) as e:
            fail(f"sass {name}: {e}")
            continue
        for fn, n in sorted(counts.items()):
            label, targs = kernel_label(fn)
            print(f"sass {name} {label or fn}: " + " ".join(
                f"{op} {n[op]}" for op in SASS_OPS), flush=True)
            if label is None:
                continue
            kernel = label.split("<")[0]
            # flash_kernel<D, S, A, O>; the others start with S
            strategy = targs[1] if kernel == "flash_kernel" else targs[0]
            if kernel in seen:
                seen[kernel] += 1
            if kernel == "matmul_bf16_kernel" and n["HGMMA"] < 1:
                fail(f"sass {label}: no HGMMA (wgmma)")
            if kernel == "flash_kernel" and n["HMMA"] < 1:
                fail(f"sass {label}: no HMMA (mma.sync)")
            if kernel == "lud_perimeters_kernel":
                seen["perimeter"] += 1
                if n["MUFU.RCP"] >= targs[0]:
                    fail(f"sass {label}: {n['MUFU.RCP']} MUFU.RCP, a division "
                         f"in each step of the column solve")
            if (kernel in ("nw_kernel", "lud_perimeters_kernel") or
                    kernel in ("matmul_f32_kernel", "flash_kernel",
                               "lud_internal_kernel",
                               "pathfinder_spans_kernel", "hotspot_kernel")
                    and strategy != drop_off) and n["STL"] + n["LDL"] > 0:
                fail(f"sass {label}: spills (STL {n['STL']}, LDL "
                     f"{n['LDL']})")
            if kernel in ("matmul_bf16_kernel", "matmul_f32_kernel",
                          "lud_internal_kernel",
                          "lud_internal_panel_kernel") and strategy == tma:
                seen["tma"] += 1
                if n["UTMALDG"] < 1:
                    fail(f"sass {label}: no UTMALDG (tensor-map TMA load)")
    # 13 (strategy, ahead) pairs: bf16 13; f32 9 at tile widths 256 and
    # 128, DROP_OFF's 4 at 128; TMA: 3 bf16 and 6 f32 matmul, 12
    # lud_internal, 3 lud_internal_panel; nw 13 at out_depth 1-4; flash
    # 13 at D 64 and 128 in f32 and bf16; the lud perimeter kernel at bs
    # 16, 32, 64;
    # pathfinder 13 (no out ring); hotspot 52 at out_depth 1-4
    if seen != {"matmul_bf16_kernel": 13, "matmul_f32_kernel": 22,
                "tma": 24, "nw_kernel": 52, "flash_kernel": 52,
                "perimeter": 3, "pathfinder_spans_kernel": 13,
                "hotspot_kernel": 52}:
        fail(f"sass: found {seen} kernels, not 13 bf16 and 22 f32 matmul, "
             f"24 TMA, 52 nw and 52 flash attention, 3 lud perimeter, 13 "
             f"pathfinder, 52 hotspot")


def ptxas_kernels(log: str) -> dict:
    """{mangled kernel name: (registers, spill store bytes, spill load
    bytes)} from an ``nvcc -Xptxas -v`` log."""
    found, current = {}, None
    for line in log.splitlines():
        m = re.search(r"entry function '([^']+)'|Function properties for "
                      r"(\S+)", line)
        if m:
            current = m.group(1) or m.group(2)
            found.setdefault(current, [0, 0, 0])
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and current is not None:
            found[current][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            found[current][0] = int(m.group(1))
    return {k: tuple(v) for k, v in found.items()}


def device_ms(fn, reps: int = 20, batches: int = 5, warmup: int = 3) -> float:
    """Median over ``batches`` of the mean device time of one call in a
    batch of ``reps`` back-to-back calls."""
    import statistics
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        means.append(start.elapsed_time(end) / reps)
    return statistics.median(means)


def profile_marker() -> None:
    """A kernel of ``torch.cuda._sleep`` between two idle spans of
    PROFILE_PAD_S: it opens and closes a trace, outside the calls."""
    import torch
    torch.cuda.synchronize()
    time.sleep(PROFILE_PAD_S)
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    time.sleep(PROFILE_PAD_S)


def device_events(fn, reps: int = 1, attempts: int = 8, whole=None):
    """(CUDA-event ms of ``reps`` back-to-back calls, [(name, device ms)]
    of every kernel and copy torch.profiler saw on the card in them), after
    one warm-up call.  torch.profiler loses device activity now and then: a
    trace with none at all, or with a run of a call's kernels missing, while
    the traces before and after it were whole, and in one process it
    lost one kernel of every trace, the only one of a one-kernel call's.
    So each trace opens and closes with a marker, a short
    ``torch.cuda._sleep`` kernel left out of what comes back, and the card
    idles PROFILE_PAD_S beside each marker.  A trace with no device
    activity, or one that ``whole(events)`` rejects (fewer kernels than
    the calls launched), is taken again, up to ``attempts`` times, and the
    last one comes back."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            profile_marker()
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            profile_marker()
        device = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        events = [(e.name, e.time_range.elapsed_us() / 1e3) for e in device
                  if PROFILE_MARKER not in e.name]
        markers = len(device) - len(events)
        MARKERS_LOST[0] += max(0, 2 - markers)
        MARKERS_LOST[1] += 2
        if events and (whole is None or whole(events)):
            break
        if attempt + 1 < attempts:
            print(f"torch.profiler saw {len(events)} device events in {reps} "
                  f"calls and {markers} of the trace's 2 markers, not all "
                  f"they launched; profiling them again", flush=True)
            time.sleep(0.5)
    return start.elapsed_time(end), events


def queued_ms(fn, reps: int = 20) -> float:
    """Device time of one call without torch.profiler: CUDA events around
    ``reps`` calls that the host queued behind a spinning kernel long
    enough to hold the card until all of them are queued, so the card runs
    them back to back whatever the host's time to launch them (the gaps
    the card itself leaves between kernels stay in)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # cycles at 2 GHz, above the H100's highest SM clock: the spin lasts
    # at least twice the host's time to queue the calls, and 1 ms more
    torch.cuda._sleep(int(2e9 * (2 * host_s + 1e-3)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def busy_ms(fn, reps: int = 20, name: str = "", what: str = "") -> float:
    """Device time of one call, the gaps between its kernels left out: the
    summed time of what torch.profiler saw on the card over ``reps``
    calls, over ``reps``; only of the kernels whose name holds ``name``
    where given (a call that restores its input first leaves the copy
    out).  For calls whose kernels are shorter than the host's time to
    launch them, where CUDA events time the host.  A trace must hold every
    kernel the calls launched: ``reps`` times the most that single-call
    traces show.  Where no trace does, a call of one kernel takes the mean
    of the kernels seen, each a whole call; a call with ``name`` empty
    (that one-call traces may show no kernel of), ``queued_ms``; what is
    left fails, named by ``what``."""
    def ours(events):
        return [ms for n_, ms in events if name in n_]

    per_call = max(len(ours(device_events(fn, 1, attempts=1)[1]))
                   for _ in range(3))
    want = reps * per_call
    if want:
        _, events = device_events(fn, reps,
                                  whole=lambda ev: len(ours(ev)) >= want)
        seen = ours(events)
        if len(seen) >= want:
            return sum(seen) / reps
        short = (f"torch.profiler saw {len(seen)} device events"
                 f"{' of ' + name if name else ''} of {what or 'a call'} in "
                 f"{reps} calls, not {want}")
        if per_call == 1 and seen:
            print(f"{short}: the mean of those seen", flush=True)
            return sum(seen) / len(seen)
    else:
        short = (f"torch.profiler saw no device event"
                 f"{' of ' + name if name else ''} in one call of "
                 f"{what or 'this'}")
    if not name:
        print(f"{short}: timed behind a spinning kernel instead", flush=True)
        return queued_ms(fn, reps)
    raise RuntimeError(short)


def profiled(fn, what: str, whole=None):
    """``device_events(fn, whole=whole)``, or None after a ``fail``: a
    profile that raises or sees no device activity fails the run like any
    phase."""
    try:
        wall, events = device_events(fn, whole=whole)
    except Exception as e:
        fail(f"profile {what}: {type(e).__name__}: {e}")
        return None
    if not events:
        fail(f"profile {what}: torch.profiler saw no device activity")
        return None
    return wall, events


def profile_lud(fn, label: str, launches: tuple) -> None:
    """Where one call's device time goes, by lud kernel, from
    torch.profiler's CUDA activity, beside the call's CUDA-event time; the
    device's busy share is the kernels' time over the call's.  The trace
    must hold the call's ``launches`` (``lud.lud_launches``: by kernel, in
    the order of ``lud.LAUNCHES``)."""
    names = ("lud_diagonal", "lud_perimeter_row", "lud_perimeter_col",
             "lud_internal", "lud_internal_panel", "lud_perimeters")

    def kind(name):
        return next((k for k in names if f"{k}_kernel" in name), "other")

    def seen(events):
        kinds = [kind(name) for name, _ in events]
        return tuple(kinds.count(k) for k in names)

    got = profiled(fn, f"lud {label}",
                   whole=lambda events: seen(events) == tuple(launches))
    if got is None:
        return
    wall, events = got
    if seen(events) != tuple(launches):
        fail(f"profile lud {label}: {seen(events)} lud kernels seen by "
             f"kernel, not {tuple(launches)}")
        return
    by, count = {}, {}
    for name, ms in events:
        key = kind(name)
        by[key] = by.get(key, 0.0) + ms
        count[key] = count.get(key, 0) + 1
    busy = sum(by.values())
    parts = ", ".join(f"{k} {by[k]:.3f} ms/{count[k]}" for k in sorted(by))
    print(f"profile lud {label}: call {wall:.3f} ms, kernels {busy:.3f} ms "
          f"(device busy {busy / wall:.1%}): {parts}", flush=True)


def profile_one(fn, kernel: str, label: str, launches: int,
                alone: bool = False) -> None:
    """One call's device time from torch.profiler: its ``launches``
    kernels of ``kernel`` (hotspot: one, the step; nw: one, the strips;
    pathfinder: one, the spans), the other device work (nw: row 0, the
    ticket's zero fill, the edge buffer's NaN fill; pathfinder: the edge
    buffer's zero fill; ``alone``: none, or the run fails) and the
    gaps."""
    name = f"{kernel}_"
    got = profiled(fn, f"{kernel} {label}", whole=lambda events: sum(
        name in n_ for n_, _ in events) == launches)
    if got is None:
        return
    wall, events = got
    kernels = [ms for n_, ms in events if name in n_]
    others = [ms for n_, ms in events if name not in n_]
    if len(kernels) != launches:
        fail(f"profile {kernel} {label}: {len(kernels)} {kernel} kernels "
             f"seen, not {launches}")
        return
    busy, other = sum(kernels), sum(others)
    if alone and others:
        extra = sorted({n_ for n_, _ in events if name not in n_})
        fail(f"profile {kernel} {label}: {len(others)} device ops beside "
             f"the kernel: {extra}")
    print(f"profile {kernel} {label}: call {wall:.3f} ms, {launches} "
          f"{kernel} kernel {busy:.3f} ms, other device work {other:.3f} ms "
          f"in {len(others)} ops, gaps {wall - busy - other:.3f} ms (device "
          f"busy {(busy + other) / wall:.1%}, the kernel "
          f"{busy / wall:.1%})", flush=True)


def alone_ms(call, workspace):
    """One call alone, as the main path's trials time it (CUDA events
    around one call after a synchronise), the host time of the wrapper
    call and of its workspace: each the median of 10 (ms)."""
    import torch
    alone, host, ws = [], [], []
    for _ in range(10):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        call()
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        alone.append(start.elapsed_time(end))
        t0 = time.perf_counter()
        workspace()
        ws.append((time.perf_counter() - t0) * 1e3)
    return sorted(alone)[5], sorted(host)[5], sorted(ws)[5]


def reset_launches() -> None:
    """Set every kernel's launch counter to 0."""
    from repro_torch.kernels import (flash_attention, hotspot, lud, matmul,
                                     nw, pathfinder, stream)
    for mod in (stream, hotspot, pathfinder, nw, flash_attention):
        mod.LAUNCHES = 0
    for k in lud.LAUNCHES:
        lud.LAUNCHES[k] = 0
    matmul.LAUNCHES.update(float32=0, bfloat16=0)


def read_launches() -> dict:
    """Each kernel's launch counter: stream, hotspot, pathfinder, nw,
    lud_<kernel>, matmul (bf16), matmul-f32 and flash_attention."""
    from repro_torch.kernels import (flash_attention, hotspot, lud, matmul,
                                     nw, pathfinder, stream)
    out = {"stream": stream.LAUNCHES, "hotspot": hotspot.LAUNCHES,
           "pathfinder": pathfinder.LAUNCHES, "nw": nw.LAUNCHES,
           "matmul": matmul.LAUNCHES["bfloat16"],
           "matmul-f32": matmul.LAUNCHES["float32"],
           "flash_attention": flash_attention.LAUNCHES}
    out.update((f"lud_{k}", count) for k, count in lud.LAUNCHES.items())
    return out


def launches_per_call(s, n: int, bs: int) -> list:
    """(counter, launches) of one call of an h100/<kernel>/<s> cell for
    hotspot (one a step), pathfinder, nw, the bf16 matmul, flash attention
    (one a call) and each lud kernel (``lud_launches(n, bs)``)."""
    from repro_torch.bench import scenario
    from repro_torch.kernels import lud, nw, pathfinder
    hs_steps = scenario.get_scenario(
        f"h100/hotspot/{s.value}").workload["iters"]
    return [("hotspot", hs_steps),
            ("pathfinder", pathfinder.LAUNCHES_PER_CALL),
            ("nw", nw.LAUNCHES_PER_CALL), ("matmul", 1),
            ("flash_attention", 1),
            *zip((f"lud_{k}" for k in lud.LAUNCHES),
                 lud.lud_launches(n, bs))]


def analysis(out: str, card: str, n: int, bs: int) -> None:
    """Phase 5, the paper's analysis path through its entry points:
    ``bench.cli sweep --tag regime`` (every regime cell measured at the
    h100 shapes, projected on every catalog chip, folded into a verdict a
    kernel), with the launch counters set to 0 just before it and read just
    after; the regression gate (``obs.cli compare``) of its report against
    itself and against a copy with one cell twice as slow; ``bench.cli
    lineage``."""
    from repro_torch.bench import cli as bench_cli
    from repro_torch.bench import scenario
    from repro_torch.bench.results import BenchReport
    from repro_torch.core import hardware
    from repro_torch.core.async_pipeline import Strategy
    from repro_torch.obs import cli as obs_cli
    from repro_torch.obs.compare import cell_noise_us

    t0 = time.perf_counter()
    path = os.path.join(out, "sweep_regime.json")
    cells = scenario.scenarios(tag="regime")
    reset_launches()
    # the CLI prints a row a line, 16 model rows to each measured one: the
    # rows go to a log, its summary lines here
    with open(os.path.join(out, "sweep_regime.log"), "w") as f, \
            contextlib.redirect_stdout(f):
        try:
            rc = bench_cli.main(["sweep", "--tag", "regime", "--repeats",
                                 str(SWEEP_REPEATS), "--no-tuned", "--json",
                                 path])
        except Exception as e:
            rc = f"{type(e).__name__}: {e}"
    counts = read_launches()
    with open(os.path.join(out, "sweep_regime.log")) as f:
        for line in f:
            if line.startswith(("# sweep", "#   regime")):
                print(f"{line.rstrip()} ({card})", flush=True)
    if rc != 0:
        fail(f"bench.cli sweep --tag regime: exit {rc}")
    if not os.path.exists(path):
        return
    report = BenchReport.load(path)
    measured = [r for r in report.results if r.kind == "measured"]
    verdicts = {r.kernel for r in report.results if r.kind == "regime"}
    n_model = sum(r.kind == "model" for r in report.results)
    for r in measured:
        m = r.metrics
        print(f"sweep {r.scenario}: us_median {m['us_median']:.1f} "
              f"check_ok {m.get('check_ok')} max_err "
              f"{m.get('max_err', float('nan')):.3g}", flush=True)
    if sorted(r.scenario for r in measured) != [sc.name for sc in cells]:
        fail(f"sweep: {len(measured)} measured rows, not the {len(cells)} "
             f"regime cells")
    bad = [r.scenario for r in measured
           if r.metrics.get("check_ok") is not True]
    if bad:
        fail(f"sweep: rows without check_ok true: {bad}")
    tuned = [r.scenario for r in measured if "tuned" in r.config_source]
    if tuned:
        fail(f"sweep: rows from the tuning registry: {tuned}")
    if n_model != len(measured) * len(hardware.CATALOG):
        fail(f"sweep: {n_model} model rows, not {len(measured)} x "
             f"{len(hardware.CATALOG)} chips")
    missing = [k for k in scenario.KERNELS if k not in verdicts]
    if missing:
        fail(f"sweep: no regime verdict for {missing}")
    # every call of a regime cell: its kernel's launches of one call
    calls = 1 + SWEEP_REPEATS           # the oracle's (the warmup), trials
    per_cell = {k: sum(sc.kernel == k for sc in cells)
                for k in scenario.KERNELS}
    for k, per_call in (("stream", 1),
                        *launches_per_call(Strategy.SYNC, n, bs)):
        kernel = "lud" if k.startswith("lud_") else k
        want = per_cell[kernel] * calls * per_call
        print(f"sweep regime/{k}: {counts[k]} launches = {per_cell[kernel]} "
              f"cells x {calls} calls x {per_call}", flush=True)
        if counts[k] != want:
            fail(f"sweep: {k} launched {counts[k]} kernels, not {want}")

    # the regression gate: the report against itself, then against a copy
    # with one cell (the least noisy, so its band is narrowest) twice as slow
    def compare(new_path, tag):
        verdict_path = os.path.join(out, f"compare_{tag}.json")
        rc = obs_cli.main(["compare", path, new_path, "--json",
                           verdict_path])
        with open(verdict_path) as f:
            return rc, json.load(f)
    rc, doc = compare(path, "self")
    if rc != 0 or doc["counts"]["pass"] != len(measured) or \
            len(doc["rows"]) != len(measured):
        fail(f"compare of the sweep against itself: exit {rc}, "
             f"{doc['counts']}")
    slow = min(measured, key=lambda r: cell_noise_us(r.metrics)
               / r.metrics["us_median"])
    with open(path) as f:
        planted = json.load(f)
    for row in planted["rows"]:
        if row["kind"] == "measured" and row["scenario"] == slow.scenario:
            row["metrics"]["us_median"] *= 2
            row["metrics"]["times_us"] = [2 * t for t in
                                          row["metrics"]["times_us"]]
    planted_path = os.path.join(out, "sweep_regime_planted.json")
    with open(planted_path, "w") as f:
        json.dump(planted, f)
    rc, doc = compare(planted_path, "planted")
    regress = [v["scenario"] for v in doc["rows"] if v["verdict"] == "regress"]
    print(f"compare planted: {slow.scenario} x2 -> exit {rc}, regress "
          f"{regress}, {doc['counts']}", flush=True)
    if rc != 1 or regress != [slow.scenario] or \
            doc["counts"]["pass"] != len(measured) - 1:
        fail(f"compare with {slow.scenario} planted twice as slow: exit "
             f"{rc}, regress {regress}")

    lineage_path = os.path.join(out, "lineage.json")
    rc = bench_cli.main(["lineage", "--json", lineage_path])
    with open(lineage_path) as f:
        lineage_counts = json.load(f)["counts"]
    if rc != 0 or lineage_counts.get("over") or lineage_counts.get("under"):
        fail(f"bench.cli lineage: exit {rc}, {lineage_counts}")
    print(f"analysis: {time.perf_counter() - t0:.1f} s", flush=True)


def tuning(out: str, card: str, main_us: dict) -> None:
    """Phase 6, the autotuner on the card: each kernel tuned at its
    ``tuned/<kernel>`` cell (its h100 cell's shape, dtype and the tuner's
    workload) into a registry in ``out``; the pruned search against an
    exhaustive one (every candidate the card takes, measured); a second
    tune of each, a cache hit; every candidate the card refuses launched
    once, raising ValueError before any launch; the seven ``tuned/*`` cells
    run through ``bench.runner`` with that registry.  ``main_us``: phase 4's
    ``us_median`` by scenario."""
    import torch
    from repro_torch.bench import runner, scenario
    from repro_torch.kernels import lud
    from repro_torch.tuning import Autotuner, Registry, TuningTask
    from repro_torch.tuning.autotuner import _config_str

    t0 = time.perf_counter()
    path = os.path.join(out, "tuning_registry_torch.json")
    if os.path.exists(path):
        os.remove(path)
    tuner = Autotuner(Registry(path), warmup=1, repeats=5)
    exhaustive = Autotuner(Registry(os.path.join(out, "tuning_all.json")),
                           warmup=1, repeats=5, keep_ratio=float("inf"))
    cells = scenario.scenarios(tag="tuned")
    records = {}

    def rank(meas, config):
        """1 + the measured candidates predicted faster than ``config``."""
        pred = next(m.predicted_us for m in meas if m.config == config)
        return 1 + sum(m.predicted_us < pred for m in meas)

    for sc in cells:
        k = sc.kernel
        task = TuningTask(k, sc.shape, sc.dtype, device="cuda",
                          workload=sc.workload)
        _, dropped = task.space.pruned()
        why = [c.why_pruned.split(":")[0].split(" ")[0] for c in dropped]
        n_all = len(task.space.candidates())
        t1 = time.perf_counter()
        try:
            rec = tuner.tune(task)
        except Exception as e:
            fail(f"tune {k}: {type(e).__name__}: {e}")
            continue
        records[k] = rec
        bad = [m for m in rec.measurements if m.error is not None]
        for m in bad:
            fail(f"tune {k}: candidate {_config_str(m.config)}: {m.error}")
        ok = [m for m in rec.measurements if m.error is None]
        print(f"tune {k} {'x'.join(map(str, sc.shape))} {sc.dtype} "
              f"{sc.workload}: {n_all} candidates, pruned {why.count('card')}"
              f" by the card, {why.count('break-even')} by break-even, "
              f"{why.count('predicted')} dominated; {len(rec.measurements)} "
              f"measured ({len(bad)} errors) in "
              f"{time.perf_counter() - t1:.1f} s; winner "
              f"{_config_str(rec.best)} {rec.best_us:.3f} us, seed "
              f"{rec.default_us:.3f} us, speedup_vs_default "
              f"{rec.speedup_vs_default:.4f}; winner's predicted rank "
              f"{rank(ok, rec.best)} of {len(ok)} ({card})", flush=True)

        # the exhaustive search: keep_ratio inf keeps every candidate past
        # the card and break-even; those past break-even are measured too
        t1 = time.perf_counter()
        try:
            full = exhaustive.tune(task, force=True)
        except Exception as e:
            fail(f"exhaustive tune {k}: {type(e).__name__}: {e}")
            continue
        _, dropped_all = task.space.pruned(float("inf"))
        past = [c for c in dropped_all
                if c.why_pruned.startswith("break-even")]
        args = task.make_args()
        meas = full.measurements + [exhaustive._measure(task, args, c)
                                    for c in past]
        del args
        for m in meas:
            if m.error is not None:
                fail(f"exhaustive {k}: candidate {_config_str(m.config)}: "
                     f"{m.error}")
        ok = [m for m in meas if m.error is None]
        if not ok:
            continue
        winner = min(ok, key=lambda m: m.us_median)
        kept = {_config_str(m.config) for m in rec.measurements}
        # the pruned search's winner as this search measured it
        again = next((m.us_median for m in ok if m.config == rec.best),
                     float("nan"))
        ratio = [m.us_median / m.predicted_us for m in ok]
        rho = spearman([m.predicted_us for m in ok],
                       [m.us_median for m in ok])
        print(f"exhaustive {k}: {len(meas)} measured (every candidate the "
              f"card takes; {len(past)} past break-even) in "
              f"{time.perf_counter() - t1:.1f} s; winner "
              f"{_config_str(winner.config)} {winner.us_median:.3f} us, "
              f"predicted rank {rank(ok, winner.config)} of {len(ok)}; the "
              f"pruned search's winner here {again:.3f} us = "
              f"{again / winner.us_median:.4f}x; pruning dropped the "
              f"measured winner: "
              f"{'yes' if _config_str(winner.config) not in kept else 'no'}"
              f"; measured / predicted {min(ratio):.3f} - {max(ratio):.3f}"
              f"; rank correlation of predicted and measured {rho:.3f} "
              f"({card})", flush=True)

    # a second tune of each kernel: a cache hit, no launch
    for sc in cells:
        if sc.kernel not in records:
            continue
        reset_launches()
        again = tuner.tune(TuningTask(sc.kernel, sc.shape, sc.dtype,
                                      device="cuda", workload=sc.workload))
        torch.cuda.synchronize()
        launched = {k: n for k, n in read_launches().items() if n}
        hit = again.to_dict() == records[sc.kernel].to_dict()
        print(f"tune {sc.kernel} again: cache hit {hit}, launches "
              f"{launched or 0}", flush=True)
        if not hit or launched:
            fail(f"second tune of {sc.kernel}: cache hit {hit}, launches "
                 f"{launched}")

    # every candidate the card refuses raises before any launch
    for sc in cells:
        task = TuningTask(sc.kernel, sc.shape, sc.dtype, device="cuda",
                          workload=sc.workload)
        _, dropped = task.space.pruned()
        refused = [c for c in dropped if c.why_pruned.startswith("card: ")]
        if not refused:
            continue
        args = task.make_args()
        reset_launches()
        raised = 0
        for c in refused:
            try:
                task.call(args, c.config)
            except ValueError:
                raised += 1
            except Exception as e:
                fail(f"refused {sc.kernel} {_config_str(c.config)}: "
                     f"{type(e).__name__}: {e}")
        del args
        torch.cuda.synchronize()
        launched = {k: n for k, n in read_launches().items() if n}
        print(f"card refusals {sc.kernel}: {raised} of {len(refused)} raised "
              f"ValueError, launches {launched or 0}", flush=True)
        if raised != len(refused) or launched:
            fail(f"card refusals {sc.kernel}: {raised} of {len(refused)} "
                 f"raised, launches {launched}")

    # the tuned cells through the runner, with that registry
    opts = runner.RunOptions(device="cuda", repeats=5,
                             registry=Registry(path))
    calls = 1 + max(opts.warmup - 1, 0) + opts.repeats
    reset_launches()
    try:
        report = runner.run_scenarios(cells, opts)
    except Exception as e:
        fail(f"tuned cells: {type(e).__name__}: {e}")
        return
    counts = read_launches()
    want = dict.fromkeys(counts, 0)
    for r in report.results:
        m = r.metrics
        s = r.strategy
        rec = records.get(r.kernel)
        if r.kernel == "lud":
            for k, n in zip(lud.LAUNCHES, lud.lud_launches(
                    r.shape[0], r.config["bs"])):
                want[f"lud_{k}"] += calls * n
        elif r.kernel == "hotspot":     # one launch a step
            want["hotspot"] += calls * \
                scenario.get_scenario(r.scenario).workload["iters"]
        else:                           # one launch a call
            want[r.kernel] += calls
        other = main_us.get(f"h100/{r.kernel}/{s}")
        print(f"tuned {r.scenario}: {r.config_source} {r.tuned_key} "
              f"{_config_str(r.config)} us_median {m['us_median']:.1f} "
              f"(phase 4 h100/{r.kernel}/{s}: "
              f"{'-' if other is None else f'{other:.1f}'}) check_ok "
              f"{m['check_ok']} max_err {m['max_err']:.3g}", flush=True)
        if not m["check_ok"] or r.config_source != "tuned" or \
                rec is None or r.tuned_key != rec.key:
            fail(f"tuned cell {r.scenario}: check_ok {m['check_ok']}, "
                 f"config_source {r.config_source}, key {r.tuned_key}")
    for k, n in counts.items():
        if n != want[k]:
            fail(f"tuned cells: {k} launched {n} kernels, not {want[k]}")
    print(f"tuned cells: launches {({k: n for k, n in counts.items() if n})}"
          f" = {calls} calls a cell x its launches a call", flush=True)
    print(f"tuning: {time.perf_counter() - t0:.1f} s", flush=True)


def fa_name(dtype) -> str:
    """The kernels line's name of flash attention on inputs of ``dtype``."""
    import torch
    return ("flash_attention-bf16" if dtype == torch.bfloat16
            else "flash_attention")


#: the model path: its arch at full width, B prompts of S tokens (and once
#: of a ragged S), NEW greedy tokens (the decode steps held against forward
#: among them), the paged arena's block length, its prefill chunks and its
#: decode steps
MODEL_ARCH = "qwen2-1.5b"
MODEL_B, MODEL_S, MODEL_RAGGED_S, MODEL_NEW = 4, 512, 300, 32
MODEL_CHECK_STEPS = (0, 10, 21, 31)
PAGED_BLOCK, PAGED_CHUNKS, PAGED_NEW = 16, (64, 128), 8
#: the model path's tolerances on the logits: MODEL_ATOL on each value (no
#: rtol) and MODEL_REL_L2 on the whole.  The reference holds its bf16 model
#: path to 6e-2 (tests/test_models.py, decode against forward) at 2 layers
#: of width 32.  At qwen2-1.5b's 28 layers a bf16 rounding flip moves the
#: logits further: two computations of the same rows that differ only in
#: cuBLAS's tiling (prefill chunks of 64 and of 128) differ by up to 0.058
#: on an H100, and every comparison of this phase by up to 0.079 (flash
#: against chunked 0.074, decode against forward 0.075, paged against
#: dense 0.079) at relative l2 0.017-0.020, so 6e-2 fails on rounding
#: alone.  0.12 is 1.5 times the largest difference and 0.04 twice the
#: largest relative l2; the phase shows that planted faults in one layer's
#: attention fail them, and holds layer 0's kernel call to its plain
#: version at 2e-5
MODEL_ATOL, MODEL_REL_L2 = 0.12, 0.04
#: the faults planted in layer 0's flash call, which the check must reject
MODEL_FAULTS = ({"window": 1}, {"causal": False})


def model_path(card: str) -> dict:
    """Phase 7, the model path: qwen2-1.5b at full width on the card
    through the model's entry points, its weights from a seeded generator,
    attention="flash".  The launch counters are set to 0 just before and
    read just after.  Each strategy's bf16 flash kernel prefills B prompts
    of S (28 launches each, one a layer), held against the same model with
    attention="chunked" (the reference's scan in plain torch); a ragged S
    likewise; greedy decode_step for NEW tokens, held at MODEL_CHECK_STEPS
    against forward over the whole sequence (the reference's decode ==
    forward property); the prompts through prefill_chunk (chunks of 64 over
    blocks of 16) and decode_paged for PAGED_NEW tokens, held against the
    dense-cache path; whether chunks of 64 and 128 write bit-identical K/V
    rows and last-row logits (reported, not failed); prefill, decode and
    paged decode times beside their bounds, and the flash kernel's share of
    a prefill from torch.profiler.  Returns (flash_attention-bf16,
    strategy) -> launches."""
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.async_pipeline import Strategy
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import linear
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = get_config(MODEL_ARCH)
    b, s, new = MODEL_B, MODEL_S, MODEL_NEW
    ops.reset_default_configs()
    model = build_model(cfg, attention="flash", device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    chunked = model.with_attention("chunked")
    params = list(model.net.parameters())
    n_params = sum(p.numel() for p in params)
    w_bytes = sum(p.numel() * p.element_size() for p in params)
    # the weights at the compute type: a bf16 copy cached for inference
    # reads these bytes a step, the floor of the bounds below
    w16_bytes = n_params * torch.empty(
        (), dtype=getattr(torch, cfg.dtype)).element_size()
    print(f"model {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} q heads over {cfg.n_kv_heads} kv heads of "
          f"{cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab}: {n_params} "
          f"parameters (param_count() {cfg.param_count()}), {w_bytes} bytes "
          f"in {params[0].dtype}, computing in {cfg.dtype} ({card})",
          flush=True)
    if n_params != cfg.param_count():
        fail(f"model: {n_params} parameters, not param_count() "
             f"{cfg.param_count()}")

    def close(what, got, want, planted=False):
        """Hold logits to MODEL_ATOL and MODEL_REL_L2; with ``planted``
        they come from a planted fault, which the check must reject."""
        got, want = got.float(), want.float()
        err = float((got - want).abs().max())
        rel = float((got - want).norm() / want.norm())
        ok = err <= MODEL_ATOL and rel <= MODEL_REL_L2
        verdict = ("" if ok else " FAILED") if not planted else \
            (" NOT REJECTED" if ok else " rejected")
        print(f"model {what}: max_abs_err {err:.4g} (atol {MODEL_ATOL}), "
              f"relative l2 error {rel:.3g} (at most {MODEL_REL_L2}), "
              f"|logits| <= {float(want.abs().max()):.3g}{verdict}",
              flush=True)
        if ok == planted:
            fail(f"model {what}: max_abs_err {err:.4g}, relative l2 "
                 f"{rel:.3g}" + (", inside the tolerances" if planted else
                                 f", beyond {MODEL_ATOL} or {MODEL_REL_L2}"))

    @contextlib.contextmanager
    def layer0_call(fault=None):
        """ops.flash_attention, the model's route to the kernel, with its
        first call's inputs and output kept (layer 0's) and ``fault`` (a
        dict of keyword arguments) planted in that call only."""
        real, seen = ops.flash_attention, []

        def first(q_, k_, v_, **kw):
            if not seen and fault:
                kw.update(fault)
            out = real(q_, k_, v_, **kw)
            if not seen:
                seen.append((q_, k_, v_, kw, out))
            return out
        ops.flash_attention = first
        try:
            yield seen
        finally:
            ops.flash_attention = real

    def flash_launches(call):
        before = flash_attention.LAUNCHES
        out = call()
        return out, flash_attention.LAUNCHES - before

    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (b, s + new), generator=g, device=dev,
                         dtype=torch.int32)
    prompt = {"tokens": toks[:, :s]}
    # flash launches by strategy: every call after the strategy loop runs
    # the seed config's OVERLAP
    launches = {}
    reset_launches()
    (chunked_logits, _), n = flash_launches(lambda: chunked.prefill(
        prompt, budget=s + new))
    if n:
        fail(f"model: the chunked prefill launched {n} flash kernels")
    dense = None
    for st in Strategy:
        ops.set_default_config("flash_attention", strategy=st)
        (got, state), n = flash_launches(lambda: model.prefill(
            prompt, budget=s + new))
        launches[("flash_attention-bf16", st)] = n
        print(f"model prefill {st.value} B={b} S={s}: {n} flash launches",
              flush=True)
        if n != cfg.n_layers:
            fail(f"model prefill {st.value}: {n} flash launches, not one a "
                 f"layer ({cfg.n_layers})")
        close(f"prefill {st.value}: last-token logits, flash against chunked",
              got, chunked_logits)
        if st is Strategy.OVERLAP:
            dense = (got, state)
    ops.reset_default_configs()          # OVERLAP, the seed config
    ragged = {"tokens": toks[:, :MODEL_RAGGED_S]}
    (got, _), n = flash_launches(lambda: model.prefill(ragged))
    if n != cfg.n_layers:
        fail(f"model prefill S={MODEL_RAGGED_S}: {n} flash launches")
    close(f"prefill S={MODEL_RAGGED_S} ({n} flash launches): flash against "
          f"chunked", got, chunked.prefill(ragged)[0])

    # greedy decode, each step timed by CUDA events (no step synchronises)
    logits, state = dense
    tok = logits.argmax(-1).int()[:, None]
    fed, step_logits, events = [], {}, []
    for t in range(new):
        fed.append(tok)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        logits, state = model.decode_step(state, tok)
        e1.record()
        events.append((e0, e1))
        if t in MODEL_CHECK_STEPS or t < PAGED_NEW:
            step_logits[t] = logits
        tok = logits.argmax(-1).int()[:, None]
    torch.cuda.synchronize()
    decode_ms = statistics.median(a.elapsed_time(z) for a, z in events)
    seq = torch.cat([toks[:, :s]] + fed, dim=1)
    with torch.no_grad():
        full, n = flash_launches(lambda: model.forward({"tokens": seq}))
    if n != cfg.n_layers:
        fail(f"model forward: {n} flash launches, not one a layer")
    for t in MODEL_CHECK_STEPS:
        close(f"decode step {t} against forward over {seq.shape[1]} tokens",
              step_logits[t], full[:, s + t])
    del full

    # the paged arena: each prompt in chunks, then paged decode of the
    # tokens the dense decode was fed
    bl = PAGED_BLOCK
    mb = -(-(s + new) // bl)
    tables = (1 + torch.arange(b * mb, device=dev,
                               dtype=torch.int32)).reshape(b, mb)
    paged = tfm.init_paged_state(cfg, 1 + b * mb, bl, device=dev)
    width = PAGED_CHUNKS[0]
    for row in range(b):
        for start in range(0, s, width):
            last, paged = model.prefill_chunk(
                paged, toks[row:row + 1, start:start + width],
                tables[row:row + 1], start, width)
        close(f"prefill_chunk slot {row} (chunks of {width}, blocks of {bl}) "
              f"against prefill", last, dense[0][row:row + 1])
    events = []
    for t in range(PAGED_NEW):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        got, paged = model.decode_paged(
            paged, fed[t], tables,
            torch.full((b,), s + t, dtype=torch.int32, device=dev))
        e1.record()
        events.append((e0, e1))
        close(f"decode_paged step {t} against decode_step", got,
              step_logits[t])
    paged_ms = statistics.median(a.elapsed_time(z) for a, z in events)
    del paged
    # chunk sizes: one slot prefilled in chunks of 64 and of 128
    runs = []
    for width in PAGED_CHUNKS:
        arena = tfm.init_paged_state(cfg, 1 + mb, bl, device=dev)
        for start in range(0, s, width):
            last, arena = model.prefill_chunk(
                arena, toks[:1, start:start + width], tables[:1], start,
                width)
        runs.append((last, arena))
    (l64, a64), (l128, a128) = runs
    same = [torch.equal(a64.k[i], a128.k[i]) and torch.equal(a64.v[i],
                                                             a128.v[i])
            for i in range(cfg.n_layers)]
    print(f"model chunk sizes {PAGED_CHUNKS[0]} and {PAGED_CHUNKS[1]} on the "
          f"card: K/V rows bit-identical in {sum(same)} of {cfg.n_layers} "
          f"layers (first differing layer "
          f"{same.index(False) if False in same else None}, max |diff| "
          f"{float((a64.k.float() - a128.k.float()).abs().max()):.3g}), "
          f"last-row logits bit-identical {torch.equal(l64, l128)} (max "
          f"|diff| {float((l64 - l128).abs().max()):.3g})", flush=True)
    del runs, a64, a128
    # which of a layer's products gives a row another value at M = 64 than
    # at M = 128 (cuBLAS picks its kernel by the shape)
    layer0, rows = model.net["layers"][0], {}
    for name, p_, width in (
            ("wq", layer0["attn"]["wq"], cfg.d_model),
            ("wk", layer0["attn"]["wk"], cfg.d_model),
            ("wv", layer0["attn"]["wv"], cfg.d_model),
            ("wo", layer0["attn"]["wo"], cfg.n_heads * cfg.head_dim_),
            ("gate", layer0["mlp"]["gate"], cfg.d_model),
            ("up", layer0["mlp"]["up"], cfg.d_model),
            ("down", layer0["mlp"]["down"], cfg.d_ff)):
        x_ = torch.randn(1, 128, width, generator=g, device=dev).bfloat16()
        with torch.no_grad():
            rows[name] = torch.equal(linear(p_, x_)[:, :64],
                                     linear(p_, x_[:, :64]))
    print(f"model rows of a product at M = 64 and M = 128 bit-identical "
          f"(layer 0, bf16): {rows}", flush=True)

    # times beside bounds: the weights read once in the compute type (and,
    # printed beside, as stored, which this port reads today), the K/V rows
    # written (prefill) or read (decode, at the middle step's length), the
    # matmuls, both attention products and the last rows' unembedding at
    # the bf16 tensor-core rate
    d, L, hd = cfg.d_model, cfg.n_layers, cfg.head_dim_
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    mm = L * (2 * d * h * hd + 2 * d * kvh * hd + 3 * d * cfg.d_ff)
    kv_row = 2 * L * kvh * hd * 2
    w_mid = s + new // 2
    works = {
        "prefill": (2 * mm * b * s + 2 * L * b * h * s * s * hd
                    + 2 * b * d * cfg.vocab, w16_bytes + b * s * kv_row),
        "decode": (2 * mm * b + 4 * L * b * h * w_mid * hd
                   + 2 * b * d * cfg.vocab, w16_bytes + b * w_mid * kv_row)}
    works["paged decode"] = works["decode"]
    prefill_ms = device_ms(lambda: model.prefill(prompt), reps=1, batches=5,
                           warmup=1)
    for what, ms in (("prefill", prefill_ms), ("decode", decode_ms),
                     ("paged decode", paged_ms)):
        least, by = bound(*works[what], BF16_TC_OPS_PER_S)
        ops_, bytes_ = works[what]
        stored = bound(ops_, bytes_ - w16_bytes + w_bytes,
                       BF16_TC_OPS_PER_S)[0]
        unit = f"B={b} S={s}" if what == "prefill" else \
            f"ms a step, B={b}, {w_mid} cached rows"
        print(f"model time {what} {unit}: {ms:.4f} ms, bound {least:.4f} ms "
              f"by {by} ({least / ms:.1%} of it; {ops_ / 1e9:.1f} GFLOP, "
              f"{bytes_ / 1e9:.3f} GB with the weights in {cfg.dtype}; "
              f"{stored:.4f} ms with them as stored, {w_bytes / 1e9:.3f} GB "
              f"in {params[0].dtype})", flush=True)
    res = profiled(lambda: model.prefill(prompt), "model prefill",
                   whole=lambda ev: sum("flash_kernel" in n_ for n_, _ in ev)
                   >= cfg.n_layers)
    if res is not None:
        wall, events = res
        flash = [ms for n_, ms in events if "flash_kernel" in n_]
        busy = sum(ms for _, ms in events)
        print(f"model profile prefill B={b} S={s}: call {wall:.3f} ms, "
              f"device busy {busy:.3f} ms in {len(events)} ops, {len(flash)} "
              f"flash kernels {sum(flash):.3f} ms ({sum(flash) / busy:.1%} "
              f"of the busy time, {sum(flash) / wall:.1%} of the call)",
              flush=True)
        by_name = {}
        for n_, ms in events:
            t_, c_ = by_name.get(n_, (0.0, 0))
            by_name[n_] = (t_ + ms, c_ + 1)
        for n_, (t_, c_) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][0])[:8]:
            print(f"model profile prefill op {t_:.3f} ms in {c_}: "
                  f"{n_[:100]}", flush=True)
    counts = read_launches()
    launches[("flash_attention-bf16", Strategy.OVERLAP)] += \
        counts["flash_attention"] - sum(launches.values())
    by_strategy = {st.value: n for (_, st), n in launches.items()}
    print(f"model launches: {({k: n for k, n in counts.items() if n})}; "
          f"flash by strategy {by_strategy}", flush=True)

    # after the counters are read: layer 0's flash call on the model's own
    # q, k, v (B, H, S padded to 128 rows, hd) against its plain version
    for batch_ in (prompt, ragged):
        with layer0_call() as seen:
            model.prefill(batch_)
        q_, k_, v_, kw, out = seen[0]
        plain = flash_attention.flash_attention_plain(
            q_, k_, v_, causal=kw["causal"], window=kw["window"],
            scale=kw["scale"])
        err = float((out - plain).abs().max())
        ok = bool(torch.allclose(out, plain, rtol=2e-5, atol=2e-5))
        print(f"model layer 0 flash S={batch_['tokens'].shape[1]} "
              f"{tuple(q_.shape)} {q_.dtype} causal={kw['causal']} "
              f"window={kw['window']}: max_abs_err {err:.3g} against the "
              f"plain version (rtol and atol 2e-5)"
              f"{'' if ok else ' FAILED'}", flush=True)
        if not ok:
            fail(f"model layer 0 flash S={batch_['tokens'].shape[1]}: "
                 f"max_abs_err {err:.3g} beyond 2e-5")
    # the logits check's power: a fault planted in layer 0's call
    for fault in MODEL_FAULTS:
        with layer0_call(fault):
            got = model.prefill(prompt)[0]
        close(f"prefill with a planted fault, layer 0's flash call at "
              f"{fault}, against chunked", got, chunked_logits, planted=True)
    # no backward pass: Model.loss under autograd raises before any launch
    before, refused = flash_attention.LAUNCHES, None
    with torch.enable_grad():
        try:
            model.loss({"tokens": toks[:, :128], "labels": toks[:, :128]})
        except ValueError as e:
            refused = str(e)
    n = flash_attention.LAUNCHES - before
    print(f"model loss under autograd with attention=\"flash\": "
          f"{'ValueError: ' + refused if refused else 'no error'}; {n} "
          f"flash launches", flush=True)
    if not refused or "backward pass" not in refused or \
            "attention=\"chunked\"" not in refused or n:
        fail("model loss under autograd: flash did not refuse before any "
             "launch")
    print(f"model path: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def spearman(xs, ys) -> float:
    """Spearman's rank correlation of two equally long lists (ties ranked
    in list order)."""
    def ranks(v):
        out = [0] * len(v)
        for r, i in enumerate(sorted(range(len(v)), key=v.__getitem__)):
            out[i] = r
        return out
    n = len(xs)
    if n < 2:
        return float("nan")
    d2 = sum((a - b) ** 2 for a, b in zip(ranks(xs), ranks(ys)))
    return 1 - 6 * d2 / (n * (n * n - 1))


def bound(ops: float, nbytes: float, ops_per_s: float = F32_OPS_PER_S):
    """(least ms, what bounds it): the larger of the operations at
    ``ops_per_s`` (the f32 rate unless given) and the bytes at the HBM
    rate."""
    t_ops = ops / ops_per_s * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def configs():
    """(strategy, depth, wait_group, out_depth) held against the plain
    version: every strategy, depths 2/3/4 at wait_group 0 and None, and
    the write-back ring at out_depth 1 and 4."""
    from repro_torch.core.async_pipeline import Strategy
    out = [(Strategy.SYNC, 1, None, 2), (Strategy.REGISTER_BYPASS, 1, None, 2)]
    for s in (Strategy.OVERLAP, Strategy.DROP_OFF):
        out += [(s, d, wg, 2) for d in (2, 3, 4) for wg in (0, None)]
    out += [(Strategy.TMA, d, None, 2) for d in (2, 3, 4)]
    out += [(s, 3, None, od) for s in Strategy for od in (1, 4)]
    return out


def main() -> int:
    started = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="write the main path's report and build logs here")
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("error: src/repro_torch not found beside chip_smoke.py",
              file=sys.stderr)
        return 1
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("error: no CUDA device; chip_smoke.py runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    from repro_torch.bench import runner, scenario
    from repro_torch.core.async_pipeline import (SMEM_PER_BLOCK, PipelineSpec,
                                                 Strategy)
    from repro_torch.kernels import (_build, flash_attention, hotspot, lud,
                                     matmul, nw, pathfinder, stream)
    if torch.backends.cuda.matmul.allow_tf32:
        print("error: torch.backends.cuda.matmul.allow_tf32 is set; the f32 "
              "oracles and plain versions need full f32 products",
              file=sys.stderr)
        return 1

    dev = torch.device("cuda")
    card = smi_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {len(libs)} libraries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, path in libs.items():
        log = path.with_suffix(".log")
        text = log.read_text() if log.exists() else ""
        regs = [int(line.split("Used ")[1].split(" registers")[0])
                for line in text.splitlines() if "Used " in line
                and " registers" in line]
        spills = [line.strip() for line in text.splitlines()
                  if "spill" in line and " 0 bytes spill stores" not in line]
        print(f"ptxas {name}: {len(regs)} kernels, registers "
              f"{min(regs, default=0)}-{max(regs, default=0)}, "
              f"{len(spills)} with spills", flush=True)
        for fn, (nreg, st, ld) in sorted(ptxas_kernels(text).items()):
            label, _ = kernel_label(fn)
            if label and label.startswith(("matmul_f32_kernel",
                                           "flash_kernel")):
                print(f"ptxas {label}: {nreg} registers, {st} bytes spill "
                      f"stores, {ld} bytes spill loads", flush=True)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            shutil.copy(log, os.path.join(args.out, f"ptxas_{name}.log"))
    t0 = time.perf_counter()
    check_sass(libs)
    print(f"sass: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 2. every kernel x strategy against its plain version -------------
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(shape, dtype=torch.float32, scale=1.0, shift=0.0):
        x = torch.rand(shape, generator=g, device=dev) * scale + shift
        return x.to(dtype)

    stream_cases = [  # (label, shape, tile_rows, n_tiles, iters)
        ("parity", (64, 128), 8, 4, 3), ("parity", (96, 128), 8, 4, 3),
        ("fig3", (256, 256), 16, 8, 32), ("h100", (16384, 4096), 16, 8, 1)]
    # (label, shape, grid, tile_rows, iters): the edge widths (a window
    # cut at round4(C) or at column 0, one column past a tile, a ragged
    # last tile), grids 1-3, tile_rows 1, 2 and 8, iters 1-3 (a step reads
    # the step before's pitched output in place); at tile_rows 16 DROP_OFF
    # must raise ValueError
    hotspot_cases = [
        ("parity", (64, 126), 2, 8, 2), ("parity", (32, 128), 1, 8, 2),
        ("edge", (16, 1), 2, 8, 2), ("edge", (12, 3), 3, 2, 3),
        ("edge", (12, 4), 1, 1, 1), ("edge", (64, 126), 2, 8, 3),
        ("edge", (48, 255), 3, 1, 2), ("edge", (32, 256), 2, 2, 2),
        ("edge", (64, 257), 2, 8, 3), ("edge", (24, 260), 3, 8, 1),
        ("edge", (96, 513), 3, 8, 2), ("edge", (16, 257), 1, 2, 3),
        ("rows", (64, 300), 2, 16, 2),
        ("h100", (8192, 8192), 32, 8, 1)]
    max_err = {}                    # (kernel, strategy) -> err at h100 shape
    n_checks = 0

    def held(what, got, want, rtol=1e-4, atol=1e-5):
        """Hold a kernel to its plain version (f32 sums in another order:
        lud rtol 1e-4 atol 1e-5, matmul and flash attention the reference's
        tolerances); returns max |got - want|."""
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=rtol, atol=atol):
            fail(f"{what}: max_abs_err {err:.3g} beyond rtol {rtol} "
                 f"atol {atol}")
        return err

    def lud_matrix(n):
        return rand((n, n)) + n * torch.eye(n, device=dev)

    def first_substep(n, bs):
        """The (rows, columns) of the K = bs updates of the panel schedule's
        first sub-step: the panel's columns below its first block row, then
        (when the panel does not end the matrix) the panel's rows right of
        it; their L is A[rows, :bs], their U A[:bs, columns]."""
        end = min(lud.PANEL, n)
        parts = [(slice(bs, n), slice(bs, end))]
        if end < n:
            parts.append((slice(bs, end), slice(end, n)))
        return parts

    # lud: per (n, bs) the input, the matrix after step 0's diagonal and
    # perimeters (the plain versions), the first sub-step's internal
    # updates (plain, as (rows, columns, result) of the matrix), and the
    # whole plain factorisation
    lud_cases = []
    for n, bs in ((64, 16), (64, 32), (128, 32), (192, 32), (256, 64),
                  (320, 16), (8192, 32)):
        a = lud_matrix(n)
        step0 = a.clone()
        d = step0[:bs, :bs]
        d.copy_(lud.lud_diagonal_plain(d))
        step0[:bs, bs:] = lud.lud_perimeter_row_plain(d, step0[:bs, bs:])
        step0[bs:, :bs] = lud.lud_perimeter_col_plain(d, step0[bs:, :bs])
        internal = [(rows, cols, lud.lud_internal_plain(
            step0[rows, :bs], step0[:bs, cols], step0[rows, cols]))
            for rows, cols in first_substep(n, bs)]
        whole = lud.lud_plain(a, bs) if n < 8192 else None
        lud_cases.append((n, bs, a, step0, internal, whole))
    # lud_internal_panel, the trailing update (label, matrix, plain), at K
    # = PANEL: at the first panel of n = 8192 in place (L, U and C views of
    # the matrix after the panel's sub-steps, row pitch n), and a ragged
    # (200, 196, 128) laid out the same way (C rows and columns not a
    # multiple of the 128 x 128 tiles)
    p = lud.PANEL
    first = lud_cases[-1][2].clone()
    lud.lud_panel_plain(first, 0, lud_cases[-1][1])
    # the K = bs update in one launch a sub-step, as the schedule runs it
    # (matrix, bs, sub-steps): every sub-step of n = 192 (a ragged last
    # panel) and n = 320, the first and last three of n = 8192
    pair_cases = []
    for m_ in (lud_matrix(192), lud_matrix(320), lud_cases[-1][2]):
        for pbs in lud.CARD_BS:
            subs = lud.internal_substeps(m_.shape[0], pbs)
            pair_cases.append((m_, pbs, subs if m_.shape[0] < 8192 else
                               subs[:3] + subs[-3:]))

    def pair_views(x, n_, c, c1, end):
        """The (L, U, C) of a sub-step's tall region and of its wide one
        (None in the last panel), views of x."""
        return ((x[c1:, c:c1], x[c:c1, c1:end], x[c1:, c1:end]),
                (x[c1:end, c:c1], x[c:c1, end:], x[c1:end, end:])
                if end < n_ else None)

    panel_cases = [(label, m_, lud.lud_internal_plain(
        m_[p:, :p], m_[:p, p:], m_[p:, p:]))
        for label, m_ in (("h100", first), ("ragged", rand((p + 200,
                                                             p + 196))))]
    # pathfinder (label, shape, tile_rows) and nw (label, n, penalty,
    # tile_rows): the parity shapes, the h100 shapes, and ragged sizes (cols
    # not a multiple of the 128-column spans, nor of 4; nw's n not a
    # multiple of its 256-wide strips, nor of 4), each with its plain
    # result; pathfinder also with rows - 1 no multiple of its 32-row step
    # (80, and 100 with a last span of 2 columns), where a block walks two
    # or more spans (400,000 columns), and at tile_rows 32, which DROP_OFF
    # refuses; nw also across many strips at the tile sizes the card takes
    # (2100: 9 strips, ragged, at tile_rows 4; 1536: 6 at 64; 1024: 4 at
    # 16, DROP_OFF's largest)
    pf_cases = []
    for label, shape, tr in (("parity", (33, 128), 8),
                             ("parity", (17, 256), 8),
                             ("ragged", (129, 1000), 8),
                             ("ragged", (65, 1003), 4),
                             ("ragged", (97, 300), 16),
                             ("steps", (81, 2003), 8),
                             ("steps", (101, 130), 4),
                             ("spans", (97, 400000), 16),
                             ("refused", (97, 300), 32),
                             ("h100", (1001, 100000), 8)):
        w = torch.randint(0, 10, shape, generator=g, device=dev,
                          dtype=torch.int32)
        pf_cases.append((label, shape, tr, w, pathfinder.pathfinder_plain(w)))
    nw_cases = []
    for label, n_, pen, tr in (("parity", 32, 10, 8), ("parity", 64, 3, 8),
                               ("ragged", 200, 10, 8), ("ragged", 90, 10, 6),
                               ("ragged", 1000, 3, 8), ("strips", 2100, 10, 4),
                               ("strips", 1536, 3, 64), ("strips", 1024, 10, 16),
                               ("h100", 8192, 10, 8)):
        sc_ = torch.randint(-3, 4, (n_, n_), generator=g, device=dev).float()
        nw_cases.append((label, n_, pen, tr, sc_, nw.nw_plain(sc_, pen)))
    # matmul (label, (M, K, N), dtype, a, b, plain): the reference's test
    # shapes and the smoke cell (N(0, 1)), the h100 cell's shape (U[0, 1),
    # as its make_args) in bf16 and f32; flash attention (label, (b, h,
    # kvh, s, d), causal, window, q, k, v, plain), N(0, 1), b = 0 for
    # (h, s, d) operands
    mm_cases = []
    for label, shape, dtype in (("parity", (128, 256, 128), torch.float32),
                                ("parity", (256, 128, 384), torch.bfloat16),
                                ("parity", (256, 128, 384), torch.float32),
                                ("parity", (256, 256, 256), torch.float32),
                                ("h100", (8192, 1536, 8960), torch.bfloat16),
                                ("h100", (8192, 1536, 8960), torch.float32)):
        m_, k_, n_ = shape
        draw = rand if label == "h100" else (
            lambda s_, dt: torch.randn(s_, generator=g, device=dev).to(dt))
        a_, b_ = draw((m_, k_), dtype), draw((k_, n_), dtype)
        mm_cases.append((label, shape, dtype, a_, b_,
                         matmul.matmul_plain(a_, b_)))
    fa_cases = []
    for label, shape, causal, window in (
            ("parity", (0, 4, 2, 256, 64), True, 0),
            ("parity", (0, 4, 4, 256, 64), False, 0),
            ("parity", (0, 8, 1, 256, 64), True, 256),
            ("parity", (2, 4, 2, 256, 64), True, 0),
            ("gqa", (1, 12, 2, 1024, 128), True, 0),
            ("gqa", (1, 12, 2, 1024, 128), False, 256),
            ("h100", (4, 12, 2, 4096, 128), True, 0)):
        b_, h_, kvh_, s_, d_ = shape
        lead = (b_,) if b_ else ()
        q_ = torch.randn((*lead, h_, s_, d_), generator=g, device=dev)
        k_, v_ = (torch.randn((*lead, kvh_, s_, d_), generator=g, device=dev)
                  for _ in range(2))
        # each case in f32 and in bf16 (the model path's type): the plain
        # version of the bf16 inputs computes in f32 from their exact values
        for q_, k_, v_ in ((q_, k_, v_), (q_.bfloat16(), k_.bfloat16(),
                                          v_.bfloat16())):
            fa_cases.append((label, shape, causal, window, q_, k_, v_,
                             flash_attention.flash_attention_plain(
                                 q_, k_, v_, causal=causal, window=window)))

    def exact(what, got, want):
        """Hold a DP kernel to its plain version exactly (integer values);
        returns max |got - want|."""
        torch.cuda.synchronize()
        if got.shape != want.shape:
            fail(f"{what}: shape {tuple(got.shape)}, not {tuple(want.shape)}")
            return float("inf")
        err = float((got.double() - want.double()).abs().max())
        if not torch.equal(got, want):
            fail(f"{what}: not equal to the plain version (max_abs_err "
                 f"{err:.3g})")
        return err

    for strategy, depth, wg, od in configs():
        spec = PipelineSpec(strategy, depth, wg, od)
        main_spec = (depth, wg, od) in ((2, None, 2), (1, None, 2))
        for label, shape, dtype, a_, b_, want in mm_cases if od == 2 else ():
            tol = 1e-4 if dtype == torch.float32 else 5e-2
            kname = "matmul" if dtype == torch.bfloat16 else "matmul-f32"
            try:
                got = matmul.matmul_cuda(a_, b_, spec=spec)
            except Exception as e:
                fail(f"matmul {spec} {shape} {dtype}: {type(e).__name__}: {e}")
                continue
            err = held(f"matmul {spec} {shape} {dtype}", got, want, rtol=tol,
                       atol=10 * tol)
            n_checks += 1
            if label == "h100" and main_spec:
                max_err[(kname, strategy)] = err
        for label, shape, causal, window, q_, k_, v_, want in \
                fa_cases if od == 2 else ():
            try:
                got = flash_attention.flash_attention_cuda(
                    q_, k_, v_, causal=causal, window=window, spec=spec)
            except Exception as e:
                fail(f"flash_attention {spec} {shape}: {type(e).__name__}: {e}")
                continue
            err = held(f"flash_attention {spec} {shape} {q_.dtype} "
                       f"causal={causal} window={window}", got, want,
                       rtol=2e-5, atol=2e-5)
            n_checks += 1
            if label == "h100" and main_spec:
                max_err[(fa_name(q_.dtype), strategy)] = err
        for label, shape, tr, w, want in pf_cases if od == 2 else ():
            # what the card refuses: DROP_OFF above its register rows
            refused = strategy is Strategy.DROP_OFF and tr > 16
            try:
                got = pathfinder.pathfinder_cuda(w, spec=spec, tile_rows=tr)
            except ValueError as e:
                n_checks += 1
                if not refused:
                    fail(f"pathfinder {spec} {shape} tile_rows={tr}: "
                         f"ValueError: {e}")
                continue
            except Exception as e:
                fail(f"pathfinder {spec} {shape}: {type(e).__name__}: {e}")
                continue
            if refused:
                fail(f"pathfinder {spec} {shape} tile_rows={tr}: ran, where "
                     f"the card should refuse it with ValueError")
            if label in ("spans", "h100") and main_spec:
                smem_pf = pathfinder._smem(spec, tr)
                blocks_pf = pathfinder._blocks(_build.library("pathfinder"),
                                               spec, smem_pf, dev)
                plan_pf = pathfinder.plan(shape[1], blocks_pf,
                                          pathfinder.region_cap(spec, tr),
                                          pathfinder.SPAN_MIN[strategy])
                print(f"pathfinder plan {strategy.value} {shape} tile_rows="
                      f"{tr}: {plan_pf}, {blocks_pf} blocks at {smem_pf} "
                      f"bytes of shared memory", flush=True)
                if label == "spans" and plan_pf.m < 2:
                    fail(f"pathfinder {spec} {shape}: {plan_pf}, not two or "
                         f"more spans a block")
            err = exact(f"pathfinder {spec} {shape} tile_rows={tr}", got, want)
            n_checks += 1
            if label == "h100" and main_spec:
                max_err[("pathfinder", strategy)] = err
        for label, n_, pen, tr, sc_, want in nw_cases:
            # what the card refuses: DROP_OFF above its register rows, a
            # ring and out ring past a block's shared memory
            refused = (strategy is Strategy.DROP_OFF and tr > 16) or \
                nw._smem(spec, tr) > SMEM_PER_BLOCK
            try:
                got = nw.nw_cuda(sc_, pen, spec=spec, tile_rows=tr)
            except ValueError as e:
                n_checks += 1
                if not refused:
                    fail(f"nw {spec} n={n_} tile_rows={tr}: ValueError: {e}")
                continue
            except Exception as e:
                fail(f"nw {spec} n={n_}: {type(e).__name__}: {e}")
                continue
            if refused:
                fail(f"nw {spec} n={n_} tile_rows={tr}: ran, where the card "
                     f"should refuse it with ValueError")
            err = exact(f"nw {spec} n={n_} penalty={pen} tile_rows={tr}", got,
                        want)
            n_checks += 1
            if label == "h100" and main_spec:
                max_err[("nw", strategy)] = err
        for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2e-2)):
            kname = "stream" if dtype == torch.float32 else "stream_bf16"
            for label, shape, tr, nt, iters in stream_cases:
                x = rand(shape, dtype)
                try:
                    got = stream.stream_cuda(x, iters=iters, spec=spec,
                                             tile_rows=tr, n_tiles=nt)
                    torch.cuda.synchronize()
                except Exception as e:      # report and go on to the next
                    fail(f"{kname} {spec} {shape}: {type(e).__name__}: {e}")
                    continue
                want = stream.stream_plain(x, iters)
                err = float((got.float() - want.float()).abs().max())
                n_checks += 1
                if not err <= tol:
                    fail(f"{kname} {spec} {shape}: max_abs_err {err:.3g} > "
                         f"tol {tol}")
                if label == "h100" and (depth, wg, od) in ((2, None, 2),
                                                           (1, None, 2)):
                    max_err[(kname, strategy)] = err
        for label, shape, grid, tr, iters in hotspot_cases:
            temp = rand(shape, scale=100.0, shift=300.0)
            power = rand(shape)
            # what the card refuses: DROP_OFF above its register rows
            refused = strategy is Strategy.DROP_OFF and \
                tr > hotspot.DROP_OFF_ROWS
            try:
                got = hotspot.hotspot_cuda(temp, power, iters=iters, spec=spec,
                                           grid=grid, tile_rows=tr)
                torch.cuda.synchronize()
            except ValueError as e:
                n_checks += 1
                if not refused:
                    fail(f"hotspot {spec} {shape}: ValueError: {e}")
                continue
            except Exception as e:
                fail(f"hotspot {spec} {shape}: {type(e).__name__}: {e}")
                continue
            if refused:
                fail(f"hotspot {spec} {shape} tile_rows={tr}: ran, where the "
                     f"card should refuse it with ValueError")
            want = temp
            for _ in range(iters):
                want = hotspot.hotspot_step_plain(want, power)
            err = float((got - want).abs().max())
            n_checks += 1
            if not torch.allclose(got, want, rtol=1e-5, atol=1e-3) or \
                    tuple(got.shape) != shape:
                fail(f"hotspot {spec} {shape} grid={grid} tile_rows={tr} "
                     f"iters={iters}: max_abs_err {err:.3g} beyond rtol 1e-5 "
                     f"atol 1e-3, or shape {tuple(got.shape)}")
            if label == "h100" and (depth, wg, od) in ((2, None, 2),
                                                       (1, None, 2)):
                max_err[("hotspot", strategy)] = err
        for n, bs, a, step0, internal, whole in lud_cases:
            x = step0.clone()
            try:
                for rows, cols, _ in internal:
                    lud.lud_internal_cuda(x[rows, :bs], x[:bs, cols],
                                          x[rows, cols], spec=spec)
                got = lud.lud_cuda(a, bs=bs, spec=spec) if whole is not None \
                    else None
            except Exception as e:
                fail(f"lud {spec} n={n} bs={bs}: {type(e).__name__}: {e}")
                continue
            err = 0.0
            for rows, cols, want in internal:
                err = max(err, held(
                    f"lud_internal {spec} n={n} bs={bs} (H, W) = "
                    f"{tuple(want.shape)}", x[rows, cols], want))
                n_checks += 1
            if n == 8192 and (depth, wg, od) in ((2, None, 2), (1, None, 2)):
                max_err[("lud_internal", strategy)] = err
            if got is not None:
                held(f"lud {spec} n={n} bs={bs}", got, whole)
                n_checks += 1
        for m_, pbs, subs in pair_cases:
            nm, x = m_.shape[0], m_.clone()
            for c, c1, end in subs:
                tall, wide = pair_views(x, nm, c, c1, end)
                want = lud.lud_internal_pair_plain(tall, wide)
                what = f"lud_internal_pair {spec} n={nm} bs={pbs} c={c}"
                try:
                    lud.lud_internal_pair_cuda(tall, wide, spec=spec)
                except Exception as e:
                    fail(f"{what}: {type(e).__name__}: {e}")
                    break
                err = max(held(f"{what} (H, W) = {tuple(w_.shape)}", r_[2], w_)
                          for r_, w_ in zip((tall, wide), want)
                          if w_ is not None)
                n_checks += 1
                if (nm, pbs, c) == (8192, 32, 0) and main_spec:
                    max_err[("lud_internal_pair", strategy)] = err
        for label, m_, want in panel_cases if od == 2 else ():
            x = m_.clone()
            try:
                lud.lud_internal_cuda(x[p:, :p], x[:p, p:], x[p:, p:],
                                      spec=spec)
            except Exception as e:
                fail(f"lud_internal_panel {spec} {label}: "
                     f"{type(e).__name__}: {e}")
                continue
            err = held(f"lud_internal_panel {spec} {label} (H, W, K) = "
                       f"{tuple(x[p:, p:].shape) + (p,)}", x[p:, p:], want)
            n_checks += 1
            if label == "h100" and main_spec:
                max_err[("lud_internal_panel", strategy)] = err
        print(f"checked {spec}", flush=True)

    # the strategy-free lud kernels, and the whole lud, at n = 8192
    n, bs, a8, step0, _, _ = lud_cases[-1]
    x = a8.clone()
    try:
        lud.lud_diagonal_cuda(x[:bs, :bs])
        max_err[("lud_diagonal", None)] = held(
            "lud_diagonal n=8192", x[:bs, :bs], step0[:bs, :bs])
        n_checks += 1
    except Exception as e:
        fail(f"lud_diagonal n=8192: {type(e).__name__}: {e}")

    # the perimeter solves: the row and the column solve alone and both in
    # one launch, in place on views of one matrix (row pitch n), against
    # the plain versions, at every step's shape of n = 320 and at the first
    # and last three steps of n = 8192, at bs 16, 32 and 64; each step's
    # diagonal block is the plain factor of the input's.  The errors at n =
    # 8192, bs = 32, step 0 (the main path's first launch) are the kernels'
    perimeter_runs = (
        ("lud_perimeter_row", lambda d_, r_, c_: lud.lud_perimeter_row_cuda(
            d_, r_)),
        ("lud_perimeter_col", lambda d_, r_, c_: lud.lud_perimeter_col_cuda(
            d_, c_)),
        ("lud_perimeters", lud.lud_perimeters_cuda))
    a320 = lud_matrix(320)
    for m_, pbs in ((a320, 16), (a320, 32), (a320, 64), (a8, 16), (a8, 32),
                    (a8, 64)):
        nm = m_.shape[0]
        steps = list(range(0, nm - pbs, pbs))
        if nm == n:
            steps = steps[:3] + steps[-3:]
        x = m_.clone()
        for c in steps:
            c1 = c + pbs
            dg = x[c:c1, c:c1]
            dg.copy_(lud.lud_diagonal_plain(m_[c:c1, c:c1]))
            row, col = x[c:c1, c1:], x[c1:, c:c1]
            want = {"lud_perimeter_row": (lud.lud_perimeter_row_plain(
                        dg, m_[c:c1, c1:]),),
                    "lud_perimeter_col": (lud.lud_perimeter_col_plain(
                        dg, m_[c1:, c:c1]),)}
            want["lud_perimeters"] = want["lud_perimeter_row"] + \
                want["lud_perimeter_col"]
            for kname, run in perimeter_runs:
                row.copy_(m_[c:c1, c1:])
                col.copy_(m_[c1:, c:c1])
                try:
                    run(dg, row, col)
                except Exception as e:
                    fail(f"{kname} n={nm} bs={pbs} step {c // pbs}: "
                         f"{type(e).__name__}: {e}")
                    continue
                got = {"lud_perimeter_row": (row,),
                       "lud_perimeter_col": (col,),
                       "lud_perimeters": (row, col)}[kname]
                err = max(held(f"{kname} n={nm} bs={pbs} step {c // pbs} "
                               f"(H = W = {nm - c1})", g_, w_)
                          for g_, w_ in zip(got, want[kname]))
                n_checks += 1
                if (nm, pbs, c) == (n, bs, 0):
                    max_err[(kname, None)] = err
        print(f"lud perimeters n={nm} bs={pbs}: {len(steps)} steps checked",
              flush=True)
    # their stress: 8 calls of each at n = 8192, bs = 32, step 0, each from
    # the same input, each equal to the first
    x = a8.clone()
    dg, row, col = x[:bs, :bs], x[:bs, bs:], x[bs:, :bs]
    dg.copy_(step0[:bs, :bs])
    for kname, run in perimeter_runs:
        got = []
        try:
            for _ in range(8):
                row.copy_(a8[:bs, bs:])
                col.copy_(a8[bs:, :bs])
                run(dg, row, col)
                got.append((row.clone(), col.clone()))
            torch.cuda.synchronize()
        except Exception as e:
            fail(f"{kname} stress: {type(e).__name__}: {e}")
            continue
        bad = [k for k, (r_, c_) in enumerate(got)
               if not (torch.equal(r_, got[0][0]) and
                       torch.equal(c_, got[0][1]))]
        n_checks += len(got)
        print(f"{kname} stress: 8 calls at n={n} bs={bs} step 0, "
              f"{len(got) - len(bad)} equal to the first", flush=True)
        if bad:
            fail(f"{kname} stress: calls {bad} differ")
    # the K = bs update's stress: 8 calls a strategy at n = 8192's first
    # sub-step, each on the same input, each equal to the first
    x = a8.clone()
    tall, wide = pair_views(x, n, *lud.internal_substeps(n, bs)[0])
    for s in Strategy:
        got = []
        try:
            for _ in range(8):
                x.copy_(a8)
                lud.lud_internal_pair_cuda(tall, wide, spec=PipelineSpec(s))
                got.append((tall[2].clone(), wide[2].clone()))
            torch.cuda.synchronize()
        except Exception as e:
            fail(f"lud_internal_pair stress {s.value}: {type(e).__name__}: "
                 f"{e}")
            continue
        bad = [k for k, (t_, w_) in enumerate(got)
               if not (torch.equal(t_, got[0][0]) and
                       torch.equal(w_, got[0][1]))]
        n_checks += len(got)
        print(f"lud_internal_pair stress {s.value}: 8 calls at n={n} bs={bs} "
              f"first sub-step, {len(got) - len(bad)} equal to the first",
              flush=True)
        if bad:
            fail(f"lud_internal_pair stress {s.value}: calls {bad} differ")
    del a320, got
    lud8_plain = lud.lud_plain(a8, bs)
    for s in Strategy:
        spec = PipelineSpec(s, 2 if s in (Strategy.OVERLAP, Strategy.DROP_OFF,
                                          Strategy.TMA) else 1)
        try:
            got = lud.lud_cuda(a8, bs=bs, spec=spec)
        except Exception as e:
            fail(f"lud {spec} n=8192: {type(e).__name__}: {e}")
            continue
        err = held(f"lud {spec} n=8192", got, lud8_plain)
        n_checks += 1
        print(f"lud n=8192 bs=32 {s.value}: max_abs_err {err:.3g} against "
              f"the plain blocked version", flush=True)
    del x, lud8_plain
    # the lud check (bench.scenario.CHECKS) at n = 8192: a sound LU reads
    # far inside CHECK_TOL, a wrong trailing update far beyond it
    sc8, tol = scenario.get_scenario("h100/lud/overlap"), \
        scenario.CHECK_TOL["lud"]
    sound = scenario.check_output(sc8, (a8,), lud.lud_cuda(a8, bs=bs))
    print(f"lud check n=8192: sound {sound:.3g} (limit {tol})", flush=True)
    if not sound <= tol:
        fail(f"lud check n=8192: a sound LU reads {sound:.3g} > {tol}")
    internal_plain = lud.lud_internal_plain
    for label, fault in (("update skipped", lambda l, u, c: c.clone()),
                         ("update added", lambda l, u, c: c + l @ u)):
        lud.lud_internal_plain = fault
        try:
            wrong = scenario.check_output(sc8, (a8,), lud.lud_plain(a8, bs))
        finally:
            lud.lud_internal_plain = internal_plain
        print(f"lud check n=8192: {label} {wrong:.3g}", flush=True)
        if not wrong > tol:
            fail(f"lud check n=8192 passes a wrong LU ({label}): {wrong:.3g}")
    # the matmul and flash attention checks (bench.scenario.CHECKS) at the
    # h100 shapes: the kernels' results read far inside CHECK_TOL, a K tile
    # (matmul) or each q block's first KV tile (flash) skipped far beyond
    mm_a, mm_b = mm_cases[-2][3], mm_cases[-2][4]
    fq, fk, fv = fa_cases[-2][4:7]
    hq, hk, hv = fa_cases[-1][4:7]                    # the same in bf16

    def flash_first_kv_tile_skipped():
        kv_range = flash_attention.kv_range
        flash_attention.kv_range = \
            lambda *a: (kv_range(*a)[0] + 1, kv_range(*a)[1])
        try:
            return flash_attention.flash_attention_plain(fq, fk, fv)
        finally:
            flash_attention.kv_range = kv_range

    for kernel, args_, sound_call, wrong_call in (
            ("matmul", (mm_a, mm_b), lambda: matmul.matmul_cuda(mm_a, mm_b),
             lambda: matmul.matmul_plain(mm_a[:, 128:], mm_b[128:])),
            ("flash_attention", (fq, fk, fv),
             lambda: flash_attention.flash_attention_cuda(fq, fk, fv),
             flash_first_kv_tile_skipped)):
        sc_, tol = scenario.get_scenario(f"h100/{kernel}/overlap"), \
            scenario.CHECK_TOL[kernel]
        try:
            sound = scenario.check_output(sc_, args_, sound_call())
            wrong = scenario.check_output(sc_, args_, wrong_call())
        except Exception as e:
            fail(f"{kernel} check: {type(e).__name__}: {e}")
            continue
        print(f"{kernel} check at the h100 shape: sound {sound:.3g}, a tile "
              f"skipped {wrong:.3g} (limit {tol})", flush=True)
        if not sound <= tol:
            fail(f"{kernel} check: the kernel's result reads {sound:.3g} > "
                 f"{tol}")
        if not wrong > tol:
            fail(f"{kernel} check passes a skipped tile: {wrong:.3g}")
    print(f"parity: {n_checks} checks against the plain versions, "
          f"{len(FAILURES)} failed (stream f32 tol 1e-6, bf16 tol 2e-2, "
          f"hotspot rtol 1e-5 atol 1e-3, lud rtol 1e-4 atol 1e-5, "
          f"pathfinder and nw exact, matmul f32 rtol 1e-4 atol 1e-3 and "
          f"bf16 rtol 5e-2 atol 5e-1, flash attention rtol 2e-5 atol 2e-5)",
          flush=True)
    pf_wall, pf_plain = pf_cases[-1][3], pf_cases[-1][4]
    nw_scores, nw_want = nw_cases[-1][4], nw_cases[-1][5]
    # pathfinder's and nw's stress: 8 calls back to back a strategy at the
    # h100 shape; a race in the hand-off between spans or strips shows as
    # a call that differs
    for s in Strategy:
        try:
            got = [pathfinder.pathfinder_cuda(pf_wall, spec=PipelineSpec(s),
                                              tile_rows=8) for _ in range(8)]
            torch.cuda.synchronize()
        except Exception as e:
            fail(f"pathfinder stress {s.value}: {type(e).__name__}: {e}")
            continue
        bad = [k for k, t in enumerate(got)
               if not (torch.equal(t, got[0]) and torch.equal(t, pf_plain))]
        n_checks += len(got)
        print(f"pathfinder stress {s.value}: 8 calls at "
              f"{tuple(pf_wall.shape)}, {len(got) - len(bad)} equal to the "
              f"first and to the plain version", flush=True)
        if bad:
            fail(f"pathfinder stress {s.value}: calls {bad} differ")
        del got
    for s in Strategy:
        try:
            got = [nw.nw_cuda(nw_scores, 10, spec=PipelineSpec(s), tile_rows=8)
                   for _ in range(8)]
            torch.cuda.synchronize()
        except Exception as e:
            fail(f"nw stress {s.value}: {type(e).__name__}: {e}")
            continue
        bad = [k for k, t in enumerate(got)
               if not (torch.equal(t, got[0]) and torch.equal(t, nw_want))]
        n_checks += len(got)
        print(f"nw stress {s.value}: 8 calls at n={nw_scores.shape[0]}, "
              f"{len(got) - len(bad)} equal to the first and to the plain "
              f"version", flush=True)
        if bad:
            fail(f"nw stress {s.value}: calls {bad} differ")
        del got
    # hotspot's stress: 8 calls back to back a strategy at the h100 shape,
    # each equal to the first (a carry read before its write, or a slot
    # read before its copy landed, shows as a call that differs), the
    # first held to the plain version
    hs_temp = rand((8192, 8192), scale=100.0, shift=300.0)
    hs_power = rand((8192, 8192))
    hs_plain = hotspot.hotspot_step_plain(hs_temp, hs_power)
    for s in Strategy:
        try:
            got = [hotspot.hotspot_step_cuda(hs_temp, hs_power,
                                             spec=PipelineSpec(s), grid=32)
                   for _ in range(8)]
            torch.cuda.synchronize()
        except Exception as e:
            fail(f"hotspot stress {s.value}: {type(e).__name__}: {e}")
            continue
        bad = [k for k, t in enumerate(got) if not torch.equal(t, got[0])]
        err = held(f"hotspot stress {s.value}", got[0], hs_plain, rtol=1e-5,
                   atol=1e-3)
        n_checks += len(got)
        print(f"hotspot stress {s.value}: 8 calls at (8192, 8192), "
              f"{len(got) - len(bad)} equal to the first (max_abs_err "
              f"{err:.3g} against the plain version)", flush=True)
        if bad:
            fail(f"hotspot stress {s.value}: calls {bad} differ")
        del got
    del hs_plain
    # flash attention's stress: 8 calls back to back a strategy at the h100
    # shape, in f32 and in bf16, each equal to the first (mma fragments,
    # the ring and the quad reductions give one result whatever the timing)
    for s, (q_, k_, v_) in ((s, qkv) for s in Strategy
                            for qkv in ((fq, fk, fv), (hq, hk, hv))):
        what = f"{fa_name(q_.dtype)} stress {s.value}"
        try:
            got = [flash_attention.flash_attention_cuda(q_, k_, v_,
                                                        spec=PipelineSpec(s))
                   for _ in range(8)]
            torch.cuda.synchronize()
        except Exception as e:
            fail(f"{what}: {type(e).__name__}: {e}")
            continue
        bad = [k for k, t in enumerate(got) if not torch.equal(t, got[0])]
        n_checks += len(got)
        print(f"{what}: 8 calls at {tuple(q_.shape)}, "
              f"{len(got) - len(bad)} equal to the first", flush=True)
        if bad:
            fail(f"{what}: calls {bad} differ")
        del got
    mm32_a, mm32_b = mm_cases[-1][3], mm_cases[-1][4]
    del pf_cases, nw_cases, mm_cases, fa_cases
    for s in Strategy:
        if ("stream_bf16", s) in max_err:
            print(f"stream bf16 {s.value}: max_abs_err "
                  f"{max_err[('stream_bf16', s)]:.3g} at (16384, 4096)",
                  flush=True)

    # -- 3. time at the h100/* shapes -------------------------------------
    timing = {}
    x = rand((16384, 4096))
    one = torch.ones((), device=dev)
    temp, power = hs_temp, hs_power
    stream_work = (2 * x.numel(), 2 * x.numel() * 4)      # (operations, bytes)
    hotspot_work = (10 * temp.numel(), 3 * temp.numel() * 4)
    stream_plain_ms = device_ms(lambda: stream.stream_plain(x, 1))
    stream_lib_ms = device_ms(lambda: torch.lerp(x, one, 0.5))
    hotspot_plain_ms = device_ms(
        lambda: hotspot.hotspot_step_plain(temp, power))
    for s in Strategy:
        cfg = {**scenario.get_scenario(f"h100/stream/{s.value}").config}
        spec = PipelineSpec(s)
        try:
            ms = device_ms(lambda: stream.stream_cuda(
                x, iters=1, spec=spec, tile_rows=cfg["tile_rows"],
                n_tiles=cfg["n_tiles"]))
            timing[("stream", s)] = (ms, stream_plain_ms, stream_lib_ms,
                                     stream_work)
            ms = device_ms(lambda: hotspot.hotspot_step_cuda(
                temp, power, spec=spec, grid=32))
            timing[("hotspot", s)] = (ms, hotspot_plain_ms, None,
                                      hotspot_work)
        except Exception as e:
            fail(f"timing {s.value}: {type(e).__name__}: {e}")
    # pathfinder (1001, 100000) int32, tile_rows 8: the wall read once and
    # one row written, 3 integer operations a DP cell (at the f32 rate: the
    # data sheet gives no int32 rate; far under the bytes either way); nw
    # n = 8192: the scores read and the (n+1)^2 table written once, 4
    # operations a cell.  No single PyTorch call computes either.
    pf_rows, pf_cols = pf_wall.shape
    pf_work = (3 * (pf_rows - 1) * pf_cols, (pf_rows + 1) * pf_cols * 4)
    n_nw = nw_scores.shape[0]
    nw_work = (4 * n_nw * n_nw, (n_nw * n_nw + (n_nw + 1) ** 2) * 4)
    try:
        pf_plain_ms = device_ms(lambda: pathfinder.pathfinder_plain(pf_wall),
                                reps=2, batches=3, warmup=1)
        nw_plain_ms = device_ms(lambda: nw.nw_plain(nw_scores, 10), reps=1,
                                batches=3, warmup=1)
        for s in Strategy:
            spec = PipelineSpec(s)
            timing[("pathfinder", s)] = (device_ms(
                lambda: pathfinder.pathfinder_cuda(pf_wall, spec=spec,
                                                   tile_rows=8)),
                pf_plain_ms, None, pf_work)
            timing[("nw", s)] = (device_ms(
                lambda: nw.nw_cuda(nw_scores, 10, spec=spec, tile_rows=8),
                reps=5), nw_plain_ms, None, nw_work)
        # one hotspot, one nw and one pathfinder call alone, as the main
        # path's trials time them, with the host time of the wrapper and
        # its workspace (hotspot has none)
        overlap = PipelineSpec(Strategy.OVERLAP)
        pf_plan = pathfinder.plan(pf_cols, pathfinder._blocks(
            _build.library("pathfinder"), overlap,
            pathfinder._smem(overlap, 8), dev),
            pathfinder.region_cap(overlap, 8),
            pathfinder.SPAN_MIN[Strategy.OVERLAP])
        for k, call, ws in (
                ("hotspot", lambda: hotspot.hotspot_step_cuda(
                    temp, power, spec=overlap, grid=32), lambda: None),
                ("nw", lambda: nw.nw_cuda(nw_scores, 10, spec=overlap,
                                          tile_rows=8),
                 lambda: nw.workspace(n_nw, dev)),
                ("pathfinder", lambda: pathfinder.pathfinder_cuda(
                    pf_wall, spec=overlap, tile_rows=8),
                 lambda: pathfinder.workspace(pf_plan, dev))):
            alone, host, ws_ms = alone_ms(call, ws)
            print(f"time {k} overlap one call alone: {alone:.4f} ms (CUDA "
                  f"events, median of 10), the wrapper {host:.4f} ms on the "
                  f"host, its workspace {ws_ms:.4f} ms; back to back "
                  f"{timing[(k, Strategy.OVERLAP)][0]:.4f} ms a call",
                  flush=True)
    except Exception as e:
        fail(f"pathfinder/nw timing: {type(e).__name__}: {e}")
    # matmul (8192, 1536, 8960), the h100 cell's bf16 and the same in f32:
    # 2 M K N operations (bf16 at the tensor-core rate), A and B read and C
    # written once; library: one torch.mm (bf16 with an f32 output where
    # this torch has out_dtype).  Flash attention (4, 12, 2, 4096, 128) f32
    # causal: 4 b h s^2 d / 2 operations (the two products over the causal
    # half), each run as FLASH_TF32_PRODUCTS TF32 products at the TF32
    # tensor-core rate (the FFMA floor of the f32 operations is printed
    # beside), q, k, v read and out written once; library: one
    # scaled_dot_product_attention(is_causal, enable_gqa) in f32.
    m_, k_ = mm_a.shape
    n_ = mm_b.shape[1]
    mm_work = {"matmul": (2 * m_ * k_ * n_, (m_ * k_ + k_ * n_) * 2 + m_ * n_ * 4,
                          BF16_TC_OPS_PER_S),
               "matmul-f32": (2 * m_ * k_ * n_,
                              (m_ * k_ + k_ * n_) * 4 + m_ * n_ * 4)}
    fb, fh, fs, fd = fq.shape
    fa_ops = 2 * fb * fh * fs * fs * fd
    fa_work = (FLASH_TF32_PRODUCTS * fa_ops,
               (2 * fq.numel() + fk.numel() + fv.numel()) * 4,
               TF32_TC_OPS_PER_S)
    # bf16: the function's least work at the bf16 tensor-core rate, Q.K^T
    # as FLASH_BF16_QK_PRODUCTS bf16 products and P.V as the cheaper of
    # FLASH_BF16_PV_PRODUCTS bf16 products and this design's two TF32
    # products (printed beside: FLASH_BF16_TF32_PRODUCTS of each at the TF32
    # rate); q, k, v read in bf16 and out written in f32; library: SDPA in
    # bf16 (bf16 products and a bf16 P, a yardstick only)
    pv_bf16 = min(FLASH_BF16_PV_PRODUCTS, FLASH_BF16_TF32_PRODUCTS
                  * BF16_TC_OPS_PER_S / TF32_TC_OPS_PER_S)
    fa16_work = ((FLASH_BF16_QK_PRODUCTS + pv_bf16) * fa_ops / 2,
                 (hq.numel() + hk.numel() + hv.numel()) * 2 + hq.numel() * 4,
                 BF16_TC_OPS_PER_S)
    fa16_design = bound(FLASH_BF16_TF32_PRODUCTS * fa_ops, fa16_work[1],
                        TF32_TC_OPS_PER_S)[0]
    try:
        try:
            torch.mm(mm_a[:128, :128], mm_b[:128, :128], out_dtype=torch.float32)
            mm16_lib = lambda: torch.mm(mm_a, mm_b, out_dtype=torch.float32)
            lib_note = "bf16 in, f32 out"
        except (TypeError, RuntimeError):
            mm16_lib = lambda: torch.mm(mm_a, mm_b)
            lib_note = "bf16 in, bf16 out (this torch has no out_dtype)"
        mm_lib = {"matmul": device_ms(mm16_lib),
                  "matmul-f32": device_ms(lambda: torch.mm(mm32_a, mm32_b),
                                          reps=5)}
        print(f"library matmul: torch.mm, {lib_note}", flush=True)
        mm_plain = {
            "matmul": device_ms(lambda: matmul.matmul_plain(mm_a, mm_b), reps=5),
            "matmul-f32": device_ms(
                lambda: matmul.matmul_plain(mm32_a, mm32_b), reps=5)}
        fa_plain_ms = device_ms(
            lambda: flash_attention.flash_attention_plain(fq, fk, fv), reps=1,
            batches=3, warmup=1)
        fa_lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
            fq, fk, fv, is_causal=True, enable_gqa=True), reps=5)
        fa16_plain_ms = device_ms(
            lambda: flash_attention.flash_attention_plain(hq, hk, hv), reps=1,
            batches=3, warmup=1)
        fa16_lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
            hq, hk, hv, is_causal=True, enable_gqa=True), reps=5)
        for s in Strategy:
            spec = PipelineSpec(s)
            for kname, (a_, b_) in (("matmul", (mm_a, mm_b)),
                                    ("matmul-f32", (mm32_a, mm32_b))):
                timing[(kname, s)] = (device_ms(
                    lambda: matmul.matmul_cuda(a_, b_, spec=spec),
                    reps=20 if kname == "matmul" else 5),
                    mm_plain[kname], mm_lib[kname], mm_work[kname])
            timing[("flash_attention", s)] = (device_ms(
                lambda: flash_attention.flash_attention_cuda(fq, fk, fv,
                                                             spec=spec),
                reps=5), fa_plain_ms, fa_lib_ms, fa_work)
            timing[("flash_attention-bf16", s)] = (device_ms(
                lambda: flash_attention.flash_attention_cuda(hq, hk, hv,
                                                             spec=spec),
                reps=5), fa16_plain_ms, fa16_lib_ms, fa16_work)
    except Exception as e:
        fail(f"matmul/flash_attention timing: {type(e).__name__}: {e}")
    # the TF32 rate of mma.sync m16n8k8 on this card (flash attention's
    # instruction): MMA_RATE_CHAINS independent steps a warp, 8 warps a
    # block, one block an SM; flash's three TF32 products at that rate are
    # the floor of its design
    mma_floor = ""
    try:
        fa_lib = _build.library("flash_attention")
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        probe_out = torch.empty(sms * 256, device=dev)

        def probe():
            _build.check(fa_lib, fa_lib.flash_mma_rate_launch(
                0, sms, MMA_RATE_ITERS, probe_out.data_ptr(),
                torch.cuda.current_stream().cuda_stream), "mma.sync rate probe")

        probe_ms = device_ms(probe, reps=1, batches=3, warmup=1)
        rate = sms * 8 * MMA_RATE_CHAINS * MMA_RATE_ITERS * 16 * 8 * 8 * 2 / (
            probe_ms * 1e-3)
        mma_floor = (f"; mma.sync floor {fa_work[0] / rate * 1e3:.4f} ms at "
                     f"the probe's {rate / 1e12:.1f} TFLOP/s")
        print(f"mma.sync m16n8k8 tf32 rate: {rate / 1e12:.1f} TFLOP/s "
              f"({probe_ms:.4f} ms for {MMA_RATE_CHAINS} x {MMA_RATE_ITERS} "
              f"steps a warp, 8 warps on each of {sms} SMs)", flush=True)
    except Exception as e:
        fail(f"mma.sync rate probe: {type(e).__name__}: {e}")
    # hotspot: the bytes its copies request (each column tile's window of
    # WIN columns, each band's two rows above it; power and out as the
    # bound counts them) and their time at the HBM rate
    hs_moved = sum(hotspot._moved_bytes(*temp.shape, 32, 8).values())
    hs_floor = hs_moved / HBM_BYTES_PER_S * 1e3
    for (k, s), (ms, pms, lms, work) in timing.items():
        least, by = bound(*work)
        floor = ""
        if k == "flash_attention":
            floor = (f" (3xTF32; FFMA floor {fa_ops / F32_OPS_PER_S * 1e3:.4f}"
                     f" ms, {fa_ops / F32_OPS_PER_S * 1e3 / ms:.1%} of it"
                     f"{mma_floor})")
        elif k == "flash_attention-bf16":
            floor = (f" (Q.K^T one bf16 product, P.V three; this design's "
                     f"two TF32 products each {fa16_design:.4f} ms, "
                     f"{fa16_design / ms:.1%} of it; one bf16 product each, "
                     f"which the reference's f32 P rules out, "
                     f"{fa_ops / BF16_TC_OPS_PER_S * 1e3:.4f} ms)")
        elif k == "hotspot":
            floor = (f" (its copies {hs_moved / 1e6:.1f} MB, floor "
                     f"{hs_floor:.4f} ms, {hs_floor / ms:.1%} of it)")
        print(f"time {k} {s.value}: {ms:.4f} ms, bound {least:.4f} ms by "
              f"{by} ({least / ms:.1%} of it){floor}, plain {pms:.4f} ms, "
              f"library {'%.4f ms' % lms if lms is not None else 'none'}",
              flush=True)
    print(f"pathfinder {tuple(pf_wall.shape)}: "
          f"{pathfinder.LAUNCHES_PER_CALL} launch a call; nw n={n_nw}: "
          f"{nw.LAUNCHES_PER_CALL} launch of {nw.strips(n_nw)} strips a "
          f"call, no pass shifts the scores (the table's column offset "
          f"does)", flush=True)
    # lud at n = 8192, bs = 32: each kernel at its first step, in place at
    # the main path's layout (views of one matrix, row pitch n), on a fresh
    # copy of the matrix after step 0's perimeters (lud_internal: the first
    # sub-step's two updates, which read one L and one U row); then the
    # whole
    h = n - bs
    substep = first_substep(n, bs)
    lud_work = {   # name -> (operations, bytes: inputs read and outputs
        #                     written once)
        "lud_diagonal": (sum(m + 2 * m * m for m in range(1, bs)),
                         2 * bs * bs * 4),
        "lud_perimeter_row": (h * bs * (bs - 1), (bs * bs + 2 * bs * h) * 4),
        "lud_perimeter_col": (h * bs * bs, (bs * bs + 2 * bs * h) * 4),
        # both strips, the diagonal block read once
        "lud_perimeters": (h * bs * (2 * bs - 1), (bs * bs + 4 * bs * h) * 4),
        "lud_internal": (
            sum(2 * (r.stop - r.start) * (c.stop - c.start) * bs
                for r, c in substep),
            (2 * h * bs + sum(2 * (r.stop - r.start) * (c.stop - c.start)
                              for r, c in substep)) * 4),
        "lud_internal_panel": (2 * (n - p) ** 2 * p,
                               (2 * (n - p) * p + 2 * (n - p) ** 2) * 4),
        "lud": (2 * n ** 3 / 3, 2 * n * n * 4)}
    lud_work["lud_internal_pair"] = lud_work["lud_internal"]
    lud_timing = {}   # (name, strategy or None) -> (ms, plain_ms, library_ms)
    wrapper_ms = {}   # (name, strategy or None) -> CUDA-event ms of
    #                   back-to-back wrapper calls
    try:
        # host-bound calls: device time from the profiler (busy_ms); the
        # CUDA-event time of the kernels' wrappers is printed beside it.
        # The perimeter kernels solve in place, so each timed call first
        # restores its strips from the matrix after step 0's diagonal (a
        # copy left out of the time): solved again and again, the column
        # strip shrinks by U's diagonal (~n) a call into subnormals, and a
        # division's slow path would time those, not the main path's data
        # (the wrapper's back-to-back time printed beside holds the copy)
        x = step0.clone()
        raw = a8[:bs, :bs]
        y = a8.clone()
        y[:bs, :bs] = step0[:bs, :bs]
        dg, row, col = y[:bs, :bs], y[:bs, bs:], y[bs:, :bs]
        row0, col0 = a8[:bs, bs:], a8[bs:, :bs]

        def fresh(*pairs):
            for dst, src in pairs:
                dst.copy_(src)

        for name, call, plain, library in (
                ("lud_diagonal",
                 lambda: lud.lud_diagonal_cuda(x[:bs, :bs]),
                 lambda: lud.lud_diagonal_plain(raw),
                 lambda: torch.linalg.lu_factor(raw, pivot=False)),
                ("lud_perimeter_row",
                 lambda: (fresh((row, row0)),
                          lud.lud_perimeter_row_cuda(dg, row)),
                 lambda: lud.lud_perimeter_row_plain(dg, row0),
                 lambda: torch.linalg.solve_triangular(
                     dg, row0, upper=False, unitriangular=True)),
                ("lud_perimeter_col",
                 lambda: (fresh((col, col0)),
                          lud.lud_perimeter_col_cuda(dg, col)),
                 lambda: lud.lud_perimeter_col_plain(dg, col0),
                 lambda: torch.linalg.solve_triangular(
                     dg, col0, upper=True, left=False)),
                ("lud_perimeters",
                 lambda: (fresh((row, row0), (col, col0)),
                          lud.lud_perimeters_cuda(dg, row, col)),
                 lambda: (lud.lud_perimeter_row_plain(dg, row0),
                          lud.lud_perimeter_col_plain(dg, col0)),
                 lambda: (torch.linalg.solve_triangular(
                     dg, row0, upper=False, unitriangular=True),
                     torch.linalg.solve_triangular(
                         dg, col0, upper=True, left=False)))):
            wrapper_ms[(name, None)] = device_ms(call)
            lud_timing[(name, None)] = (
                busy_ms(call, name="" if name == "lud_diagonal" else
                        "lud_perimeters_kernel", what=name),
                busy_ms(plain, what=f"{name} plain"),
                busy_ms(library, what=f"{name} library"))
        x = step0.clone()
        views = [(x[r, :bs], x[:bs, c], x[r, c]) for r, c in substep]

        def both(fn, **kw):
            for l_, u_, c_ in views:
                fn(l_, u_, c_, **kw)

        internal_plain_ms = busy_ms(lambda: both(lud.lud_internal_plain),
                                    what="lud_internal plain")
        internal_lib_ms = busy_ms(
            lambda: both(lambda l_, u_, c_: torch.addmm(c_, l_, u_,
                                                        alpha=-1)),
            what="lud_internal library")
        xp = first.clone()
        pl_, pu_, pc_ = xp[p:, :p], xp[:p, p:], xp[p:, p:]
        panel_plain_ms = device_ms(
            lambda: lud.lud_internal_plain(pl_, pu_, pc_))
        panel_lib_ms = device_ms(
            lambda: torch.addmm(pc_, pl_, pu_, alpha=-1))
        for s in Strategy:
            spec = PipelineSpec(s)
            lud_timing[("lud_internal_panel", s)] = (
                device_ms(lambda: lud.lud_internal_cuda(pl_, pu_, pc_,
                                                        spec=spec)),
                panel_plain_ms, panel_lib_ms)
        del xp, pl_, pu_, pc_
        lud_plain_ms = device_ms(lambda: lud.lud_plain(a8, bs), reps=1,
                                 batches=3, warmup=1)
        lud_lib_ms = device_ms(
            lambda: torch.linalg.lu_factor(a8, pivot=False), reps=5,
            batches=3, warmup=1)
        for s in Strategy:
            spec = PipelineSpec(s)

            def call(spec=spec):
                both(lud.lud_internal_cuda, spec=spec)

            def pair(spec=spec):
                lud.lud_internal_pair_cuda(*views, spec=spec)

            wrapper_ms[("lud_internal", s)] = device_ms(call)
            lud_timing[("lud_internal", s)] = (
                busy_ms(call, what=f"lud_internal {s.value}"),
                internal_plain_ms, internal_lib_ms)
            wrapper_ms[("lud_internal_pair", s)] = device_ms(pair)
            lud_timing[("lud_internal_pair", s)] = (
                busy_ms(pair, what=f"lud_internal_pair {s.value}"),
                internal_plain_ms, internal_lib_ms)
            lud_timing[("lud", s)] = (
                device_ms(lambda: lud.lud_cuda(a8, bs=bs, spec=spec), reps=5,
                          batches=3, warmup=1),
                lud_plain_ms, lud_lib_ms)
        del x, y, dg, row, col, views
    except Exception as e:
        fail(f"lud timing: {type(e).__name__}: {e}")

    for (name, s), (ms, pms, lms) in lud_timing.items():
        least, by = bound(*lud_work[name])
        label = name if s is None else f"{name} {s.value}"
        regions = " and ".join(f"{(r.stop - r.start, c.stop - c.start)}"
                               for r, c in substep)
        where = {"lud": "", "lud_internal_panel": ", first panel",
                 "lud_internal": f", first sub-step: (H, W) = {regions}, a "
                                 f"launch each",
                 "lud_internal_pair": f", first sub-step: (H, W) = "
                                      f"{regions} in one launch"}.get(
                     name, ", first step")
        how = "" if (name, s) not in wrapper_ms else \
            (f" device time (profiler; the wrapper's back-to-back call "
             f"{wrapper_ms[(name, s)]:.4f} ms)")
        print(f"time {label} (n=8192 bs=32{where}):{how} {ms:.4f} ms, bound "
              f"{least:.4f} ms by {by} ({least / ms:.1%} of it), plain "
              f"{pms:.4f} ms, library {lms:.4f} ms", flush=True)
    for s in Strategy:
        if ("lud_internal_pair", s) in lud_timing:
            print(f"lud_internal n=8192 bs=32 first sub-step {s.value}: one "
                  f"launch {lud_timing[('lud_internal_pair', s)][0]:.4f} ms, "
                  f"a launch a region "
                  f"{lud_timing[('lud_internal', s)][0]:.4f} ms, two addmm "
                  f"{internal_lib_ms:.4f} ms", flush=True)
    # the K = bs updates of one whole call: the bytes they must move (each
    # L, U and C read once, each C written once: the call's bound), and
    # the same updates as addmm, their summed device time in one call
    call_bytes, call_addmm = 0, []
    xa = a8.clone()
    for c, c1, end in lud.internal_substeps(n, bs):
        for rows, cols in ((slice(c1, n), slice(c1, end)),
                           (slice(c1, end), slice(end, n))):
            h_, w_ = rows.stop - rows.start, cols.stop - cols.start
            if w_:
                call_bytes += 4 * (h_ * bs + bs * w_ + 2 * h_ * w_)
                call_addmm.append((xa[rows, c:c1], xa[c:c1, cols],
                                   xa[rows, cols]))
    try:
        addmm_ms = busy_ms(lambda: [torch.addmm(c_, l_, u_, alpha=-1)
                                    for l_, u_, c_ in call_addmm], reps=1,
                          what="the K = bs updates as addmm")
        print(f"lud n=8192 bs=32 K = bs updates of a call: "
              f"{lud.lud_launches(n, bs)[3]} launches, {call_bytes / 1e9:.4f} "
              f"GB (bound {call_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms at the "
              f"HBM rate); as {len(call_addmm)} addmm {addmm_ms:.4f} ms of "
              f"device time", flush=True)
    except Exception as e:
        fail(f"lud K = bs updates as addmm: {type(e).__name__}: {e}")
    del xa, call_addmm
    print(f"lud n=8192 reference model: {lud_work['lud'][0] / 1e12:.3f} TFLOP "
          f"({lud_work['lud'][0] / F32_OPS_PER_S * 1e3:.3f} ms at the f32 "
          f"rate), {2 * n ** 3 / (3 * bs) * 4 / 1e9:.2f} GB of C traffic "
          f"({2 * n ** 3 / (3 * bs) * 4 / HBM_BYTES_PER_S * 1e3:.3f} ms at "
          f"the HBM rate)", flush=True)
    # the trailing matrix read and written once per update: every bs
    # columns in the reference's schedule, every PANEL in the card's
    for label, width in (("rank-bs", bs), ("panel", lud.PANEL)):
        moved = sum(8 * (n - i) ** 2 for i in range(width, n, width))
        print(f"lud n=8192 {label} trailing updates: {moved / 1e9:.2f} GB "
              f"({moved / HBM_BYTES_PER_S * 1e3:.3f} ms at the HBM rate)",
              flush=True)
    for s in Strategy:
        profile_lud(lambda: lud.lud_cuda(a8, bs=bs, spec=PipelineSpec(s)),
                    s.value, lud.lud_launches(n, bs))
    for s in Strategy:
        profile_one(lambda: hotspot.hotspot_step_cuda(
            temp, power, spec=PipelineSpec(s), grid=32), "hotspot", s.value,
            1, alone=True)
        profile_one(lambda: nw.nw_cuda(nw_scores, 10, spec=PipelineSpec(s),
                                       tile_rows=8),
                    "nw", s.value, nw.LAUNCHES_PER_CALL)
        profile_one(lambda: pathfinder.pathfinder_cuda(
            pf_wall, spec=PipelineSpec(s), tile_rows=8),
            "pathfinder", s.value, pathfinder.LAUNCHES_PER_CALL)

    # the parity shapes fit in the L2: these times are launch overhead
    xs = rand((256, 256))
    ts, ps = rand((64, 126), scale=100.0, shift=300.0), rand((64, 126))
    for s in Strategy:
        spec = PipelineSpec(s)
        try:
            ms_s = device_ms(lambda: stream.stream_cuda(
                xs, iters=32, spec=spec, tile_rows=16, n_tiles=8))
            ms_h = device_ms(lambda: hotspot.hotspot_cuda(
                ts, ps, iters=2, spec=spec, grid=2))
        except Exception as e:
            fail(f"parity timing {s.value}: {type(e).__name__}: {e}")
            continue
        print(f"time parity {s.value}: stream (256, 256) iters=32 "
              f"{ms_s:.4f} ms (bound {2 * xs.numel() * 4 / HBM_BYTES_PER_S * 1e3:.5f}"
              f" ms); hotspot (64, 126) iters=2 {ms_h:.4f} ms (bound "
              f"{2 * 3 * ts.numel() * 4 / HBM_BYTES_PER_S * 1e3:.5f} ms)",
              flush=True)

    # -- 4. the main path -------------------------------------------------
    launches = {}
    rows = []
    # the seed configs and the scenarios' pins only: a registry left in
    # the working directory changes nothing here
    opts = runner.RunOptions(device="cuda", repeats=10, use_tuned=False)
    # calls a cell: the oracle's, the other warmups, the trials
    calls = 1 + max(opts.warmup - 1, 0) + opts.repeats
    for s in Strategy:
        scs = scenario.scenarios(only=",".join(
            f"h100/{k}/{s.value}" for k in ("stream", "hotspot", "pathfinder",
                                             "nw", "lud", "matmul",
                                             "flash_attention")))
        # the h100 matmul cell in f32 too: the f32 kernel's main path
        mm_cell = scenario.get_scenario(f"h100/matmul/{s.value}")
        scs.append(dataclasses.replace(
            mm_cell, name=f"h100/matmul-f32/{s.value}", dtype="float32"))
        reset_launches()
        try:
            report = runner.run_scenarios(scs, opts)
        except Exception as e:
            fail(f"main path {s.value}: {type(e).__name__}: {e}")
            continue
        for k, count in read_launches().items():
            launches[(k, s)] = count
        for r in report.results:
            m = r.metrics
            rows.append(r.to_dict())
            print(f"main {r.scenario}: us_median {m['us_median']:.1f} "
                  f"GB/s {m['gb_per_s']:.1f} check_ok {m['check_ok']} "
                  f"max_err {m['max_err']:.3g}", flush=True)
            if not m["check_ok"]:
                fail(f"main path {r.scenario} failed its oracle check")
            if "tuned" in r.config_source:
                fail(f"main path {r.scenario}: config_source "
                     f"{r.config_source}")
        # the schedule runs both perimeter solves in one launch, and
        # neither alone (lud_launches)
        for k in ("stream", "hotspot", "pathfinder", "nw", "lud_diagonal",
                  "lud_perimeters", "lud_internal", "lud_internal_panel",
                  "matmul", "matmul-f32", "flash_attention"):
            if launches[(k, s)] < 1:
                fail(f"main path {s.value}: {k} kernel was never launched")
        # the counters hold what the C launchers reported; each call of a
        # cell enqueues one stream launch (two stream cells: iters 1 and
        # 32), one hotspot launch a step, one pathfinder, nw, bf16 matmul or
        # flash attention launch, the f32 matmul's launch plan (one launch
        # at N = 8960), and lud_launches (n = 8192, bs = 32) by lud kernel
        mm32_per_call = matmul.launches(torch.float32, s, mm_cell.shape[2])
        n_stream = sum(sc.kernel == "stream" for sc in scs)
        for k, per_call in (("stream", n_stream),
                            *launches_per_call(s, n, bs),
                            ("matmul-f32", mm32_per_call)):
            print(f"main h100/{k}/{s.value}: {launches[(k, s)]} launches = "
                  f"{calls} calls x {per_call}", flush=True)
            if launches[(k, s)] != calls * per_call:
                fail(f"main path {s.value}: {k} launched "
                     f"{launches[(k, s)]} kernels, not {calls} x {per_call}")
    if args.out:
        with open(os.path.join(args.out, "bench_h100.json"), "w") as f:
            json.dump({"schema_version": 2, "generator": "chip_smoke.py",
                       "backend": "cuda", "jax_version": "", "rows": rows,
                       "card": card}, f, indent=1)

    # -- 5. the analysis path --------------------------------------------
    if args.out:
        analysis(args.out, card, n, bs)
    else:
        with tempfile.TemporaryDirectory() as out:
            analysis(out, card, n, bs)

    # -- 6. the autotuner --------------------------------------------------
    main_us = {r["scenario"]: r["metrics"]["us_median"] for r in rows}
    if args.out:
        tuning(args.out, card, main_us)
    else:
        with tempfile.TemporaryDirectory() as out:
            tuning(out, card, main_us)

    # -- 7. the model path -----------------------------------------------
    try:
        launches.update(model_path(card))
    except Exception as e:
        fail(f"model path: {type(e).__name__}: {e}")

    # -- 8. result lines --------------------------------------------------
    kernels = []
    for (k, s), (ms, pms, lms, work) in timing.items():
        least, by = bound(*work)
        kernels.append({
            "name": f"{k}/{s.value}", "route": "cuda",
            "source": SOURCES[k][0], "replaces": SOURCES[k][1],
            "launches": launches.get((k, s), 0),
            "max_abs_err": max_err.get((k, s)), "ms": ms, "plain_ms": pms,
            "bound_ms": least, "bound_by": by, "library_ms": lms})
    for (kernel, s), (ms, pms, lms) in lud_timing.items():
        if kernel == "lud":             # the whole factorisation: no kernel
            continue
        least, by = bound(*lud_work[kernel])
        kernels.append({
            "name": kernel if s is None else f"{kernel}/{s.value}",
            "route": "cuda", "source": "src/repro_torch/csrc/lud.cu",
            "replaces": LUD_REPLACES[kernel],
            # a strategy-free kernel's launches: the sum over the five runs;
            # a perimeter solve's, the launches that ran it: alone, or in
            # the launch of both (the main path's); lud_internal's and the
            # pair's, those of the one K = bs kernel (the main path
            # launches it for both regions of a sub-step at once)
            "launches": launches.get(
                ("lud_internal" if kernel == "lud_internal_pair" else kernel,
                 s), 0) if s is not None else
            sum(launches.get((k_, t), 0) for t in Strategy
                for k_ in {kernel} | ({"lud_perimeters"} if kernel in (
                    "lud_perimeter_row", "lud_perimeter_col") else set())),
            "max_abs_err": max_err.get((kernel, s)), "ms": ms,
            "plain_ms": pms, "bound_ms": least, "bound_by": by,
            "library_ms": lms})
    print(f"torch.profiler lost {MARKERS_LOST[0]} of the {MARKERS_LOST[1]} "
          f"markers that open and close its traces", flush=True)
    print(f"chip_smoke: {time.perf_counter() - started:.1f} s in all",
          flush=True)
    expected = 11 * len(Strategy) + 4
    if len(kernels) != expected:
        fail(f"only {len(kernels)} of {expected} kernels timed")
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} failure(s)", flush=True)
        print(f"chip_smoke: {len(FAILURES)} failure(s): " + "; ".join(
            FAILURES[:20]), file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
