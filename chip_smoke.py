#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py [--out DIR]

Phases, each reported on its own lines:

  1. the card's name and power limit (nvidia-smi), then one nvcc per CUDA
     source, all started together, and the build time;
  2. every kernel x strategy held against its plain torch version on the
     card, at the parity shapes and at the h100/* shapes, at ring depths
     2/3/4, wait_group 0 and None, and out_depth 1/2/4;
  3. each kernel's time (median of 5 batches of 20 back-to-back calls)
     at the h100/* shape beside its byte bound, its plain version's time
     and, for stream, one library call's time; then at the parity shapes;
  4. the main path: repro_torch.bench.runner.run_scenarios over the h100/*
     cells of each strategy, with the kernels' launch counters set to 0
     just before and read just after;
  5. a {"kernels": [...]} line, the card line, and the last line
     {"ok": true, "device": {...}}.

Any failed phase exits non-zero before the last line.  With no CUDA device,
or without the repository's src/ beside it, it exits 1 and prints no result.
--out DIR also writes the main path's schema-v2 report and the build logs
there.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

#: H100 SXM HBM3 rate (NVIDIA data sheet), the bytes bound of every kernel
HBM_BYTES_PER_S = 3.35e12

FAILURES = []


def fail(msg: str) -> None:
    print(f"FAIL {msg}", flush=True)
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
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="write the main path's report and build logs here")
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("error: src/repro_torch not found beside chip_smoke.py",
              file=sys.stderr)
        return 1
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA device; chip_smoke.py runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    from repro_torch.bench import runner, scenario
    from repro_torch.core.async_pipeline import PipelineSpec, Strategy
    from repro_torch.kernels import _build, hotspot, stream

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
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            shutil.copy(log, os.path.join(args.out, f"ptxas_{name}.log"))

    # -- 2. every kernel x strategy against its plain version -------------
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(shape, dtype=torch.float32, scale=1.0, shift=0.0):
        x = torch.rand(shape, generator=g, device=dev) * scale + shift
        return x.to(dtype)

    stream_cases = [  # (label, shape, tile_rows, n_tiles, iters)
        ("parity", (64, 128), 8, 4, 3), ("parity", (96, 128), 8, 4, 3),
        ("fig3", (256, 256), 16, 8, 32), ("h100", (16384, 4096), 16, 8, 1)]
    hotspot_cases = [  # (label, shape, grid, iters)
        ("parity", (64, 126), 2, 2), ("parity", (32, 128), 1, 2),
        ("h100", (8192, 8192), 32, 1)]
    max_err = {}                    # (kernel, strategy) -> err at h100 shape
    n_checks = 0
    for strategy, depth, wg, od in configs():
        spec = PipelineSpec(strategy, depth, wg, od)
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
        for label, shape, grid, iters in hotspot_cases:
            temp = rand(shape, scale=100.0, shift=300.0)
            power = rand(shape)
            try:
                got = hotspot.hotspot_cuda(temp, power, iters=iters, spec=spec,
                                           grid=grid)
                torch.cuda.synchronize()
            except Exception as e:
                fail(f"hotspot {spec} {shape}: {type(e).__name__}: {e}")
                continue
            want = temp
            for _ in range(iters):
                want = hotspot.hotspot_step_plain(want, power)
            err = float((got - want).abs().max())
            n_checks += 1
            if not torch.allclose(got, want, rtol=1e-5, atol=1e-3):
                fail(f"hotspot {spec} {shape}: max_abs_err {err:.3g} beyond "
                     f"rtol 1e-5 atol 1e-3")
            if label == "h100" and (depth, wg, od) in ((2, None, 2),
                                                       (1, None, 2)):
                max_err[("hotspot", strategy)] = err
        print(f"checked {spec}", flush=True)
    print(f"parity: {n_checks} checks against the plain versions, "
          f"{len(FAILURES)} failed (stream f32 tol 1e-6, bf16 tol 2e-2, "
          f"hotspot rtol 1e-5 atol 1e-3)", flush=True)
    for (k, s), e in sorted(max_err.items(), key=lambda kv: kv[0][0]):
        if k == "stream_bf16":
            print(f"stream bf16 {s.value}: max_abs_err {e:.3g} at "
                  f"(16384, 4096)", flush=True)

    # -- 3. time at the h100/* shapes -------------------------------------
    timing = {}
    x = rand((16384, 4096))
    one = torch.ones((), device=dev)
    temp = rand((8192, 8192), scale=100.0, shift=300.0)
    power = rand((8192, 8192))
    stream_bytes = 2 * x.numel() * 4
    hotspot_bytes = 3 * temp.numel() * 4
    stream_plain_ms = device_ms(lambda: stream.stream_plain(x, 1))
    stream_lib_ms = device_ms(lambda: torch.lerp(x, one, 0.5))
    hotspot_plain_ms = device_ms(
        lambda: hotspot.hotspot_step_plain(temp, power))
    pad_ms = device_ms(lambda: hotspot._pad_edge(temp))
    print(f"time hotspot edge pad alone (part of every step): "
          f"{pad_ms:.4f} ms", flush=True)
    for s in Strategy:
        cfg = {**scenario.get_scenario(f"h100/stream/{s.value}").config}
        spec = PipelineSpec(s)
        try:
            ms = device_ms(lambda: stream.stream_cuda(
                x, iters=1, spec=spec, tile_rows=cfg["tile_rows"],
                n_tiles=cfg["n_tiles"]))
            timing[("stream", s)] = (ms, stream_plain_ms, stream_lib_ms,
                                     stream_bytes)
            ms = device_ms(lambda: hotspot.hotspot_step_cuda(
                temp, power, spec=spec, grid=32))
            timing[("hotspot", s)] = (ms, hotspot_plain_ms, None,
                                      hotspot_bytes)
        except Exception as e:
            fail(f"timing {s.value}: {type(e).__name__}: {e}")
    for (k, s), (ms, pms, lms, nbytes) in timing.items():
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"time {k} {s.value}: {ms:.4f} ms, bound {bound:.4f} ms "
              f"({bound / ms:.1%} of it), plain {pms:.4f} ms, library "
              f"{'%.4f ms' % lms if lms is not None else 'none'}", flush=True)
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
    for s in Strategy:
        scs = scenario.scenarios(
            only=f"h100/stream/{s.value},h100/hotspot/{s.value}")
        stream.LAUNCHES = 0
        hotspot.LAUNCHES = 0
        try:
            report = runner.run_scenarios(
                scs, runner.RunOptions(device="cuda", repeats=10))
        except Exception as e:
            fail(f"main path {s.value}: {type(e).__name__}: {e}")
            continue
        launches[("stream", s)] = stream.LAUNCHES
        launches[("hotspot", s)] = hotspot.LAUNCHES
        for r in report.results:
            m = r.metrics
            rows.append(r.to_dict())
            print(f"main {r.scenario}: us_median {m['us_median']:.1f} "
                  f"GB/s {m['gb_per_s']:.1f} check_ok {m['check_ok']} "
                  f"max_err {m['max_err']:.3g}", flush=True)
            if not m["check_ok"]:
                fail(f"main path {r.scenario} failed its oracle check")
        for k in ("stream", "hotspot"):
            if launches[(k, s)] < 1:
                fail(f"main path {s.value}: {k} kernel was never launched")
    if args.out:
        with open(os.path.join(args.out, "bench_h100.json"), "w") as f:
            json.dump({"schema_version": 2, "generator": "chip_smoke.py",
                       "backend": "cuda", "jax_version": "", "rows": rows,
                       "card": card}, f, indent=1)

    # -- 5. result lines --------------------------------------------------
    sources = {"stream": ("src/repro_torch/csrc/stream.cu",
                          "src/repro/kernels/stream.py:62"),
               "hotspot": ("src/repro_torch/csrc/hotspot.cu",
                           "src/repro/kernels/hotspot.py:68")}
    kernels = []
    for (k, s), (ms, pms, lms, nbytes) in timing.items():
        kernels.append({
            "name": f"{k}/{s.value}", "route": "cuda",
            "source": sources[k][0], "replaces": sources[k][1],
            "launches": launches.get((k, s), 0),
            "max_abs_err": max_err.get((k, s)), "ms": ms, "plain_ms": pms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": lms})
    if len(kernels) != 2 * len(Strategy):
        fail(f"only {len(kernels)} of {2 * len(Strategy)} kernels timed")
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} failure(s)", flush=True)
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
