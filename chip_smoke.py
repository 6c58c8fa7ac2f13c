#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py [--out DIR]

Phases, each reported on its own lines:

  1. the card's name and power limit (nvidia-smi), then one nvcc per CUDA
     source, all started together, and the build time, with each f32
     matmul, batched bf16 matmul and flash attention kernel's registers
     and spills from ptxas;
     then cuobjdump -sass of the hotspot, matmul, lud, nw, pathfinder and
     flash attention libraries: the count of HGMMA (wgmma), HMMA (mma.sync),
     UTMALDG (a tensor-map TMA load), UBLKCP (a 1-D bulk copy), FFMA, LDS,
     STL/LDL (local memory: spills), MUFU.RCP (a reciprocal) and LDG in
     each kernel instantiation.  It fails if cuobjdump is missing, if a
     bf16 matmul kernel (2-D or batched) has no HGMMA, if an f32 flash
     attention kernel has no HMMA, if a bf16 flash attention kernel has no
     HGMMA (DROP_OFF's, which runs mma.sync: no HMMA), if a hotspot, f32
     matmul, flash attention, lud_internal (K = bs)
     or pathfinder kernel other than DROP_OFF's, any nw kernel or the lud
     perimeter kernel uses local memory, if the lud
     perimeter kernel (both solves) has bs MUFU.RCP or more (a division a
     step of the column solve), if a TMA kernel of the matmul (bf16, batched or f32),
     lud_internal, lud_internal_panel or bf16 flash attention has no
     UTMALDG, or if a batched TMA kernel uses local memory;
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
     product and P.V three, the products its wgmma design runs), its plain
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
     that prefill chunks of 64 and 128 write bit-identical rows and that
     each of layer 0's products gives a row the same bits at M = 64 and
     128 (every linear and unembed runs on the matmul kernel, whose sums
     do not depend on M); every op of layer 0's decode step at batch 4
     against its row 0 alone, and of a prefill chunk of 128 rows against
     its first 64, bit for bit (the f32 einsums the decode attention ran
     before are printed beside the float64 ones it runs now); prefill,
     decode and paged decode times beside their bounds, and the flash
     kernel's share of a prefill from torch.profiler; then, after the
     counters are read: each product as linear and unembed run it (layer
     0's seven, unembed on the f32 kernel's two launches) at M = 4 and
     2048 on the model's own weights against matmul_plain, within 1e-5 of
     the sum of |products|; layer 0's flash call at S = 512 and 300 (384
     padded) against the plain version on the model's own q, k, v at
     2e-5; two planted faults in layer 0's call (window 1, causal off),
     each of which the logits check must reject; and Model.loss under
     autograd, which must raise ValueError before any launch (neither the
     matmul nor the flash kernel has a backward pass);
  8. serving at full width (``serving_path``): qwen2-1.5b at SERVE_LAYERS
     (4) of its 28 layers served by repro_torch.serve over a paged arena
     of 16-row blocks on a poisson trace of 8 requests (prompts 64-512,
     8-16 new tokens), the launch counters set to 0 just before its FIFO
     run at batch 4 and read just after (flash one a layer a monolithic
     prefill; the matmul kernel 7 a layer bf16 and 2 f32 launches a model
     call); FIFO and reversed arrivals at batch 4
     against each request alone in a batch-4 scheduler; batch 4 and 2
     against a solo oracle at batch 1; chunked prefill (64) FIFO and
     reversed against a chunked solo oracle, with no flash launch; a
     shared-prefix trace (256 tokens in groups of 4) shared against not
     shared, hit ratio above 0; the arena drained after each run; one
     decode_paged call's launches; the nine serve/* cells through
     bench.runner at smoke size with the reference's token counts and
     serve/prefix/shared's 0.6100, the flash kernel launched by every
     cell that prefills whole prompts (head dim 8 padded to 64); tokens/s, TTFT and decode percentiles
     (decode beside its bound), occupancy and the phase's seconds;
  9. the moe family at full width (``moe_path``, after phases 7 and 8
     free their models): qwen2-moe-a2.7b at 12 of its 24 layers
     (MOE_LAYERS; d_model 2048, 16 heads of 128, 60 routed experts top-4
     of ff 1408 and 4 shared, vocab 151936, weights from a seeded
     generator) with attention="flash": its parameter count against
     param_count() plus the sigmoid gates (one a layer) the analytic count
     omits; layer 0's three
     expert products as the batched launch runs them (60 experts, 128
     rows an expert at decode, 256 at a prefill of 4 x 512) at every
     strategy, each expert bit-identical to the 2-D kernel at the same
     strategy and a prefill's rows 0-127 to a call of those rows alone
     (256-row tiles against 128), three walk shapes (BATCHED_WALKS) at
     every strategy and TMA at depths 3 and 4, and the router and sigmoid
     gate on the f32 kernel, within 1e-5 of the sum of |products|; the
     batched launch's time at the decode and prefill shapes at every
     strategy and TMA at depths 3 and 4, beside its bound, its plain
     version and torch.bmm; then,
     the counters set to 0 just before and read just after, a prefill at
     each strategy of the model's products against attention="chunked",
     forward over the prompts flash against chunked, 32 greedy decode
     steps (4 against a forward with no capacity drop), chunks of 64 and
     128 (chunk 0 against a dense prefill of its tokens) and decode_paged
     against decode_step over the same rows, all under the routing-flip
     rule (MOE_FLIP_SHARE); a forward's launches (3 batched a layer);
     layer 0's share of assignments dropped at each call shape; layer 0's
     moe block against a plain recomputation with the same ids; a planted
     fault (one expert's w_up rows reversed) that the block check and the
     flip rule must reject; a decode step at batch 4 bit-identical to
     each row alone; ServingLoop on phase 8's trace (FIFO and reversed at
     batch 4 bit-identical to each request alone); prefill and decode
     times beside their bounds; the peak memory;
 10. the vlm, ssm and hybrid families at full width (``families_path``,
     after phase 9 frees its model, one model at a time, each freed
     before the next), weights from a seeded generator, attention="flash";
     for each model its parameter count beside param_count() term by term
     (not required equal: the analytic count approximates the recurrent
     blocks and omits patch_proj), a rounding floor (a prefill in bf16
     against the same prefill in float32) to twice which every logits
     comparison is held (FAMILY_OWN), Model.loss under autograd
     (ValueError before any launch), prefill and decode times beside their
     bounds, the peak memory and its seconds.  The launch counters are set
     to 0 just before each model's main-path calls and read just after;
     the reference runs (attention="chunked", the float32 floor, xlstm's
     chunk 32) and the checks' own calls fall outside.  phi-3-vision-4.2b
     (32 layers, d_model 3072, 32 heads of 96, 256 patch rows), counted: a
     prefill of 4 prompts of 512 tokens after the patch rows (768 rows) at
     each strategy of the bf16 flash kernel (32 launches each), against
     attention="chunked"; 16 greedy decode steps, 4 held against forward;
     decode_paged over the prefill's rows in an arena against decode_step;
     then layer 0's flash call (head dim 96 zero-padded to 128) against
     the plain version at 2e-5; a planted fault (the patch rows dropped)
     the logits check must reject; ServingLoop on phase 8's trace
     (continuous, FIFO and reversed at batch 4 bit-identical to each
     request alone; chunked prefill refused).  xlstm-1.3b (48 layers, 6 x
     (7 mLSTM + 1 sLSTM), d_model 2048, 4 heads), counted: a prefill of 4
     x 512 timed with its sLSTM blocks (a host-bound time loop), 8 decode
     steps and forward over 520 tokens (3 batched launches a mLSTM layer);
     then the whole model at chunk 64 against 32 and decode against
     forward, at 48 layers (chaotic at random weights: the floor nears
     uncorrelated logits) and on a stack of 2 x (1 mLSTM + 1 sLSTM)
     (SSM_SHALLOW, its own weights and floor), where a planted fault (each
     layer's state handed to the next of its kind after the prefill) must
     be rejected; each layer on the forward's own
     inputs to it: chunk 64 against 32, a prefill of 512 then 8 decode
     steps against the forward's rows (FAMILY_BLOCK_TOL); layer 0's mLSTM
     block and the first sLSTM block against a float64 recomputation token
     by token; a planted fault (layer 0's forget-gate bias negated) the
     mLSTM block check must reject; a decode step at batch 4 against each
     row alone, the logits and every op (``recorded_ops``) bit for bit.
     hymba-1.5b (32 layers, d_model 1600, 25 heads over 5 kv heads of 64,
     window 1024 on all but layers 0, 16 and 31), counted: a prefill of 2
     x 2048 at each flash strategy (32 launches each) against
     attention="chunked", 8 decode steps and forward; then the decode
     steps against forward; layers 0, 1 and 16's flash calls against the
     plain version at the layer's window (0 on a global layer) at 2e-5;
     layer 0's Mamba block, the SSD chunk against the associative scan; a
     decode step at batch 4 against each row alone, bit for bit; a planted
     fault (global layer 16 at the window) that layer 16's flash check
     must reject (its effect on the logits, printed, is under the floor).
     xlstm and hymba, each at a depth of its own (SSM_COHORT: one group
     of 7 mLSTM and 1 sLSTM layer; HYBRID_COHORT_LAYERS: 4, global and
     windowed layers both; their own seeded weights), through ServingLoop
     on phase 8's trace with each prompt cut to a multiple of 32 at about
     half its length and each max_new halved (COHORT_ROWS), which falls
     back to the cohort scheduler: FIFO and reversed at batch 4, every
     request bit-identical to its prompt served alone at its cohort's pad
     count;
 11. the encdec family at full width and depth (``encdec_path``, after
     phase 10 frees its last model): whisper-medium (24 encoder and 24
     decoder layers, d_model 1024, 16 heads of 64, d_ff 4096, vocab
     51865), weights from a seeded generator, attention="flash": its
     parameter count beside param_count(); before the counters,
     attention="chunked"'s encode of 4 x 1,500 frames and prefill of 4 x
     448 tokens over 448 frames and their rounding floors; counted, the
     prefill at each strategy of the bf16 flash kernel (72 launches each:
     24 encoder, 24 decoder self, 24 cross) and the encode at each (24),
     each against chunked within twice its floor, and 16 greedy decode
     steps; then 4 of them against a forward over the whole sequence on
     the prefill's encoder output (``encdec_forward``), and with the
     carried cross K/V zeroed (a planted fault that check must reject);
     a decode step at batch 4 against each row alone, the logits and
     every op bit for bit; encoder layer 0's flash call at S = 1,500 and
     448 and decoder layer 0's self and cross calls at 448 against the
     plain version at 2e-5 (every non-causal call runs with a key count
     below its padded length); two faults planted in encoder layer 0's
     call (run causal; the key count dropped) that its check must
     reject, each one's effect on the logits printed; Model.loss under
     autograd refused before any launch; ServingLoop at full depth on
     phase 8's trace cut as phase 10's (COHORT_ROWS; the cohort fallback,
     zero frames at a cohort's width), FIFO and reversed at batch 4, every
     request bit-identical to its prompt served alone at its cohort's pad
     count and width; encode, prefill and decode times beside their
     bounds; the peak memory and the phase's seconds;
 12. a {"kernels": [...]} line, the card line, and the last line
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
#: the bf16 products that give bf16 flash attention's f32 products, the
#: function's bound and the bf16 design's (its wgmma products): Q.K^T is
#: one (the product of two bf16 values is exact in f32, accumulated in
#: f32, the scale applied to S after), P.V three (P in f32 split into
#: three bf16 terms of 8 significand bits each, kPTerms in
#: csrc/flash_attention.cu)
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
SOURCES["matmul-f32"] = SOURCES["matmul-batched"] = SOURCES["matmul"]
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


#: the two flash attention kernels: f32 (3xTF32 mma.sync) and bf16 (wgmma)
FLASH_KERNELS = ("flash_kernel", "flash_bf16_kernel")


def is_flash(name: str) -> bool:
    """Is a device event's name one of the flash attention kernels'?"""
    return any(k in name for k in FLASH_KERNELS)


def kernel_label(fn: str):
    """``matmul_f32_kernel<2,1,0,256>`` and its template arguments for a
    mangled hotspot, matmul, lud, nw, pathfinder or flash attention kernel
    name; (None, None) for another."""
    m = re.search(r"((?:matmul|lud|pathfinder)_\w*?_kernel|nw_kernel|"
                  r"hotspot_kernel|flash_kernel|flash_bf16_kernel)"
                  r"I((?:Li\d+E)+)", fn)
    if m is None:
        return None, None
    targs = [int(t) for t in re.findall(r"Li(\d+)E", m.group(2))]
    return f"{m.group(1)}<{','.join(map(str, targs))}>", targs


def check_sass(libs) -> None:
    """The instruction phase: print each hotspot, matmul, lud, nw,
    pathfinder and flash attention kernel's counts and fail a bf16 matmul
    kernel without HGMMA; an f32 flash attention kernel without HMMA; a
    bf16 flash attention kernel without HGMMA (DROP_OFF's, which runs
    mma.sync from registers: without HMMA); a bf16 or f32 matmul,
    lud_internal, lud_internal_panel or bf16 flash attention TMA kernel
    without UTMALDG; a hotspot, f32 matmul, flash attention, lud_internal or
    pathfinder kernel other than DROP_OFF's, an nw kernel, a batched bf16
    matmul TMA kernel or
    the lud perimeter kernel with local memory (STL or LDL: a spill, or the
    row loop's arrays); and a perimeter kernel with a division in each of the
    column solve's bs steps (bs MUFU.RCP or more: the design takes bs
    reciprocals once a block and multiplies)."""
    tma, drop_off = 4, 3             # StrategyCode in async_pipeline.cuh
    seen = {"matmul_bf16_kernel": 0, "matmul_bf16_batched_kernel": 0,
            "matmul_f32_kernel": 0, "tma": 0,
            "nw_kernel": 0, "flash_kernel": 0, "flash_bf16_kernel": 0,
            "perimeter": 0, "pathfinder_spans_kernel": 0,
            "hotspot_kernel": 0}
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
            # flash_kernel<D, S, A, O, EB>, flash_bf16_kernel<D, S, A, O>;
            # the others start with S
            strategy = targs[1] if kernel in FLASH_KERNELS else targs[0]
            if kernel in seen:
                seen[kernel] += 1
            if kernel in ("matmul_bf16_kernel", "matmul_bf16_batched_kernel") \
                    and n["HGMMA"] < 1:
                fail(f"sass {label}: no HGMMA (wgmma)")
            if kernel == "flash_bf16_kernel" and strategy != drop_off \
                    and n["HGMMA"] < 1:
                fail(f"sass {label}: no HGMMA (wgmma)")
            if (kernel == "flash_kernel" or kernel == "flash_bf16_kernel"
                    and strategy == drop_off) and n["HMMA"] < 1:
                fail(f"sass {label}: no HMMA (mma.sync)")
            if kernel == "lud_perimeters_kernel":
                seen["perimeter"] += 1
                if n["MUFU.RCP"] >= targs[0]:
                    fail(f"sass {label}: {n['MUFU.RCP']} MUFU.RCP, a division "
                         f"in each step of the column solve")
            if (kernel in ("nw_kernel", "lud_perimeters_kernel") or
                    kernel in FLASH_KERNELS + (
                        "matmul_f32_kernel", "lud_internal_kernel",
                        "pathfinder_spans_kernel", "hotspot_kernel")
                    and strategy != drop_off) and n["STL"] + n["LDL"] > 0:
                fail(f"sass {label}: spills (STL {n['STL']}, LDL "
                     f"{n['LDL']})")
            if kernel in ("matmul_bf16_kernel", "matmul_bf16_batched_kernel",
                          "matmul_f32_kernel", "lud_internal_kernel",
                          "lud_internal_panel_kernel",
                          "flash_bf16_kernel") and strategy == tma:
                seen["tma"] += 1
                if n["UTMALDG"] < 1:
                    fail(f"sass {label}: no UTMALDG (tensor-map TMA load)")
            if kernel == "matmul_bf16_batched_kernel" and strategy == tma \
                    and n["STL"] + n["LDL"] > 0:
                fail(f"sass {label}: spills (STL {n['STL']}, LDL "
                     f"{n['LDL']})")
    # 13 (strategy, ahead) pairs: bf16 13; batched bf16 at 128- and 256-row
    # tiles 10 each and one TMA each (its lead is the ring's); f32 9 at
    # tile widths 256 and 128, DROP_OFF's 4 at 128; TMA: 3 bf16, 2 batched
    # and 6 f32 matmul, 12 lud_internal, 3 lud_internal_panel, 6 bf16
    # flash; nw 13 at out_depth 1-4; flash 13 at D 64 and 128, f32 and bf16
    # each; the lud perimeter kernel at bs 16, 32, 64;
    # pathfinder 13 (no out ring); hotspot 52 at out_depth 1-4
    if seen != {"matmul_bf16_kernel": 13, "matmul_bf16_batched_kernel": 22,
                "matmul_f32_kernel": 22, "tma": 32, "nw_kernel": 52,
                "flash_kernel": 26, "flash_bf16_kernel": 26, "perimeter": 3,
                "pathfinder_spans_kernel": 13, "hotspot_kernel": 52}:
        fail(f"sass: found {seen} kernels, not 13 bf16, 22 batched bf16 "
             f"and 22 f32 matmul, 32 TMA, 52 nw, 26 f32 and 26 bf16 flash "
             f"attention, 3 lud perimeter, 13 pathfinder, 52 hotspot")


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
    matmul.BATCHED_LAUNCHES = 0


def read_launches() -> dict:
    """Each kernel's launch counter: stream, hotspot, pathfinder, nw,
    lud_<kernel>, matmul (bf16), matmul-f32, matmul-batched (the bf16
    kernel over a stack of products) and flash_attention."""
    from repro_torch.kernels import (flash_attention, hotspot, lud, matmul,
                                     nw, pathfinder, stream)
    out = {"stream": stream.LAUNCHES, "hotspot": hotspot.LAUNCHES,
           "pathfinder": pathfinder.LAUNCHES, "nw": nw.LAUNCHES,
           "matmul": matmul.LAUNCHES["bfloat16"],
           "matmul-f32": matmul.LAUNCHES["float32"],
           "matmul-batched": matmul.BATCHED_LAUNCHES,
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


def verdict_of(ok: bool, planted: bool) -> str:
    """The end of a check's line: a sound check fails when not ``ok``, a
    check of a planted fault when ``ok``."""
    if planted:
        return " NOT REJECTED" if ok else " rejected"
    return "" if ok else " FAILED"


def held_logits(tag, what, got, want, atol, rtol, planted=False, vocab=None,
                also=True, note=""):
    """Hold logits ``got`` to ``want`` over their first ``vocab`` slots
    (all by default; the padding slots hold -1e30): max |diff| <= atol,
    relative l2 <= rtol and ``also`` (a further rule the caller states in
    ``note``).  With ``planted`` they come from a planted fault, which the
    check must reject.  -> (max |diff|, relative l2)."""
    got, want = got[..., :vocab].float(), want[..., :vocab].float()
    err = float((got - want).abs().max())
    rel = float((got - want).norm() / want.norm())
    ok = err <= atol and rel <= rtol and also
    print(f"{tag} {what}: max_abs_err {err:.4g} (at most {atol:.4g}), "
          f"relative l2 {rel:.3g} (at most {rtol:.3g}), |logits| <= "
          f"{float(want.abs().max()):.3g}{note}{verdict_of(ok, planted)}",
          flush=True)
    if ok == planted:
        fail(f"{tag} {what}: max_abs_err {err:.4g}, relative l2 {rel:.3g}"
             + (", inside the rule" if planted else ", beyond the rule"))
    return err, rel


def held_block(tag, what, got, want, tol, planted=False, also=True,
               note="") -> None:
    """A block's output ``got`` against its plain recomputation ``want``:
    max |diff| <= tol x max |want| and ``also`` (stated in ``note``); with
    ``planted`` the check must reject."""
    err = float((got.float() - want.float()).abs().max())
    lim = tol * float(want.float().abs().max())
    ok = err <= lim and also
    print(f"{tag} block {what}: max_abs_err {err:.4g} (at most {lim:.4g}, "
          f"{tol} of its largest value){note}{verdict_of(ok, planted)}",
          flush=True)
    if ok == planted:
        fail(f"{tag} block {what}: max_abs_err {err:.4g} against {lim:.4g}"
             f"{note}")


def model_launches() -> tuple:
    """(flash, bf16 matmul, f32 matmul) launch counters."""
    from repro_torch.kernels import flash_attention, matmul
    return (flash_attention.LAUNCHES, matmul.LAUNCHES["bfloat16"],
            matmul.LAUNCHES["float32"])


def row_invariance(model, cfg, g) -> None:
    """Each op of a decode step and of a prefill chunk, run by hand on
    layer 0 of the full-width model: does row 0 get the same bits when it
    shares the call with others?  Decode: batch 4 against its first row
    alone (embed, norm, the q/k/v/o products, rope, attend_decode and
    attend_paged whole and their pieces: the QK^T einsum, the masked
    softmax, the PV einsum, each as the model runs it on the card, in
    float64, and as the reference's f32 that the port ran before; the MLP,
    the residual, unembed); prefill_chunk: a chunk of 128 rows against its
    first 64 (the same ops, attend_prefix for the attention, over one
    cache view).  Fails on an op of the model's path whose rows differ;
    the f32 einsums are printed as what was repaired."""
    import torch
    from repro_torch.models import attention as attn
    from repro_torch.models import layers as lyr
    from repro_torch.models import transformer as tfm
    dev, cdt = torch.device("cuda"), torch.bfloat16
    layer = model.net["layers"][0]
    hd, kvh, h = cfg.head_dim_, cfg.n_kv_heads, cfg.n_heads
    idx_map = attn.kv_index_map(h, kvh, h)
    theta = cfg.attn.rope_theta

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(cdt)

    def pieces(q, kc, vc, pc, qpos, chunk: bool):
        """attend_decode / attend_prefix's einsums and softmax, as the
        model runs them on the card (f64) and in f32."""
        eq_qk, eq_pv = (("bchd,bwhd->bhcw", "bhcw,bwhd->bchd") if chunk
                        else ("bhd,bwhd->bhw", "bhw,bwhd->bhd"))
        qf = attn._scaled(q if chunk else q[:, 0], 1.0 / hd ** 0.5)
        k_rep, v_rep = attn._take_heads(kc, idx_map), \
            attn._take_heads(vc, idx_map)
        exact = not chunk               # the model's choice on the card
        out = {}
        lg = torch.einsum(eq_qk, attn._sums(qf, exact),
                          attn._sums(k_rep, exact)).float()
        out["QK einsum"] = lg
        if chunk:
            mask = ((pc[:, None, :] >= 0)
                    & (pc[:, None, :] <= qpos[:, :, None]))[:, None]
        else:
            mask = ((pc >= 0) & (pc <= qpos[:, None]))[:, None, :]
        p = torch.softmax(lg.masked_fill(~mask, attn.NEG), dim=-1)
        out["softmax"] = p
        out["PV einsum"] = torch.einsum(
            eq_pv, attn._sums(p.to(cdt), exact),
            attn._sums(v_rep, exact)).float()
        if not chunk:
            out["QK einsum f32 (before)"] = torch.einsum(
                eq_qk, qf.float(), k_rep.float())
            out["PV einsum f32 (before)"] = torch.einsum(
                eq_pv, p.to(cdt).float(), v_rep.float())
        return out

    def step(tokens, qpos, kc, vc, pc, table, paged, chunk: bool):
        """Every op of layer 0 on these rows (B slots, or C chunk rows),
        each from the same inputs (not chained), keyed by name."""
        out = {}
        positions = qpos[:, None] if not chunk else qpos
        x = model.net["embed"](tokens, cdt)
        out["embed"] = x
        hn = layer["ln_attn"](x)
        out["norm"] = hn
        for nm in ("wq", "wk", "wv"):
            out[f"{nm} product"] = lyr.linear(layer["attn"][nm], hn, cdt)
        b_, s_ = hn.shape[:2]
        q = lyr.linear(layer["attn"]["wq"], hn, cdt).reshape(b_, s_, h, hd)
        out["rope"] = lyr.rope(q, lyr.rope_tables(positions, hd, theta))
        q = out["rope"]
        if chunk:
            out["attend_prefix"] = attn.attend_prefix(
                q, kc, vc, pc, idx_map, q_positions=qpos)
        else:
            out["attend_decode"] = attn.attend_decode(
                q, kc, vc, pc, idx_map, q_position=qpos)
            out["attend_paged"] = attn.attend_paged(
                q, paged[0], paged[1], paged[2], table, idx_map,
                q_position=qpos)
        out.update(pieces(q, kc, vc, pc, qpos, chunk))
        heads = out["attend_prefix" if chunk else "attend_decode"]
        out["wo product"] = attn.attn_out(layer["attn"], heads, cfg, cdt)
        x2 = x + out["wo product"]
        out["residual"] = x2
        out["ln_mlp"] = layer["ln_mlp"](x2)
        out["mlp"] = layer["mlp"](out["ln_mlp"], cdt)
        out["unembed"] = tfm.unembed(model.net, x2)
        return out

    def report(what, pairs):
        """Print each op's verdict; fail on an op of the model's path
        whose rows differ."""
        same = {k: bool(torch.equal(a, b)) for k, (a, b) in pairs.items()}
        bad = [k for k, ok in same.items() if not ok and "(before)" not in k]
        cells = [f"{k} =" if ok else "%s DIFFERS (max |diff| %.3g)" % (
            k, float((pairs[k][0].float() - pairs[k][1].float()).abs()
                     .max())) for k, ok in same.items()]
        print(f"model row invariance, {what} (layer 0): " + ", ".join(cells)
              + (" FAILED" if bad else ""), flush=True)
        if bad:
            fail(f"model row invariance, {what}: {bad} give a row other "
                 f"bits")

    with torch.no_grad():
        # decode: 4 slots at their own positions over a W-row cache, and
        # the same rows through a block arena of 16-row blocks
        b, w, bl = 4, 544, 16
        mb = w // bl
        qpos = torch.tensor([500, 263, 317, 41], dtype=torch.int32,
                            device=dev)
        tokens = torch.randint(0, cfg.vocab, (b, 1), generator=g,
                               device=dev, dtype=torch.int32)
        kc, vc = rnd(b, w, kvh, hd), rnd(b, w, kvh, hd)
        ar = torch.arange(w, device=dev, dtype=torch.int32)
        pc = torch.where(ar[None, :] <= qpos[:, None], ar[None, :], -1)
        table = (1 + torch.arange(b * mb, device=dev, dtype=torch.int32)
                 ).reshape(b, mb)
        kb = torch.cat([rnd(1, bl, kvh, hd), kc.reshape(b * mb, bl, kvh,
                                                        hd)])
        vb = torch.cat([rnd(1, bl, kvh, hd), vc.reshape(b * mb, bl, kvh,
                                                        hd)])
        pb = torch.cat([torch.full((1, bl), -1, dtype=torch.int32,
                                   device=dev), pc.reshape(b * mb, bl)])
        full = step(tokens, qpos, kc, vc, pc, table, (kb, vb, pb), False)
        one = step(tokens[:1], qpos[:1], kc[:1], vc[:1], pc[:1], table[:1],
                   (kb, vb, pb), False)
        report("decode step batch 4 against its row 0 alone",
               {k: (full[k][:1], one[k]) for k in full})
        # prefill_chunk: 128 rows of one request at positions 256-383 over
        # a 512-row view, against its first 64
        c0, wv = 256, 512
        qp = (c0 + torch.arange(128, device=dev, dtype=torch.int32))[None]
        tokens = torch.randint(0, cfg.vocab, (1, 128), generator=g,
                               device=dev, dtype=torch.int32)
        kc, vc = rnd(1, wv, kvh, hd), rnd(1, wv, kvh, hd)
        ar = torch.arange(wv, device=dev, dtype=torch.int32)
        pc = torch.where(ar < c0 + 128, ar, -1)[None]
        full = step(tokens, qp, kc, vc, pc, None, None, True)
        half = step(tokens[:, :64], qp[:, :64], kc, vc, pc, None, None, True)

        def rows64(t, k):
            # (1, C, ...) row-major outputs; the einsums' and softmax's
            # query axis is 2 ("bhcw")
            return t[:, :, :64] if k in ("QK einsum", "softmax") \
                else t[:, :64]
        report("prefill_chunk 128 rows against its first 64",
               {k: (rows64(full[k], k), half[k]) for k in full})


#: rows of the model's products held to the plain version: a decode step
#: at MODEL_B slots, and a prefill of MODEL_B prompts of MODEL_S
MODEL_PRODUCT_M = (MODEL_B, MODEL_B * MODEL_S)
#: the products' tolerance: |kernel - plain| <= MODEL_PRODUCT_RTOL times
#: the sum of the |products| (both are f32 sums of the same exact
#: products, in other orders), elementwise, plus MODEL_PRODUCT_ATOL
MODEL_PRODUCT_RTOL, MODEL_PRODUCT_ATOL = 1e-5, 1e-6


def model_products(model, cfg, g) -> None:
    """Each product of the model on the matmul kernel, as ``linear`` and
    ``unembed`` call it (``kernel_product`` on the weight's cached
    ``kernel_operand``: rows padded to 128, K and N to 128-multiples, the
    tied unembedding transposed), held to ``matmul_plain`` on the same
    bf16 (f32 for unembed) operands at every M of MODEL_PRODUCT_M: layer
    0's q, k, v, o, gate, up and down (N 1536, 256, 256, 1536, 8960, 8960,
    1536; down at K = 8960) on the bf16 kernel, and unembed at N = 151,936
    on the f32 kernel's launch plan (256-wide tiles, then a 128-column
    strip).  The operands are N(0, 1) rows rounded to bf16.  Fails on an
    element past the tolerance or a launch count other than the plan's."""
    import torch
    from repro_torch.kernels import matmul
    from repro_torch.models.layers import (MODEL_MATMUL_SPEC, kernel_operand,
                                           kernel_product)
    dev = torch.device("cuda")
    layer0 = model.net["layers"][0]
    cases = [(f"layer 0 {nm}", p_["w"], torch.bfloat16, False)
             for nm, p_ in (("wq", layer0["attn"]["wq"]),
                            ("wk", layer0["attn"]["wk"]),
                            ("wv", layer0["attn"]["wv"]),
                            ("wo", layer0["attn"]["wo"]),
                            ("gate", layer0["mlp"]["gate"]),
                            ("up", layer0["mlp"]["up"]),
                            ("down", layer0["mlp"]["down"]))]
    tied = cfg.tie_embeddings
    cases.append(("unembed", model.net["embed"]["emb"] if tied
                  else model.net["unembed"]["w"], torch.float32, tied))
    with torch.no_grad():
        for what, w, dtype, transpose in cases:
            w_ = (w.t() if transpose else w).to(dtype)   # (K, N) as used
            k, n = w_.shape
            op = kernel_operand(w, dtype, transpose=transpose)
            key = str(dtype).removeprefix("torch.")
            for m in MODEL_PRODUCT_M:
                a = torch.randn(m, k, generator=g, device=dev).bfloat16() \
                    .to(dtype)
                before = matmul.LAUNCHES[key]
                got = kernel_product(a, op)[:, :n]
                n_launch = matmul.LAUNCHES[key] - before
                want = matmul.matmul_plain(a, w_)
                tol = torch.matmul(a.float().abs(), w_.float().abs()) \
                    .mul_(MODEL_PRODUCT_RTOL).add_(MODEL_PRODUCT_ATOL)
                diff = (got - want).abs()
                ratio = float((diff / tol).max())
                plan = matmul.launches(dtype, MODEL_MATMUL_SPEC.strategy,
                                       op.shape[1])
                ok = ratio <= 1.0 and n_launch == plan
                print(f"model product {what} (M, K, N) = ({m}, {k}, {n}) "
                      f"{key} on the kernel against matmul_plain: max_abs_err "
                      f"{float(diff.max()):.3g}, at most {ratio:.3g} of the "
                      f"tolerance ({MODEL_PRODUCT_RTOL} x sum |products| + "
                      f"{MODEL_PRODUCT_ATOL}); {n_launch} launches (plan "
                      f"{plan}){'' if ok else ' FAILED'}", flush=True)
                if not ok:
                    fail(f"model product {what} at M = {m}: {ratio:.3g} of "
                         f"the tolerance, {n_launch} launches (plan {plan})")
                del got, want, tol, diff


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
    dense-cache path; that chunks of 64 and 128 write bit-identical K/V
    rows and last-row logits, that each of layer 0's products gives a row
    the same bits at M = 64 and 128, and ``row_invariance``; prefill,
    decode and paged decode times beside their bounds, and the flash
    kernel's share of a prefill from torch.profiler; after the counters
    are read, ``model_products`` and layer 0's flash call against their
    plain versions.  Returns
    (flash_attention-bf16, strategy) -> launches, and (matmul, TMA) and
    (matmul-f32, TMA): the launches of the model's products."""
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.async_pipeline import Strategy
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import MODEL_MATMUL_SPEC, linear
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
        held_logits("model", what, got, want, MODEL_ATOL, MODEL_REL_L2,
                    planted)

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
    logits_same = torch.equal(l64, l128)
    print(f"model chunk sizes {PAGED_CHUNKS[0]} and {PAGED_CHUNKS[1]} on the "
          f"card: K/V rows bit-identical in {sum(same)} of {cfg.n_layers} "
          f"layers (first differing layer "
          f"{same.index(False) if False in same else None}, max |diff| "
          f"{float((a64.k.float() - a128.k.float()).abs().max()):.3g}), "
          f"last-row logits bit-identical {logits_same} (max "
          f"|diff| {float((l64 - l128).abs().max()):.3g})"
          f"{'' if all(same) and logits_same else ' FAILED'}", flush=True)
    if not (all(same) and logits_same):
        fail(f"model: prefill chunks of {PAGED_CHUNKS[0]} and "
             f"{PAGED_CHUNKS[1]} are not bit-identical ({sum(same)} of "
             f"{cfg.n_layers} layers' K/V rows, logits {logits_same})")
    del runs, a64, a128
    # every product gives a row the same bits at M = 64 and at M = 128:
    # the matmul kernel's sums run in one K order whatever M is
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
    if not all(rows.values()):
        fail(f"model: products whose rows differ at M = 64 and 128: "
             f"{[k for k, v in rows.items() if not v]}")
    row_invariance(model, cfg, g)

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
                   whole=lambda ev: sum(is_flash(n_) for n_, _ in ev)
                   >= cfg.n_layers)
    if res is not None:
        wall, events = res
        flash = [ms for n_, ms in events if is_flash(n_)]
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
    # the model's products: every linear and unembed, on MODEL_MATMUL_SPEC
    for k in ("matmul", "matmul-f32"):
        launches[(k, MODEL_MATMUL_SPEC.strategy)] = counts[k]
        if not counts[k]:
            fail(f"model path: the {k} kernel was never launched")

    # after the counters are read: each product at the model's shapes,
    # and layer 0's flash call on the model's own q, k, v (B, H, S padded
    # to 128 rows, hd), against their plain versions
    from repro_torch.kernels import ops
    model_products(model, cfg, g)
    for batch_ in (prompt, ragged):
        with calls_of(ops, "flash_attention") as seen:
            model.prefill(batch_)
        (q_, k_, v_), kw, out, _ = seen[0]
        plain = flash_attention.flash_attention_plain(
            q_, k_, v_, causal=kw["causal"], window=kw["window"],
            scale=kw["scale"], kv_len=kw["kv_len"])
        err = float((out - plain).abs().max())
        ok = bool(torch.allclose(out, plain, rtol=2e-5, atol=2e-5))
        print(f"model layer 0 flash S={batch_['tokens'].shape[1]} "
              f"{tuple(q_.shape)} {q_.dtype} causal={kw['causal']} "
              f"window={kw['window']} kv_len={kw['kv_len']}: max_abs_err "
              f"{err:.3g} against the "
              f"plain version (rtol and atol 2e-5)"
              f"{'' if ok else ' FAILED'}", flush=True)
        if not ok:
            fail(f"model layer 0 flash S={batch_['tokens'].shape[1]}: "
                 f"max_abs_err {err:.3g} beyond 2e-5")
    # the logits check's power: a fault planted in layer 0's call
    for fault in MODEL_FAULTS:
        with calls_of(ops, "flash_attention", fault=fault):
            got = model.prefill(prompt)[0]
        close(f"prefill with a planted fault, layer 0's flash call at "
              f"{fault}, against chunked", got, chunked_logits, planted=True)
    # no backward pass: Model.loss under autograd raises before any launch
    # (the first product refuses, before flash is reached: neither the
    # matmul nor the flash kernel has a backward pass)
    before, refused = model_launches(), None
    with torch.enable_grad():
        try:
            model.loss({"tokens": toks[:, :128], "labels": toks[:, :128]})
        except ValueError as e:
            refused = str(e)
    n = sum(model_launches()) - sum(before)
    print(f"model loss under autograd with attention=\"flash\": "
          f"{'ValueError: ' + refused if refused else 'no error'}; {n} "
          f"flash and matmul launches", flush=True)
    if not refused or "backward pass" not in refused or n:
        fail("model loss under autograd: the kernels did not refuse before "
             "any launch")
    print(f"model path: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


#: phase 8, serving at full width: the trace (make_trace's arguments), the
#: arena's block length, the slots, the chunk of the chunked runs and the
#: shared-prefix trace's prefix and group
SERVE_TRACE = dict(kind="poisson", n_requests=8, rate=0.5,
                   prompt_lens=(64, 512), max_new=(8, 16), seed=0)
SERVE_BLOCK, SERVE_BATCH, SERVE_CHUNK = 16, 4, 64
SERVE_PREFIX = dict(prefix_len=256, prefix_group=4)
#: the serve/* cells' tokens by name prefix and serve/prefix/shared's hit
#: ratio: deterministic on any device and weights (the traces' max_new, no
#: EOS; the hit ratio is the scheduling's), the reference's in
#: experiments/baselines/BENCH_serve.json
SERVE_CELL_TOKENS = {"serve/poisson/": 411, "serve/prefix/": 269,
                     "serve/bursty/": 76, "serve/uniform/": 35}
#: the depth of qwen2-1.5b the ServingLoop runs and their oracles take here
#: (every width as published; phase 7 checks the model at its 28 layers):
#: the serving contract, each request's tokens bit-identical to its
#: oracle's, does not depend on depth, and at 28 layers these host-bound
#: runs took about 101 s of the phase's 116 s on a slow host (an NVIDIA
#: H100 80GB HBM3 at 700 W)
SERVE_LAYERS = 4
SERVE_HIT_RATIO = 0.6100
#: the decode bound's cached rows a slot: phase 7's 512-token prompts and
#: 16 of their new tokens
SERVE_BOUND_ROWS = 528


def serving_path(card: str) -> dict:
    """Phase 8, serving at full width: qwen2-1.5b (SERVE_LAYERS of its 28
    layers, published widths, weights from a seeded generator,
    attention="flash") served by ``repro_torch.serve`` over a paged arena of
    SERVE_BLOCK-row blocks, on SERVE_TRACE.  The launch counters are set to 0
    just before the main run (FIFO at batch SERVE_BATCH) and read just after:
    flash one a layer a monolithic prefill, the matmul kernel 7 a layer bf16
    and 2 f32 (unembed) a model call.  Checks that fail the run: FIFO and
    reversed arrivals at batch 4 give each request's tokens served alone
    through a batch-4 scheduler (fixed slot count); chunked prefill
    (SERVE_CHUNK), FIFO and reversed, against a chunked solo oracle, with no
    flash launch; batch 4 and 2 against a solo oracle at batch 1 (across batch
    widths); a shared-prefix trace shared against not shared, with a hit ratio
    above 0; the arena drained after every run; one decode_paged call's matmul
    launches; the nine serve/* cells through bench.runner at smoke size with
    the reference's counts, each alone, with flash launches in every cell that
    prefills whole prompts and none in the chunked ones.  Prints tokens/s, TTFT
    and decode percentiles (decode beside its bound), occupancy and the phase's
    seconds.  Returns the main run's launches by (kernel, strategy)."""
    import torch
    from repro_torch.bench import runner, scenario
    from repro_torch.configs import get_config
    from repro_torch.core.async_pipeline import Strategy
    from repro_torch.kernels import flash_attention, matmul, ops
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import MODEL_MATMUL_SPEC
    from repro_torch.serve import (ContinuousScheduler, Request, make_trace,
                                   next_pow2)
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    ops.reset_default_configs()
    cfg = dataclasses.replace(get_config(MODEL_ARCH), n_layers=SERVE_LAYERS)
    model = build_model(cfg, attention="flash", device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    L = cfg.n_layers
    print(f"serve model: {MODEL_ARCH} at {L} of its 28 layers, every width "
          f"as published", flush=True)
    # a model call's launches: 7 products a layer (q, k, v, o, gate, up,
    # down) on the bf16 kernel, unembed on the f32 kernel's launch plan
    bf16_call = 7 * L
    f32_call = matmul.launches(torch.float32, MODEL_MATMUL_SPEC.strategy,
                               tfm.padded_vocab(cfg))
    tr = dict(SERVE_TRACE)
    kind = tr.pop("kind")
    trace = make_trace(kind, vocab=cfg.vocab, **tr)
    ptrace = make_trace(kind, vocab=cfg.vocab, **tr, **SERVE_PREFIX)
    bl = SERVE_BLOCK

    def max_seq(reqs):
        return max(max(next_pow2(len(r.prompt)), len(r.prompt) + r.max_new)
                   for r in reqs) + bl

    def fresh(reqs, reverse=False, solo=False):
        arr = [r.arrival for r in reqs]
        return [Request(uid=r.uid, prompt=r.prompt, max_new=r.max_new,
                        arrival=0.0 if solo else
                        arr[len(reqs) - 1 - i] if reverse else arr[i])
                for i, r in enumerate(reqs)]

    def sched(batch, reqs=trace, **kw):
        return ContinuousScheduler(model, batch=batch, max_seq=max_seq(reqs),
                                   block_len=bl, max_new=16, **kw)

    seconds = {}

    def served(what, s, reqs):
        t_run = time.perf_counter()
        out = s.run(reqs, max_steps=64)
        seconds[what] = seconds.get(what, 0.0) + time.perf_counter() - t_run
        if s.cache.used_blocks or s.cache.reserved_blocks:
            fail(f"serve {what}: the arena did not drain ("
                 f"{s.cache.used_blocks} used, {s.cache.reserved_blocks} "
                 f"reserved blocks)")
        want = {r.uid: r.max_new for r in reqs}
        if {u: len(t) for u, t in out.items()} != want:
            fail(f"serve {what}: tokens a request "
                 f"{ {u: len(t) for u, t in out.items()} }, not {want}")
        return out

    def solo_oracle(s, reqs):
        out = {}
        for r in fresh(reqs, solo=True):
            out.update(served("solo", s, [r]))
        return out

    def same(what, got, want):
        diff = {u: (got.get(u), want[u]) for u in want
                if got.get(u) != want[u]}
        print(f"serve {what}: {len(want) - len(diff)} of {len(want)} "
              f"requests' tokens identical"
              + ("" if not diff else f" FAILED; differing: {diff}"),
              flush=True)
        if diff:
            fail(f"serve {what}: requests {sorted(diff)} differ")

    print(f"serve trace: {kind} {len(trace)} requests, rate "
          f"{tr['rate']}, prompts {[len(r.prompt) for r in trace]}, "
          f"max_new {[r.max_new for r in trace]}, arrivals "
          f"{[round(r.arrival, 2) for r in trace]}; blocks of {bl}, "
          f"max_seq {max_seq(trace)}", flush=True)
    # 1. the main run: FIFO at batch 4, the counters around it
    s4 = sched(SERVE_BATCH)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    fifo = served("fifo", s4, fresh(trace))
    wall = time.perf_counter() - t0
    counts = read_launches()
    snap = {row["name"]: row for row in s4.metrics.snapshot()}
    steps = int(snap["serve.decode_ms"]["count"])
    calls = len(trace) + steps
    print(f"serve launches, FIFO batch {SERVE_BATCH}: flash "
          f"{counts['flash_attention']} ({L} x {len(trace)} prefills), "
          f"matmul bf16 {counts['matmul']} and f32 {counts['matmul-f32']} "
          f"({len(trace)} prefills + {steps} decode steps = {calls} model "
          f"calls x {bf16_call} and x {f32_call})", flush=True)
    for k, want in (("flash_attention", L * len(trace)),
                    ("matmul", calls * bf16_call),
                    ("matmul-f32", calls * f32_call)):
        if counts[k] != want:
            fail(f"serve launches: {k} {counts[k]}, not {want}")
    launches = {("flash_attention-bf16", Strategy.OVERLAP):
                counts["flash_attention"],
                ("matmul", MODEL_MATMUL_SPEC.strategy): counts["matmul"],
                ("matmul-f32", MODEL_MATMUL_SPEC.strategy):
                counts["matmul-f32"]}
    n_tok = sum(len(t) for t in fifo.values())
    ttft, dec = snap["serve.ttft_ms"], snap["serve.decode_ms"]
    n_params = sum(p.numel() for p in model.net.parameters())
    kv_row = 2 * L * cfg.n_kv_heads * cfg.head_dim_ * 2
    mm = L * (2 * cfg.d_model * cfg.n_heads * cfg.head_dim_
              + 2 * cfg.d_model * cfg.n_kv_heads * cfg.head_dim_
              + 3 * cfg.d_model * cfg.d_ff)
    b_, s_ = SERVE_BATCH, SERVE_BOUND_ROWS
    least, by = bound(2 * mm * b_ + 4 * L * b_ * cfg.n_heads * s_
                      * cfg.head_dim_ + 2 * b_ * cfg.d_model * cfg.vocab,
                      n_params * 2 + b_ * s_ * kv_row, BF16_TC_OPS_PER_S)
    print(f"serve time FIFO batch {SERVE_BATCH}: {n_tok} tokens in "
          f"{wall:.3f} s, {n_tok / wall:.2f} tokens/s; TTFT p50 "
          f"{ttft['p50']:.2f} ms p99 {ttft['p99']:.2f} ms; decode p50 "
          f"{dec['p50']:.3f} ms p99 {dec['p99']:.3f} ms a step ({steps} "
          f"steps; bound {least:.4f} ms by {by} at B = {b_}, {s_} cached "
          f"rows: bf16 weights and K/V rows at 3.35 TB/s); occupancy mean "
          f"{snap['serve.batch_occupancy']['mean']:.3f} ({card})",
          flush=True)
    # one decode call's products, counted alone
    arena = tfm.init_paged_state(cfg, 1 + b_ * 2, bl, device=dev)
    table = (1 + torch.arange(b_ * 2, device=dev, dtype=torch.int32)
             ).reshape(b_, 2)
    reset_launches()
    model.decode_paged(arena, torch.zeros((b_, 1), dtype=torch.int32,
                                          device=dev), table,
                       torch.zeros(b_, dtype=torch.int32, device=dev))
    one = read_launches()
    print(f"serve one decode_paged call (B = {b_}): matmul bf16 "
          f"{one['matmul']}, f32 {one['matmul-f32']}, flash "
          f"{one['flash_attention']}", flush=True)
    if (one["matmul"], one["matmul-f32"], one["flash_attention"]) != \
            (bf16_call, f32_call, 0):
        fail(f"serve one decode call: {one['matmul']} bf16, "
             f"{one['matmul-f32']} f32, {one['flash_attention']} flash "
             f"launches, not {bf16_call}, {f32_call}, 0")
    del arena
    # 2. fixed slot count: reversed arrivals at batch 4; each alone
    rev = served("reversed", sched(SERVE_BATCH), fresh(trace, reverse=True))
    oracle4 = solo_oracle(sched(SERVE_BATCH), trace)
    same("fixed slot count: FIFO at batch 4 against each alone in a batch-4 "
         "scheduler", fifo, oracle4)
    same("fixed slot count: reversed arrivals at batch 4 against each alone "
         "in a batch-4 scheduler", rev, oracle4)
    # 3. across batch widths: batch 4 and 2 against batch 1
    oracle1 = served("batch 1", sched(1), fresh(trace))
    b2 = served("batch 2", sched(2), fresh(trace))
    same("across batch widths: batch 4 against a solo oracle at batch 1",
         fifo, oracle1)
    same("across batch widths: batch 2 against a solo oracle at batch 1",
         b2, oracle1)
    # 4. chunked prefill: no flash launch; FIFO and reversed against a
    # chunked solo oracle
    before = model_launches()[0]
    chunk_fifo = served("chunked fifo",
                        sched(SERVE_BATCH, chunk_tokens=SERVE_CHUNK),
                        fresh(trace))
    chunk_rev = served("chunked reversed",
                       sched(SERVE_BATCH, chunk_tokens=SERVE_CHUNK),
                       fresh(trace, reverse=True))
    chunk_oracle = solo_oracle(sched(SERVE_BATCH, chunk_tokens=SERVE_CHUNK),
                               trace)
    n_flash = model_launches()[0] - before
    print(f"serve chunked runs (chunks of {SERVE_CHUNK}): {n_flash} flash "
          f"launches", flush=True)
    if n_flash:
        fail(f"serve chunked runs launched {n_flash} flash kernels")
    same(f"chunked prefill ({SERVE_CHUNK}) FIFO against a chunked solo "
         f"oracle", chunk_fifo, chunk_oracle)
    same(f"chunked prefill ({SERVE_CHUNK}) reversed against a chunked solo "
         f"oracle", chunk_rev, chunk_oracle)
    # 5. prefix sharing: shared against not shared
    shared_s = sched(SERVE_BATCH, ptrace, chunk_tokens=SERVE_CHUNK,
                     prefix_cache=True)
    shared = served("prefix shared", shared_s, fresh(ptrace))
    plain = served("prefix not shared",
                   sched(SERVE_BATCH, ptrace, chunk_tokens=SERVE_CHUNK),
                   fresh(ptrace))
    hit = shared_s.cache.cache_hit_ratio
    print(f"serve prefix trace: prefix {SERVE_PREFIX['prefix_len']} in "
          f"groups of {SERVE_PREFIX['prefix_group']}, prompts "
          f"{[len(r.prompt) for r in ptrace]}; cache_hit_ratio {hit:.4f} "
          f"({shared_s.cache.hit_tokens} hit, {shared_s.cache.miss_tokens} "
          f"missed prompt rows)", flush=True)
    if not hit > 0:
        fail(f"serve prefix sharing: cache_hit_ratio {hit}")
    same("prefix sharing: shared against not shared (check_outputs)",
         shared, plain)
    # 6. the serve/* cells through bench.runner at smoke size
    # (their monolithic prefills on the flash kernel, the smoke model's
    # head dim of 8 zero-padded up to 64; chunked cells launch none)
    t0 = time.perf_counter()
    rows = []
    for sc in scenario.scenarios(tag="serve"):
        before = flash_attention.LAUNCHES
        try:
            rows += [(r, flash_attention.LAUNCHES - before) for r in
                     runner.run_scenarios([sc], runner.RunOptions(
                         device="cuda", use_tuned=False)).results]
        except Exception as e:
            fail(f"serve cell {sc.name}: {type(e).__name__}: {e}")
    for r, n_flash in rows:
        m = r.metrics
        want = next(n for p_, n in SERVE_CELL_TOKENS.items()
                    if r.scenario.startswith(p_))
        chunked_cell = bool(r.config.get("chunk_tokens"))
        ok = m["tokens"] == want and (n_flash == 0) == chunked_cell
        extra = ""
        if r.scenario == "serve/prefix/shared":
            ok = ok and round(m["cache_hit_ratio"], 4) == SERVE_HIT_RATIO \
                and m["outputs_equal"]
            extra = (f" cache_hit_ratio {m['cache_hit_ratio']:.4f} "
                     f"outputs_equal {m['outputs_equal']}")
        print(f"serve cell {r.scenario}: {m['tokens']} tokens (the "
              f"reference's {want}), {m['tokens_per_s']:.1f} tokens/s, "
              f"decode p50 {m['decode_ms_p50']:.3f} ms, TTFT p99 "
              f"{m['ttft_ms_p99']:.2f} ms, occupancy "
              f"{m['occupancy_mean']:.3f}, attention "
              f"{r.config['attention']}, {n_flash} flash launches"
              f"{extra}{'' if ok else ' FAILED'}", flush=True)
        if not ok:
            fail(f"serve cell {r.scenario}: {m['tokens']} tokens (want "
                 f"{want}), {n_flash} flash launches{extra}")
    if len(rows) != 9:
        fail(f"serve cells: {len(rows)} of 9 ran")
    seconds["serve/* cells"] = time.perf_counter() - t0
    print("serve seconds by run: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()), flush=True)
    print(f"serving path: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


#: phase 9, the moe family at full width: its arch (24 layers, d_model
#: 2048, 16 heads of 128, 60 routed experts top-4 of ff 1408 and 4 shared,
#: vocab 151936), on phase 7's MODEL_B prompts of MODEL_S tokens
MOE_ARCH = "qwen2-moe-a2.7b"
#: its depth here: 12 of its 24 layers (every width as published), so
#: that the run keeps a margin under its 600 s on a slow host (at 24
#: layers the phase took 40.2 s on one H100 machine and 79.2 s on
#: another, the host-bound phases running up to twice as long there)
MOE_LAYERS = 12
#: the routing-flip rule.  Two paths that route on their own (flash
#: against the chunked scan, decode against forward, paged against dense)
#: can send a token to another k-th expert on a last-bit difference of the
#: router's f32 logits, and the row then differs by a whole expert; that
#: token's K and V move every later token's attention, whose routing then
#: flips too, layer after layer.  So each path's oracle takes the path's
#: own top-k ids (``pinned_routes``; capacity then keeps the same
#: assignments) and every row of the logits is held to MODEL_ATOL and
#: MODEL_REL_L2; beside it the oracle runs routing on its own, and the
#: share of rows it sends elsewhere in layer 0, before any cascade, is held
#: to MOE_FLIP_SHARE (any layer's share is printed)
MOE_FLIP_SHARE = 0.05
#: layer 0's moe block against its plain recomputation given the same
#: top-k ids: max |diff| <= MOE_BLOCK_TOL x max |plain| (a few bf16 ulps:
#: the products' f32 sums in another order round to bf16 apart)
MOE_BLOCK_TOL = 2 ** -5
#: the chunk widths of the paged path, each held against its own oracle
MOE_CHUNKS = (64, 128)
#: (E, M, K, N) of the batched launch's walk checks: 7 experts of three
#: 128-row tiles, one expert of one tile (fewer tiles than blocks), 60
#: experts of two 256-row tiles
BATCHED_WALKS = ((7, 384, 384, 640), (1, 128, 128, 128), (60, 512, 2048, 1408))


@contextlib.contextmanager
def moe_routes():
    """Every moe call's assignments in call order (layer order within a
    model call), each (T k,) in token order: the expert id where the
    assignment was kept, -1 - id where capacity dropped it."""
    import torch
    from repro_torch.models import moe
    real, seen = moe._slots, []

    def record(flat_e, cap, e_local, lo):
        kept, slot = real(flat_e, cap, e_local, lo)
        seen.append(torch.where(kept, flat_e, -1 - flat_e))
        return kept, slot
    moe._slots = record
    try:
        yield seen
    finally:
        moe._slots = real


@contextlib.contextmanager
def pinned_routes(routes):
    """Every moe call takes its top-k ids, in order, from ``routes`` (one
    call's assignments each, as ``moe_routes`` records them, in call
    order) and its weights from its own router at those ids: an oracle
    that routes as the path it checks did, so that the two differ by
    their arithmetic alone."""
    import torch
    from repro_torch.models import moe
    real, queue = moe._route, iter(routes)

    def pinned(x_flat, router, cfg, n_total):
        probs, _, _ = real(x_flat, router, cfg, n_total)
        sig = next(queue)
        ids = torch.where(sig >= 0, sig, -1 - sig).reshape(x_flat.shape[0],
                                                           -1)
        top_p = probs.gather(1, ids)
        return probs, top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9), \
            ids
    moe._route = pinned
    try:
        yield
    finally:
        moe._route = real


@contextlib.contextmanager
def no_drops(model):
    """Every moe layer of ``model`` at a capacity factor of E / k, so that
    an expert takes all T tokens of a call and no assignment is dropped:
    the capacity decode has at T = B (4 >= T), for a forward over many
    tokens."""
    layers = [layer["moe"] for layer in model.net["layers"]]
    cfg = model.cfg
    whole = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    for m in layers:
        m.cfg = whole
    try:
        yield
    finally:
        for m in layers:
            m.cfg = cfg


@contextlib.contextmanager
def model_spec(spec):
    """The model's products (``layers.MODEL_MATMUL_SPEC``) on ``spec``."""
    from repro_torch.models import layers
    real = layers.MODEL_MATMUL_SPEC
    layers.MODEL_MATMUL_SPEC = spec
    try:
        yield
    finally:
        layers.MODEL_MATMUL_SPEC = real


def moe_block_plain(p, x, cfg, sig):
    """Layer ``p``'s moe block on x (B, S, d) in plain torch, given the
    assignments ``sig`` (T k,) the model made (``moe_routes``): the router's
    probabilities at those ids from an f32 product, each assignment kept
    where it is among the first ``capacity`` of its expert in token order
    (counted here by a cumulative sum, not the model's sort), each expert's
    rows through its swiglu FFN one expert at a time (f32 products of the
    bf16 operands, rounded to bf16 where the model rounds), the combine
    over j = 0..k-1, the shared experts and their f32 sigmoid gate.
    -> (out (B, S, d) bf16, the assignments whose kept flag the count here
    and the model disagree on)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import moe
    cdt = torch.bfloat16
    b, s, d = x.shape
    t, k, n_e = b * s, cfg.moe.top_k, p["w_gate"].shape[0]
    xf = x.reshape(t, d)
    ids = torch.where(sig >= 0, sig, -1 - sig).reshape(t, k)
    probs = torch.softmax(xf.float() @ p["router"]["w"].float(), dim=-1)
    top_p = probs.gather(1, ids)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    flat = ids.reshape(-1)
    onehot = F.one_hot(flat, n_e)
    rank = (onehot.cumsum(0) - onehot).gather(1, flat[:, None])[:, 0]
    kept = rank < moe.capacity(cfg, t)
    disagree = int((kept != (sig >= 0)).sum())
    y = torch.zeros(t * k, d, dtype=cdt, device=x.device)
    tok = torch.arange(t * k, device=x.device) // k
    for e in range(n_e):
        rows = torch.nonzero((flat == e) & kept)[:, 0]
        if not len(rows):
            continue
        xe = xf[tok[rows]].to(cdt).float()
        g = (xe @ p["w_gate"][e].to(cdt).float()).to(cdt)
        u = (xe @ p["w_up"][e].to(cdt).float()).to(cdt)
        h = (F.silu(g) * u).float()
        y[rows] = (h @ p["w_down"][e].to(cdt).float()).to(cdt)
    w = torch.where(kept, top_p.reshape(-1), 0.0).to(cdt).reshape(t, k)
    y = y.reshape(t, k, d)
    out = torch.zeros(t, d, dtype=cdt, device=x.device)
    for j in range(k):
        out = out + y[:, j] * w[:, j:j + 1]
    if cfg.moe.n_shared > 0:
        sh = p["shared"]
        x16 = xf.to(cdt).float()
        hid = F.silu((x16 @ sh["gate"]["w"].to(cdt).float()).to(cdt)) * \
            (x16 @ sh["up"]["w"].to(cdt).float()).to(cdt)
        shared = (hid.float() @ sh["down"]["w"].to(cdt).float()).to(cdt)
        gate = torch.sigmoid(xf.float() @ sh["sgate"]["w"].float()).to(cdt)
        out = out + shared * gate
    return out.reshape(b, s, d), disagree


def moe_path(card: str, timing: dict, max_err: dict) -> dict:
    """``moe_phase`` without autograd (the model's products have no
    backward pass on the card)."""
    import torch
    with torch.no_grad():
        return moe_phase(card, timing, max_err)


def moe_phase(card: str, timing: dict, max_err: dict) -> dict:
    """Phase 9, the moe family at full width: MOE_ARCH at its published
    widths and MOE_LAYERS deep (weights from a seeded generator,
    attention="flash")
    through the model's entry points and ServingLoop.  After phases 7 and
    8 free their models.  Before the counters: the batched launch at layer
    0's expert products (decode, T = B: 128 rows an expert; prefill, T =
    B S: 256) at every strategy against ``matmul_batched_plain``, each
    expert bit-identical to ``matmul_cuda`` at the same strategy and a
    prefill's rows 0-127 to a call of those rows alone, the walk shapes
    ``BATCHED_WALKS`` at every strategy and TMA at depths 3 and 4, the
    router and sigmoid gate products on the f32 kernel, each within 1e-5
    of the sum of |products|; the batched launch's time at every strategy
    and TMA at depths 3 and 4 at the decode and prefill shapes beside
    its bound, its plain version and one ``torch.bmm`` (the prefill's at
    each strategy's default ring into ``timing`` and ``max_err``).  Then,
    the launch
    counters set to 0 just before and read just after: a prefill of the
    prompts at each strategy of the model's products, held against
    attention="chunked"; ``forward`` over the prompts, flash against
    chunked, every row; 32 greedy decode steps, 4 held against forward;
    each prompt in chunks of 64 and 128, chunk 0 against a dense prefill of
    its tokens (the same capacity), and decode_paged over the 64-chunk
    arena against decode_step over the same rows copied into a dense
    cache; all under the routing-flip rule (MOE_FLIP_SHARE).  After them:
    each kernel's launches a forward (3 batched a layer), the share of
    assignments capacity dropped in layer 0 at each call shape, layer 0's
    moe block against ``moe_block_plain`` on its own inputs, a planted
    fault (one expert's w_up rows permuted in layer 0) that the block
    check and the flip rule must both reject, a decode step at batch B
    bit-identical row by row to each row alone, ServingLoop on SERVE_TRACE
    (FIFO and reversed at batch 4, bit-identical greedy tokens to each
    request alone), prefill and decode times beside their bounds, the
    peak memory and the phase's seconds.  Returns the launches by
    (kernel, strategy)."""
    import gc
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.async_pipeline import PipelineSpec, Strategy
    from repro_torch.kernels import matmul, ops
    from repro_torch.launch.serve import ServingLoop
    from repro_torch.models import build_model
    from repro_torch.models import layers as lyr
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import Request, make_trace, next_pow2
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda")
    held_before = torch.cuda.memory_allocated()
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    b, s, new = MODEL_B, MODEL_S, MODEL_NEW
    L, k_top, n_e = cfg.n_layers, cfg.moe.top_k, cfg.moe.n_experts
    ops.reset_default_configs()
    t0 = time.perf_counter()
    model = build_model(cfg, attention="flash", device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    chunked = model.with_attention("chunked")
    n_params = sum(p.numel() for p in model.net.parameters())
    sgate = L * cfg.d_model if cfg.moe.n_shared else 0
    print(f"moe model {cfg.name}: {L} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.head_dim_}, {n_e} experts top-"
          f"{k_top} of ff {cfg.moe.d_ff_expert}, {cfg.moe.n_shared} shared, "
          f"vocab {cfg.vocab}: {n_params} parameters, param_count() "
          f"{cfg.param_count()} + {sgate} (the {L} sigmoid gates of d x 1 "
          f"the analytic count omits), fp32; built and drawn in "
          f"{time.perf_counter() - t0:.1f} s, {held_before / 1e9:.2f} GB "
          f"held before ({card})", flush=True)
    if n_params != cfg.param_count() + sgate:
        fail(f"moe model: {n_params} parameters, not param_count() + "
             f"{sgate}")
    layer0 = model.net["layers"][0]["moe"]
    g = torch.Generator(device=dev).manual_seed(1)

    # -- the batched launch and the f32 products, at every strategy --------
    d, ff = cfg.d_model, cfg.moe.d_ff_expert
    cap_decode, cap_prefill = (moe_mod.capacity(cfg, t) for t in (b, b * s))
    cdt = torch.bfloat16
    stacks = {nm: layer0[nm].to(cdt) for nm in ("w_gate", "w_up", "w_down")}
    for what, cap in (("decode", cap_decode), ("prefill", cap_prefill)):
        rows = lyr.pad_to(cap, matmul.BLOCK)
        for nm, w in stacks.items():
            kk = w.shape[1]
            a = torch.zeros(n_e, rows, kk, device=dev, dtype=cdt)
            a[:, :cap] = torch.randn(n_e, cap, kk, generator=g,
                                     device=dev).to(cdt)
            want = matmul.matmul_batched_plain(a, w)
            tol = torch.bmm(a.float().abs(), w.float().abs()) \
                .mul_(MODEL_PRODUCT_RTOL).add_(MODEL_PRODUCT_ATOL)
            for st in Strategy:
                spec = PipelineSpec(st)
                before = matmul.BATCHED_LAUNCHES
                try:
                    got = matmul.matmul_batched_cuda(a, w, spec=spec)
                    # each expert on the 2-D kernel, and (prefill) rows
                    # 0-127 alone, at 128-row tiles: the same bits
                    solo = torch.stack([matmul.matmul_cuda(
                        a[i], w[i], spec=spec) for i in range(n_e)])
                    n_launch = matmul.BATCHED_LAUNCHES - before
                    top = None if rows == matmul.BLOCK else \
                        matmul.matmul_batched_cuda(
                            a[:, :matmul.BLOCK].contiguous(), w, spec=spec)
                except Exception as e:
                    fail(f"moe batched {nm} {what} {st.value}: "
                         f"{type(e).__name__}: {e}")
                    continue
                diff = (got - want).abs()
                ratio = float((diff / tol).max())
                err = float(diff.max())
                bits = torch.equal(got, solo) and (
                    top is None or torch.equal(got[:, :matmul.BLOCK], top))
                ok = ratio <= 1.0 and n_launch == 1 and bits
                print(f"moe batched product {nm} {what} {st.value} (E, M, K, "
                      f"N) = ({n_e}, {rows}, {kk}, {w.shape[2]}) ({cap} rows "
                      f"an expert, {matmul.batched_tile_rows(rows)} x "
                      f"{matmul.batched_tile_cols(rows, st)} tiles) against "
                      f"matmul_batched_plain: max_abs_err "
                      f"{err:.3g}, at most {ratio:.3g} of the tolerance; "
                      f"{n_launch} launch; each expert bit-identical to "
                      f"matmul_cuda {torch.equal(got, solo)}"
                      + ("" if top is None else
                         f", rows 0-127 to an M = 128 call "
                         f"{torch.equal(got[:, :matmul.BLOCK], top)}")
                      + ("" if ok else " FAILED"), flush=True)
                if not ok:
                    fail(f"moe batched product {nm} {what} {st.value}: "
                         f"{ratio:.3g} of the tolerance, {n_launch} "
                         f"launches, bit-identical {bits}")
                if what == "prefill" and nm == "w_gate":
                    max_err[("matmul-batched", st)] = err
                del got, diff, solo, top
            del a, want, tol
    # the walk: more row tiles than one (384 rows at 128-row tiles, 512 at
    # 256), fewer tiles than blocks (E = 1), K past the ring (TMA's phases
    # wrap inside a tile at depths 3 and 4)
    batched_specs = [PipelineSpec(st) for st in Strategy] + [
        PipelineSpec(Strategy.TMA, dp) for dp in (3, 4)]
    for shape in BATCHED_WALKS:
        ne, mp, kk, nn = shape
        a = torch.randn(ne, mp, kk, generator=g, device=dev).to(cdt)
        w = torch.randn(ne, kk, nn, generator=g, device=dev).to(cdt)
        want = matmul.matmul_batched_plain(a, w)
        tol = torch.bmm(a.float().abs(), w.float().abs()) \
            .mul_(MODEL_PRODUCT_RTOL).add_(MODEL_PRODUCT_ATOL)
        ratios = {}
        for spec in batched_specs:
            try:
                got = matmul.matmul_batched_cuda(a, w, spec=spec)
                ratios[spec] = float(((got - want).abs() / tol).max())
            except Exception as e:
                fail(f"moe batched walk {shape} {spec}: "
                     f"{type(e).__name__}: {e}")
        worst = max(ratios.values(), default=float("inf"))
        print(f"moe batched walk (E, M, K, N) = {shape} "
              f"({matmul.batched_tile_rows(mp)}-row tiles) against "
              f"matmul_batched_plain at {len(ratios)} specs (every "
              f"strategy, tma at depths 3 and 4): at most {worst:.3g} of "
              f"the tolerance{'' if worst <= 1 else ' FAILED'}", flush=True)
        if worst > 1:
            fail(f"moe batched walk {shape}: {worst:.3g} of the tolerance")
        del a, w, want, tol
    for what, w in (("router", layer0["router"]["w"]),
                    ("sgate", layer0["shared"]["sgate"]["w"])):
        op = lyr.kernel_operand(w, torch.float32)
        for m in MODEL_PRODUCT_M:
            a = torch.randn(m, d, generator=g, device=dev).bfloat16().float()
            got = lyr.kernel_product(a, op)[:, :w.shape[1]]
            want = matmul.matmul_plain(a, w.float())
            tol = (a.abs() @ w.float().abs()).mul_(MODEL_PRODUCT_RTOL) \
                .add_(MODEL_PRODUCT_ATOL)
            ratio = float(((got - want).abs() / tol).max())
            print(f"moe product {what} (M, K, N) = ({m}, {d}, {w.shape[1]}) "
                  f"float32 on the kernel against matmul_plain: at most "
                  f"{ratio:.3g} of the tolerance"
                  f"{'' if ratio <= 1 else ' FAILED'}", flush=True)
            if ratio > 1:
                fail(f"moe product {what} at M = {m}: {ratio:.3g} of the "
                     f"tolerance")
    # the batched launch's time at the decode and prefill shapes: A, B and
    # C moved once (B alone beside: every expert's weights), 2 E M K N
    # operations at the bf16 tensor-core rate; one torch.bmm the
    # yardstick; the prefill's times at each strategy's default ring are
    # the kernel line's
    w = stacks["w_gate"]
    for what, cap in (("decode", cap_decode), ("prefill", cap_prefill)):
        rows = lyr.pad_to(cap, matmul.BLOCK)
        a = torch.randn(n_e, rows, d, generator=g, device=dev).to(cdt)
        work = (2 * n_e * rows * d * ff, (a.numel() + w.numel()) * 2
                + n_e * rows * ff * 4, BF16_TC_OPS_PER_S)
        try:
            torch.bmm(a[:1, :128, :128], w[:1, :128, :128],
                      out_dtype=torch.float32)
            bmm = lambda: torch.bmm(a, w, out_dtype=torch.float32)  # noqa
            note = "bf16 in, f32 out"
        except (TypeError, RuntimeError):
            bmm = lambda: torch.bmm(a, w)                            # noqa
            note = "bf16 in, bf16 out (this torch has no out_dtype)"
        lib_ms = device_ms(bmm)
        plain_ms = device_ms(lambda: matmul.matmul_batched_plain(a, w),
                             reps=3)
        least, by = bound(*work)
        for spec in batched_specs:
            ms = device_ms(lambda: matmul.matmul_batched_cuda(a, w,
                                                              spec=spec))
            st = spec.strategy
            default = spec == PipelineSpec(st)
            if what == "prefill" and default:
                timing[("matmul-batched", st)] = (ms, plain_ms, lib_ms, work)
            print(f"moe time batched launch {what} {st.value}"
                  f"{'' if default else f' depth {spec.depth}'} ({n_e}, "
                  f"{rows}, {d}) x ({n_e}, {d}, {ff}): {ms:.4f} ms, bound "
                  f"{least:.4f} ms by {by} (B alone "
                  f"{w.numel() * 2 / HBM_BYTES_PER_S * 1e3:.4f} ms); plain "
                  f"{plain_ms:.4f} ms; torch.bmm ({note}) {lib_ms:.4f} ms "
                  f"({card})", flush=True)
        del a
    del w, stacks

    def apart(ra, rb):
        """(L, T): where a row's top-k set differs between two runs' routes
        (``moe_routes``, rows of both the same tokens), layer by layer."""
        def sets(r):
            return torch.stack([torch.where(x >= 0, x, -1 - x).reshape(
                -1, k_top).sort(-1).values for x in r])
        return (sets(ra) != sets(rb)).any(-1)

    def held(what, got, want, flips=None, planted=False):
        """``want`` from an oracle that took ``got``'s routes
        (``pinned_routes``): every row to MODEL_ATOL and MODEL_REL_L2.
        ``flips`` (L, T), from an oracle that routed on its own: the rows
        it sent elsewhere in layer 0, at most MOE_FLIP_SHARE, and in any
        layer (reported).  With ``planted`` the check must reject."""
        also, note = True, ""
        if flips is not None:
            first = float(flips[0].float().mean())
            also = first <= MOE_FLIP_SHARE
            by_layer = flips.float().mean(1)
            note = (f"; routing on its own, {flips.shape[1]} rows: layer 0 "
                    f"flipped {first:.4f} (at most {MOE_FLIP_SHARE}), any "
                    f"layer {float(flips.any(0).float().mean()):.4f}, layers "
                    f"0/{L // 4}/{L // 2}/{L - 1} "
                    + "/".join(f"{float(by_layer[i]):.4f}" for i in
                               (0, L // 4, L // 2, L - 1)))
        held_logits("moe", what, got, want, MODEL_ATOL, MODEL_REL_L2,
                    planted, also=also, note=note)

    def dropped(sig):
        return float((sig < 0).float().mean())

    toks = torch.randint(0, cfg.vocab, (b, s + new), generator=g, device=dev,
                         dtype=torch.int32)
    prompt = {"tokens": toks[:, :s]}
    drops = {}
    launches = {}
    # -- the main path, the counters around it ----------------------------
    torch.cuda.synchronize()
    reset_launches()
    # chunked routing on its own (its prefill's routes are its forward's:
    # the same layers on the same tokens)
    with moe_routes() as r_chunked:
        chunked.prefill(prompt, budget=s + new)
    for st in Strategy:
        before = matmul.BATCHED_LAUNCHES
        with model_spec(PipelineSpec(st)), moe_routes() as r_flash:
            got, state = model.prefill(prompt, budget=s + new)
        launches[("matmul-batched", st)] = matmul.BATCHED_LAUNCHES - before
        with pinned_routes(r_flash):
            want, _ = chunked.prefill(prompt, budget=s + new)
        held(f"prefill B={b} S={s}, products on {st.value} "
             f"({launches[('matmul-batched', st)]} batched launches): "
             f"last-token logits, flash against chunked on its routes",
             got, want, apart(r_flash, r_chunked))
        if st is lyr.MODEL_MATMUL_SPEC.strategy:
            dense = (got, state)
            drops[f"prefill T={b * s} cap {cap_prefill}"] = dropped(
                r_flash[0])
    with moe_routes() as r_ff:
        full_flash = model.forward(prompt)
    with pinned_routes(r_ff):
        full_chunked = chunked.forward(prompt)
    held(f"forward B={b} S={s}: every row's logits, flash against chunked "
         f"on its routes", full_flash, full_chunked, apart(r_ff, r_chunked))
    del full_flash, full_chunked

    # greedy decode, each step timed by CUDA events, from a prefill that
    # drops nothing (decode drops nothing at T = B), so that forward over
    # the whole sequence with no drop, on the prefill's and the steps'
    # routes, is its oracle (capacity counts every token of a call: a
    # forward over 2,176 tokens drops other assignments than a prefill
    # over 2,048 and the steps)
    with no_drops(model), moe_routes() as r_pre:
        logits, state = model.prefill(prompt, budget=s + new)
    tok = logits.argmax(-1).int()[:, None]
    fed, step_logits, step_routes, events = [], {}, [], []
    for t in range(new):
        fed.append(tok)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with moe_routes() as r_dec:
            e0.record()
            logits, state = model.decode_step(state, tok)
            e1.record()
        events.append((e0, e1))
        step_routes.append(r_dec)
        if t in MODEL_CHECK_STEPS:
            step_logits[t] = logits
        tok = logits.argmax(-1).int()[:, None]
    torch.cuda.synchronize()
    decode_ms = statistics.median(a_.elapsed_time(z_) for a_, z_ in events)
    drops[f"decode T={b} cap {cap_decode}"] = dropped(step_routes[0][0])
    seq = torch.cat([toks[:, :s]] + fed, dim=1)
    w_all = seq.shape[1]
    with moe_routes() as r_fw:
        model.forward({"tokens": seq})
    drops[f"forward T={b * w_all} cap {moe_mod.capacity(cfg, b * w_all)}"] \
        = dropped(r_fw[0])
    seq_routes = [torch.cat([r_pre[i].reshape(b, s, k_top)] + [
        step_routes[t][i].reshape(b, 1, k_top) for t in range(new)], 1)
        .reshape(-1) for i in range(L)]
    with no_drops(model), moe_routes() as r_fw:
        model.forward({"tokens": seq})
    with no_drops(model), pinned_routes(seq_routes):
        full = model.forward({"tokens": seq})
    check = torch.tensor(MODEL_CHECK_STEPS, device=dev) + s
    flips = apart([x.reshape(b, w_all, k_top)[:, check].reshape(-1)
                   for x in seq_routes],
                  [x.reshape(b, w_all, k_top)[:, check].reshape(-1)
                   for x in r_fw])
    held(f"decode steps {MODEL_CHECK_STEPS} against forward over {w_all} "
         f"tokens with no capacity drop, on the prefill's and steps' routes",
         torch.stack([step_logits[t] for t in MODEL_CHECK_STEPS], 1),
         full[:, check], flips)
    del full, r_fw, seq_routes

    # the paged arena: each prompt in chunks; chunk 0 against a dense
    # prefill of its tokens (one call of the same T, the same capacity)
    bl = PAGED_BLOCK
    mb = -(-(s + new) // bl)
    tables = (1 + torch.arange(b * mb, device=dev,
                               dtype=torch.int32)).reshape(b, mb)
    arena = None
    for width in MOE_CHUNKS:
        paged = tfm.init_paged_state(cfg, 1 + b * mb, bl, device=dev)
        got0, want0, flips0, dsh = [], [], [], []
        for row in range(b):
            for start in range(0, s, width):
                with moe_routes() as r_c:
                    last, paged = model.prefill_chunk(
                        paged, toks[row:row + 1, start:start + width],
                        tables[row:row + 1], start, width)
                dsh.append(dropped(r_c[0]))
                if start == 0:
                    first = {"tokens": toks[row:row + 1, :width]}
                    with pinned_routes(r_c):
                        want0.append(model.prefill(first)[0])
                    with moe_routes() as r_d:
                        model.prefill(first)
                    got0.append(last)
                    flips0.append(apart(r_c, r_d))
        drops[f"prefill_chunk T={width} cap {moe_mod.capacity(cfg, width)}"] \
            = statistics.mean(dsh)
        held(f"prefill_chunk chunk 0 of {width} (blocks of {bl}), {b} slots, "
             f"against a dense prefill of its {width} tokens on its routes",
             torch.cat(got0), torch.cat(want0), torch.cat(flips0, 1))
        if width == MOE_CHUNKS[0]:
            arena = paged
        del paged
    # decode_paged over the 64-chunk arena against decode_step over the
    # same K/V rows copied into a dense cache, on the dense path's tokens
    kv = (arena.k[:, tables.long()].reshape(L, b, mb * bl, *arena.k.shape[3:]),
          arena.v[:, tables.long()].reshape(L, b, mb * bl, *arena.v.shape[3:]))
    kpos = arena.pos[tables.long()].reshape(b, mb * bl)
    st_copy = tfm.init_state(cfg, b, 0, device=dev)._replace(
        k=kv[0].clone(), v=kv[1].clone(),
        kpos=kpos[None].expand(L, -1, -1).clone(),
        pos=torch.full((b,), s, dtype=torch.int32, device=dev))
    got_rows, want_rows, flips, events, same = [], [], [], [], 0
    for t in range(PAGED_NEW):
        pos = torch.full((b,), s + t, dtype=torch.int32, device=dev)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with moe_routes() as r_p:
            e0.record()
            got, arena = model.decode_paged(arena, fed[t], tables, pos)
            e1.record()
        events.append((e0, e1))
        with moe_routes() as r_s:
            want, st_copy = model.decode_step(st_copy, fed[t])
        same += bool(torch.equal(got, want))
        got_rows.append(got)
        want_rows.append(want)
        flips.append(apart(r_p, r_s))
    paged_ms = statistics.median(a_.elapsed_time(z_) for a_, z_ in events)
    held(f"decode_paged {PAGED_NEW} steps over the chunked arena against "
         f"decode_step over its rows in a dense cache, each routing on its "
         f"own ({same} of {PAGED_NEW} steps bit-identical)",
         torch.cat(got_rows), torch.cat(want_rows), torch.cat(flips, 1))
    del arena, st_copy, kv
    counts = read_launches()
    print(f"moe launches: {({k_: n_ for k_, n_ in counts.items() if n_})}; "
          f"batched by strategy "
          f"{ {st.value: launches[('matmul-batched', st)] for st in Strategy} }",
          flush=True)
    for k_ in ("matmul", "matmul-f32", "matmul-batched", "flash_attention"):
        if not counts[k_]:
            fail(f"moe path: the {k_} kernel was never launched")
    launches[("matmul-batched", lyr.MODEL_MATMUL_SPEC.strategy)] += \
        counts["matmul-batched"] - sum(launches.values())
    launches[("matmul", lyr.MODEL_MATMUL_SPEC.strategy)] = counts["matmul"]
    launches[("matmul-f32", lyr.MODEL_MATMUL_SPEC.strategy)] = \
        counts["matmul-f32"]
    launches[("flash_attention-bf16", Strategy.OVERLAP)] = \
        counts["flash_attention"]

    # -- after the counters: one forward's launches, the drop shares -------
    reset_launches()
    with torch.no_grad():
        model.forward(prompt)
    one = read_launches()
    want_one = {"matmul-batched": 3 * L, "matmul": 7 * L,
                "matmul-f32": 2 * L + matmul.launches(
                    torch.float32, lyr.MODEL_MATMUL_SPEC.strategy,
                    tfm.padded_vocab(cfg)),
                "flash_attention": L}
    print(f"moe launches a forward (B={b} S={s}): "
          f"{ {k_: one[k_] for k_ in want_one} } (want {want_one}: 3 batched "
          f"expert products a layer; q, k, v, o and the shared gate, up and "
          f"down on the bf16 kernel; the router, the sigmoid gate and "
          f"unembed's plan on the f32 kernel)", flush=True)
    if {k_: one[k_] for k_ in want_one} != want_one:
        fail(f"moe launches a forward: {one}, not {want_one}")
    print("moe capacity drops, layer 0, share of (token, slot) assignments: "
          + ", ".join(f"{k_} {v_:.4f}" for k_, v_ in drops.items()),
          flush=True)
    # layer 0's moe block on its own inputs (a prefill's and a decode
    # step's) against its plain recomputation with the same ids
    seen_x = []
    hook = layer0.register_forward_pre_hook(
        lambda mod, args: seen_x.append(args[0]) if not seen_x else None)
    model.prefill(prompt)
    hook.remove()
    x_pre = seen_x[0]
    x_dec = x_pre[:, -1:].contiguous()

    def block_check(what, x, planted=None):
        """Layer 0's block on ``x`` against its plain recomputation with the
        same ids; ``planted``: the (recomputation, ids) of the sound
        weights, which the faulted block must fail against."""
        with torch.no_grad(), moe_routes() as r_b:
            got, _ = layer0(x, cdt)
        if planted is None:
            want, disagree = moe_block_plain(layer0, x, cfg, r_b[0])
        else:
            want, sig_ = planted
            disagree = int((r_b[0] != sig_).sum())
        held_block("moe", f"layer 0 {what} {tuple(x.shape)} against the "
                   f"plain recomputation with the same ids", got, want,
                   MOE_BLOCK_TOL, planted is not None, also=disagree == 0,
                   note=f"; kept flags disagreeing {disagree}")
        return want, r_b[0]

    sound = block_check(f"prefill T={b * s}", x_pre)
    block_check(f"decode T={b}", x_dec)
    sig = sound[1]
    # the planted fault: the busiest expert of layer 0's w_up with its rows
    # (d) reversed, in the flash model only; both checks must reject it
    busiest = int(torch.bincount(sig[sig >= 0], minlength=n_e).argmax())
    w_up = layer0["w_up"]
    keep = w_up[busiest].clone()
    with torch.no_grad():
        w_up[busiest].copy_(keep.flip(0))
    try:
        block_check(f"prefill T={b * s} with expert {busiest}'s w_up rows "
                    f"reversed", x_pre, planted=sound)
        with moe_routes() as r_bad:
            bad = model.forward(prompt)
    finally:
        with torch.no_grad():
            w_up[busiest].copy_(keep)
    with pinned_routes(r_bad):
        sound_logits = chunked.forward(prompt)
    held(f"forward with a planted fault (layer 0 expert {busiest}'s w_up rows "
         f"reversed) against chunked on its routes", bad, sound_logits,
         planted=True)
    del bad, sound_logits, r_bad, r_chunked

    # -- batch invariance: a decode step at batch B, row by row alone ------
    logits, state = dense
    tok = logits.argmax(-1).int()[:, None]
    whole = model.decode_step(state_rows(state, slice(None)), tok)[0]
    alone = [model.decode_step(state_rows(state, slice(r, r + 1)),
                               tok[r:r + 1])[0] for r in range(b)]
    same = [bool(torch.equal(whole[r], alone[r][0])) for r in range(b)]
    print(f"moe batch invariance: a decode step at batch {b} bit-identical to "
          f"each row alone: {same} (capacity {cap_decode} at T = {b} and 1: "
          f"nothing drops)"
          f"{'' if all(same) else ' FAILED'}", flush=True)
    if not all(same):
        fail(f"moe batch invariance: rows {same}")
    del dense, state

    # -- serving: ServingLoop on phase 8's trace ---------------------------
    tr = dict(SERVE_TRACE)
    kind = tr.pop("kind")
    trace = make_trace(kind, vocab=cfg.vocab, **tr)
    max_seq = max(max(next_pow2(len(r.prompt)), len(r.prompt) + r.max_new)
                  for r in trace) + SERVE_BLOCK

    def loop():
        return ServingLoop(model, batch=SERVE_BATCH, max_new=16,
                           block_len=SERVE_BLOCK, max_seq=max_seq)

    def fresh(reverse=False, solo=False):
        arr = [r.arrival for r in trace]
        return [Request(uid=r.uid, prompt=r.prompt, max_new=r.max_new,
                        arrival=0.0 if solo else
                        arr[len(trace) - 1 - i] if reverse else arr[i])
                for i, r in enumerate(trace)]

    t0 = time.perf_counter()
    fifo = loop().run(fresh(), max_steps=64)
    t_fifo = time.perf_counter() - t0
    rev = loop().run(fresh(reverse=True), max_steps=64)
    oracle = {}
    for r in fresh(solo=True):
        oracle.update(loop().run([r], max_steps=64))
    n_tok = sum(len(v) for v in fifo.values())
    for what, got in (("FIFO", fifo), ("reversed", rev)):
        diff = sorted(u for u in oracle if got.get(u) != oracle[u])
        print(f"moe serve {what} at batch {SERVE_BATCH}: {len(oracle) - len(diff)}"
              f" of {len(oracle)} requests' greedy tokens identical to each "
              f"request served alone{'' if not diff else ' FAILED: ' + str(diff)}",
              flush=True)
        if diff:
            fail(f"moe serve {what}: requests {diff} differ from alone")
    print(f"moe serve time FIFO batch {SERVE_BATCH}: {n_tok} tokens in "
          f"{t_fifo:.3f} s, {n_tok / t_fifo:.2f} tokens/s", flush=True)

    # -- times beside bounds -------------------------------------------------
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    attn_p = 2 * d * h * hd + 2 * d * kvh * hd
    expert_p = 3 * d * ff
    shared_p = cfg.moe.n_shared * expert_p + d
    dense_p = L * (attn_p + shared_p + d * n_e)
    w16_all = n_params * 2
    kv_row = 2 * L * kvh * hd * 2
    w_mid = s + new // 2

    def flops(t, att):
        return 2 * t * (dense_p + L * k_top * expert_p) + att

    prefill_ms = device_ms(lambda: model.prefill(prompt), reps=1, batches=3,
                           warmup=1)
    p_ops = flops(b * s, 2 * L * b * h * s * s * hd) + 2 * b * d * cfg.vocab
    least, by = bound(p_ops, w16_all + b * s * kv_row, BF16_TC_OPS_PER_S)
    print(f"moe time prefill B={b} S={s}: {prefill_ms:.4f} ms, bound "
          f"{least:.4f} ms by {by} ({least / prefill_ms:.1%} of it; "
          f"{p_ops / 1e9:.1f} GFLOP, every weight read once in bf16, "
          f"{w16_all / 1e9:.2f} GB) ({card})", flush=True)
    d_ops = flops(b, 4 * L * b * h * w_mid * hd) + 2 * b * d * cfg.vocab
    routed = min(b * k_top, n_e)
    w16_routed = (n_params - L * (n_e - routed) * expert_p) * 2
    for what, ms in (("decode", decode_ms), ("paged decode", paged_ms)):
        all_b = bound(d_ops, w16_all + b * w_mid * kv_row,
                      BF16_TC_OPS_PER_S)[0]
        routed_b = bound(d_ops, w16_routed + b * w_mid * kv_row,
                         BF16_TC_OPS_PER_S)[0]
        print(f"moe time {what} B={b}, {w_mid} cached rows: {ms:.4f} ms a "
              f"step; bound {all_b:.4f} ms with every expert's bf16 weights "
              f"read once ({w16_all / 1e9:.2f} GB), {routed_b:.4f} ms with "
              f"only the <= {routed} routed experts' a layer "
              f"({w16_routed / 1e9:.2f} GB) ({card})", flush=True)
    peak = torch.cuda.max_memory_allocated()
    print(f"moe peak memory: {peak / 1e9:.2f} GB allocated "
          f"(torch.cuda.max_memory_allocated, of the card's "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f})",
          flush=True)
    del model, chunked
    gc.collect()
    torch.cuda.empty_cache()
    print(f"moe path: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


#: phase 10, the vlm, ssm and hybrid families at full width (published
#: widths and depths, weights from a seeded generator, attention="flash"):
#: phi-3-vision-4.2b (32 layers, d_model 3072, 32 heads of 96, d_ff 8192,
#: vocab 32064, 256 patch rows), xlstm-1.3b (48 layers, 6 x (7 mLSTM + 1
#: sLSTM), d_model 2048, 4 heads, expand 2, chunk 64, vocab 50304) and
#: hymba-1.5b (32 layers, d_model 1600, 25 heads over 5 kv heads of 64,
#: window 1024 but on layers 0, 16 and 31, Mamba d_state 16, vocab 32001)
VLM_ARCH, SSM_ARCH, HYBRID_ARCH = ("phi-3-vision-4.2b", "xlstm-1.3b",
                                   "hymba-1.5b")
#: phi-3-vision: phase 7's MODEL_B prompts of MODEL_S tokens after the
#: patch rows, VLM_NEW greedy steps, VLM_CHECK_STEPS of them held against
#: forward over the whole sequence
VLM_NEW, VLM_CHECK_STEPS = 16, (0, 5, 10, 15)
#: xlstm: MODEL_B prompts of MODEL_S tokens, SSM_NEW decode steps held
#: against forward; the prefill at the config's chunk against SSM_ALT_CHUNK.
#: At random weights the stack is chaotic: its rounding floor (bf16
#: against float32) nears uncorrelated logits at 48 layers (relative l2
#: 1.29) and at 16 (0.99, where a planted off-by-one in the carried states
#: hides in it), so the whole model's equivalences are also held on a
#: shallow stack, SSM_SHALLOW (n_layers, slstm_every): two groups of one
#: mLSTM and one sLSTM layer, so the states carried across layers, groups
#: and the prefill-to-decode step are all exercised, against that stack's
#: own floor (~0.03 on an NVIDIA H100 80GB HBM3 at 700 W)
SSM_NEW, SSM_ALT_CHUNK, SSM_SHALLOW = 8, 32, (4, 2)
#: hymba: HYBRID_B prompts of HYBRID_S tokens (past the 1,024-row window:
#: shorter prompts would make every layer global in effect), HYBRID_NEW
#: decode steps; the global layer planted windowed
HYBRID_B, HYBRID_S, HYBRID_NEW, HYBRID_FAULT_LAYER = 2, 2048, 8, 16
#: a recurrent block's bf16 output (layer 0's mLSTM, the first sLSTM,
#: layer 0's Mamba) against its plain recomputation: max |diff| <=
#: FAMILY_BLOCK_TOL x max |plain|.  Both round the block's projections to
#: bf16 at the same points and its gates and states stay f32 (float64 in
#: the recomputation), so they part where an f32 value lands within an
#: f32 rounding of a bf16 rounding boundary (one bf16 ulp, 2^-8 of the
#: value at most) and the output product sums a few thousand such values:
#: a few ulps.  2^-5 is four bf16 ulps of the largest value, phase 9's
#: MOE_BLOCK_TOL.
FAMILY_BLOCK_TOL = 2 ** -5
#: the logits checks of phase 10: each path's logits within FAMILY_OWN
#: times the model's own rounding floor, the distance of a prefill in bf16
#: from the same prefill computing in float32 (max |diff| and relative l2
#: of the last-token logits): two bf16 paths, each about that far from
#: exact arithmetic, part by up to about twice it.  Their untied logits
#: reach ~4-5 and their depth and width exceed qwen2-1.5b's, so phase 7's
#: fixed 0.12 fails on rounding alone (0.122-0.136 on phi-3-vision,
#: 0.26-0.32 on hymba, on an NVIDIA H100 80GB HBM3 at 700 W)
FAMILY_OWN = 2.0
#: Mamba's final state, SSD against the associative scan (both f32):
#: max |diff| <= this x max |scan|, the reference's own tolerance between
#: its chunkwise and stepwise Mamba (tests/test_models.py, 2e-3)
MAMBA_STATE_TOL = 2e-3
#: the cohort runs of xlstm and hymba serve phase 8's trace (arrivals and
#: uids) with each prompt cut to its first COHORT_ROWS x max(1, len //
#: (2 COHORT_ROWS)) tokens and each max_new halved (rounded up): a cohort
#: prefills at the largest divisor of its width not above the chunk (64),
#: so phase 8's prime widths (349, 97, 71) run one row a chunk, and a
#: width a multiple of COHORT_ROWS runs 32 or 64; halved, the 14 oracles
#: (one a request and pad count) fit phase 10's budget
COHORT_ROWS = 32
#: the cohort runs' depths (every width as published, the weights their
#: own, seeded as the full model's; the models' checks above run at full
#: depth): xlstm (n_layers, slstm_every), one group of 7 mLSTM layers and
#: its sLSTM layer, so that states cross layers of both kinds; hymba
#: HYBRID_COHORT_LAYERS, whose global layers are 0, 2 and 3 and windowed
#: layer 1.  The serving contract, each request's tokens bit-identical to
#: its oracle's, does not depend on depth, and at full depth these
#: host-bound runs took about 36 s a model on a slow host (an NVIDIA H100
#: 80GB HBM3 at 700 W)
SSM_COHORT, HYBRID_COHORT_LAYERS = (8, 8), 4


@contextlib.contextmanager
def calls_of(mod, name: str, n: float = 1, fault=None, timed: bool = False,
             keep=None, into=None):
    """``mod.name`` with its first ``n`` calls kept in a list (yielded;
    ``into`` when given), each (args, kwargs, result, seconds) or, with
    ``keep``, keep(args, kwargs, result).  ``fault`` (keyword arguments)
    is planted in the first call alone; with ``timed`` each call runs between
    two synchronisations of the card and its seconds are kept (None
    otherwise)."""
    import torch
    real, count = getattr(mod, name), [0]
    seen = [] if into is None else into

    def call(*args, **kw):
        if fault and not count[0]:
            kw.update(fault)
        count[0] += 1
        if timed:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*args, **kw)
        if timed:
            torch.cuda.synchronize()
        if len(seen) < n:
            seen.append(keep(args, kw, out) if keep else
                        (args, kw, out, time.perf_counter() - t0
                         if timed else None))
        return out
    setattr(mod, name, call)
    try:
        yield seen
    finally:
        setattr(mod, name, real)


@contextlib.contextmanager
def configured(model, **changes):
    """``model`` with ``changes`` to its config for the duration (a
    dtype to compute in, a recurrent chunk): the config of the net and of
    each module that keeps one (the layers) replaced."""
    mods = [m for m in model.net.modules() if hasattr(m, "cfg")]
    saved = [m.cfg for m in mods]
    for m, cfg in zip(mods, saved):
        m.cfg = dataclasses.replace(cfg, **changes)
    try:
        yield
    finally:
        for m, cfg in zip(mods, saved):
            m.cfg = cfg


@contextlib.contextmanager
def recorded_ops():
    """Every op of the model's path below the layers, in call order: the
    embedding, norms, products (``linear`` in layers, attention and ssm;
    mLSTM's headwise products), rope, decode attention, the recurrent
    cells and steps, Mamba, unembed.  Each call's outputs, row 0 of the
    batch only, as (name, [tensors])."""
    import torch
    from repro_torch.models import attention, encdec, layers, ssm, transformer
    targets = [(layers, "embed"), (layers, "norm"), (layers, "linear"),
               (layers, "rope"), (attention, "linear"), (encdec, "linear"),
               (attention, "attend_decode"), (ssm, "linear"),
               (ssm, "_headwise"), (ssm, "mlstm_step"),
               (ssm, "_slstm_cell"), (ssm, "mamba_apply"),
               (transformer, "unembed")]

    def flat(out):
        if isinstance(out, torch.Tensor):
            return [out[:1].clone()]
        return [t for o in out for t in flat(o)]
    seen = []
    with contextlib.ExitStack() as stack:
        for m, nm in targets:
            label = f"{m.__name__.rsplit('.', 1)[1]}.{nm}"
            stack.enter_context(calls_of(
                m, nm, float("inf"), into=seen,
                keep=lambda a, kw, out, label=label: (label, flat(out))))
        yield seen


def state_rows(state, rows):
    """A copy of the decode state's batch ``rows`` (a slice or an index):
    the batch is axis 1 of every field but ``slstm`` (axis 2) and ``pos``
    (axis 0); a field of the family's size 0 stays as it is."""
    axis = {"slstm": 2, "pos": 0}

    def take(x, a):
        return x.clone() if x.shape[a] == 0 else \
            x[(slice(None),) * a + (rows,)].clone()
    return state._replace(**{f: take(getattr(state, f), axis.get(f, 1))
                             for f in state._fields})


def decode_invariance(tag: str, model, state, tok) -> None:
    """A decode step at batch B against each row alone (B = 1, its state
    sliced): the logits bit for bit, and row 0's every op (``recorded_ops``)
    bit for bit against its op alone."""
    import torch
    b = tok.shape[0]
    with recorded_ops() as many:
        whole = model.decode_step(state_rows(state, slice(None)), tok)[0]
    alone = []
    for r in range(b):
        with recorded_ops() as one:
            alone.append(model.decode_step(state_rows(state, slice(r, r + 1)),
                                           tok[r:r + 1])[0])
        if r == 0:
            ops0 = one
    same = [bool(torch.equal(whole[r], alone[r][0])) for r in range(b)]
    names = [nm for nm, _ in many]
    diff = [i for i, ((na, a), (nb, b_)) in enumerate(zip(many, ops0))
            if na != nb or len(a) != len(b_)
            or not all(torch.equal(x, y) for x, y in zip(a, b_))]
    ok = all(same) and not diff and len(many) == len(ops0)
    by_name = {}
    for nm in names:
        by_name[nm] = by_name.get(nm, 0) + 1
    print(f"{tag} batch invariance: a decode step at batch {b} bit-identical "
          f"to each row alone: {same}; row 0's {len(many)} ops ({by_name}) "
          f"bit-identical to its ops alone: {len(many) - len(diff)} of "
          f"{len(many)}"
          + (f", first differing {names[diff[0]]} (op {diff[0]})" if diff
             else "") + ("" if ok else " FAILED"), flush=True)
    if not ok:
        fail(f"{tag} batch invariance: rows {same}, ops differing "
             f"{[names[i] for i in diff[:5]]}")


def count_terms(model, cfg) -> None:
    """The module's parameter count beside the analytic param_count(),
    term by term (param_count() approximates the recurrent blocks and
    omits patch_proj; the two are not required equal)."""
    net, d = model.net, cfg.d_model

    def n(mod):
        return sum(p.numel() for p in mod.parameters())
    layers = list(net["layers"]) + list(net["slstm_layers"]
                                        if "slstm_layers" in net else [])
    norm_names = ("ln_attn", "ln_mlp", "ln", "ln_s")
    got = {"mixer": sum(n(m) for l in layers for k, m in l.items()
                        if k not in norm_names + ("mlp",)),
           "mlp": sum(n(l["mlp"]) for l in layers if "mlp" in l),
           "layer norms": sum(n(m) for l in layers for k, m in l.items()
                              if k in norm_names),
           "embeddings": n(net["embed"]) + (n(net["unembed"])
                                            if "unembed" in net else 0),
           "final norm": n(net["ln_f"]),
           "patch_proj": n(net["patch_proj"]) if "patch_proj" in net else 0}
    total = cfg.param_count()
    no_mlp = dataclasses.replace(cfg, d_ff=0)
    per_mlp = (total - no_mlp.param_count()) // cfg.n_layers
    emb = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    want = {"mlp": cfg.n_layers * per_mlp, "layer norms": cfg.n_layers * 2 * d,
            "embeddings": emb, "final norm": d, "patch_proj": 0}
    want["mixer"] = total - sum(want.values())
    rows = ", ".join(f"{k} {got[k]} - {want[k]} = {got[k] - want[k]}"
                     for k in got)
    print(f"{cfg.name} parameters: module {sum(got.values())}, param_count() "
          f"{total}, module - analytic by term: {rows}", flush=True)


def mlstm_block_plain(p, x, cfg):
    """mLSTM block ``p`` on x (B, S, d) bf16, token by token: the
    reference's ``mlstm_step`` formulas in float64, its products float64
    sums of the bf16 operands rounded to bf16 where the model rounds (up,
    z, q, k, v, the gated h, the output), the gate products float64 sums of
    the f32 values."""
    import torch
    import torch.nn.functional as F
    cdt, f64 = torch.bfloat16, torch.float64

    def prod(a, w):
        return (a.to(f64) @ w.to(cdt).to(f64)).to(cdt)
    b, s, _ = x.shape
    h = cfg.n_heads
    up, z = prod(x, p["w_up"]["w"]), prod(x, p["w_z"]["w"])
    inner = up.shape[-1]
    dh = inner // h
    up_h = up.reshape(b, s, h, dh).to(f64)

    def head(w):
        return torch.einsum("bshd,hde->bshe", up_h,
                            w.to(cdt).to(f64)).to(cdt).to(f64)
    q, k, v = head(p["w_q"]), head(p["w_k"]) / dh ** 0.5, head(p["w_v"])
    upf = up.to(f64)
    i_raw = upf @ p["w_i"].to(f64) + p["b_i"].to(f64)
    f_raw = upf @ p["w_f"].to(f64) + p["b_f"].to(f64)
    c = torch.zeros(b, h, dh, dh, dtype=f64, device=x.device)
    n = torch.zeros(b, h, dh, dtype=f64, device=x.device)
    m = torch.full((b, h), -1e30, dtype=f64, device=x.device)
    hs = []
    for t in range(s):
        lf = F.logsigmoid(f_raw[:, t])
        m_new = torch.maximum(lf + m, i_raw[:, t])
        fw = torch.exp(lf + m - m_new)[..., None]
        iw = torch.exp(i_raw[:, t] - m_new)[..., None]
        c = fw[..., None] * c + iw[..., None] * (
            k[:, t, :, :, None] * v[:, t, :, None, :])
        n = fw * n + iw * k[:, t]
        num = torch.einsum("bhd,bhde->bhe", q[:, t], c)
        qn = torch.einsum("bhd,bhd->bh", q[:, t], n)
        hs.append(num / torch.maximum(qn.abs(), torch.exp(-m_new))[..., None])
        m = m_new
    hid = torch.stack(hs, 1).reshape(b, s, inner).to(cdt) * F.silu(z)
    return prod(hid, p["w_down"]["w"])


def slstm_block_plain(p, x, cfg):
    """sLSTM block ``p`` on x (B, S, d) bf16, its cell's formulas in
    float64 token by token, its products float64 sums of the bf16
    operands rounded to bf16 where the model rounds."""
    import torch
    import torch.nn.functional as F
    cdt, f64 = torch.bfloat16, torch.float64

    def prod(a, w):
        return (a.to(f64) @ w.to(cdt).to(f64)).to(cdt)
    b, s, d = x.shape
    h = cfg.n_heads
    dh = d // h
    xw = (prod(x, p["w_x"]["w"]).to(f64) + p["b"].to(f64)).reshape(
        b, s, 4, h, dh)
    r = p["r"].to(f64)
    c, n, hh = (torch.zeros(b, h, dh, dtype=f64, device=x.device)
                for _ in range(3))
    m = torch.full((b, h, dh), -1e30, dtype=f64, device=x.device)
    hs = []
    for t in range(s):
        zi, ii, fi, oi = (xw[:, t] + torch.einsum("bhd,ghde->bghe", hh, r)
                          ).unbind(1)
        m_new = torch.maximum(fi + m, ii)
        fw, iw = torch.exp(fi + m - m_new), torch.exp(ii - m_new)
        c = fw * c + iw * torch.tanh(zi)
        n = fw * n + iw
        hh = torch.sigmoid(oi) * c / n.clamp_min(1e-6)
        m = m_new
        hs.append(hh)
    u1, u2 = prod(torch.stack(hs, 1).reshape(b, s, d).to(cdt),
                  p["w_up"]["w"]).chunk(2, dim=-1)
    return prod(F.gelu(u1, approximate="tanh") * u2, p["w_down"]["w"])


def scan_chunk(carry, la, du, b_t, c_t):
    """``ssm._mamba_ssd_chunk``'s contract through the associative scan
    (``ssm._mamba_scan_chunk``, every step's state materialised)."""
    import torch
    from repro_torch.models import ssm
    n = b_t.shape[-1]
    a_bar = torch.exp(la)[..., None].expand(*la.shape, n)
    bx = du[..., None] * b_t[:, :, None, :]
    s_new, states = ssm._mamba_scan_chunk(carry, a_bar, bx)
    return s_new, torch.einsum("bldn,bln->bld", states, c_t)


def families_path(card: str) -> dict:
    """``families_phase`` without autograd but for its loss check."""
    import torch
    with torch.no_grad():
        return families_phase(card)


def families_phase(card: str) -> dict:
    """Phase 10, the vlm, ssm and hybrid families at full width, one model
    at a time after phase 9 frees its own: VLM_ARCH, SSM_ARCH and
    HYBRID_ARCH through the model's entry points and ServingLoop
    (``vlm_model``, ``ssm_model``, ``hybrid_model``).  Returns the launches
    by (kernel, strategy): each strategy's bf16 flash launches, and the
    matmul kernel's (bf16, f32, batched) at the model's spec."""
    import gc
    import torch
    t_phase = time.perf_counter()
    launches = {}
    for fn in (vlm_model, ssm_model, hybrid_model):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            for key, n_ in fn(card).items():
                launches[key] = launches.get(key, 0) + n_
        except Exception as e:
            fail(f"families path {fn.__name__}: {type(e).__name__}: {e}")
        gc.collect()
        torch.cuda.empty_cache()
    print(f"families path: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


class FamilyRun:
    """What the three models of phase 10 share: the model at full width
    on the card, the rounding floor (``floor_of``), the logits check
    (``close``: FAMILY_OWN times the floor), the block check (``block``),
    layer calls of flash against the plain version (``flash_check``), the
    launch counters (``count``), the times beside their bounds and the
    closing lines (``finish``)."""

    def __init__(self, arch: str, card: str):
        import torch
        from repro_torch.configs import get_config
        from repro_torch.kernels import ops
        self.t0 = time.perf_counter()
        self.card = card
        self.dev = torch.device("cuda")
        self.cfg = cfg = get_config(arch)
        self.tag = cfg.name
        ops.reset_default_configs()
        self.model = self.build(cfg)
        self.chunked = self.model.with_attention("chunked")
        self.n_params = sum(p.numel() for p in self.model.net.parameters())
        self.g = torch.Generator(device=self.dev).manual_seed(1)
        self.floor = None
        print(f"{self.tag}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.n_heads} heads over {cfg.n_kv_heads} kv heads of "
              f"{cfg.head_dim_}, vocab {cfg.vocab}: {self.n_params} "
              f"parameters, fp32, computing in {cfg.dtype}; built and drawn "
              f"in {time.perf_counter() - self.t0:.1f} s ({card})",
              flush=True)
        self.count_params()
        self.launches = {}

    @property
    def flash_per_prefill(self) -> int:
        """A prefill's flash launches: one a layer."""
        return self.cfg.n_layers

    def count_params(self) -> None:
        count_terms(self.model, self.cfg)

    def build(self, cfg):
        """``cfg``'s model on the card, attention="flash", its weights
        from a generator seeded 0."""
        import torch
        from repro_torch.models import build_model
        model = build_model(cfg, attention="flash", device=self.dev)
        model.init(torch.Generator(device=self.dev).manual_seed(0))
        return model

    def tokens(self, b: int, s: int):
        import torch
        return torch.randint(0, self.cfg.vocab, (b, s), generator=self.g,
                             device=self.dev, dtype=torch.int32)

    def apart(self, got, want):
        """(max |diff|, relative l2, max |want|) over the real vocab (the
        padding slots hold -1e30)."""
        v = self.cfg.vocab
        got, want = got[..., :v].float(), want[..., :v].float()
        return (float((got - want).abs().max()),
                float((got - want).norm() / want.norm()),
                float(want.abs().max()))

    def floor_of(self, model, batch, budget, bf16, what=""):
        """The rounding floor: ``bf16``, ``model``'s prefill's last-token
        logits, against the same prefill computing in float32 ->
        FAMILY_OWN times (max |diff|, relative l2), the logits checks'
        (atol, rtol)."""
        with configured(model, dtype="float32"):
            exact, _ = model.prefill(batch, budget=budget)
        err, rel, top = self.apart(bf16, exact)
        print(f"{self.tag} rounding floor{what}: the prefill's last-token "
              f"logits in bf16 against float32: max_abs_err {err:.4g}, "
              f"relative l2 {rel:.3g}, |logits| <= {top:.3g}; the logits "
              f"checks hold {FAMILY_OWN} times these", flush=True)
        return FAMILY_OWN * err, FAMILY_OWN * rel

    def reference(self, batch, budget):
        """Before the counters: attention="chunked"'s prefill (bf16) and
        the rounding floor of it -> its last-token logits."""
        want, _ = self.chunked.prefill(batch, budget=budget)
        self.floor = self.floor_of(self.chunked, batch, budget, want)
        return want

    def close(self, what, got, want, planted=False, floor=None):
        """Hold logits to ``floor`` (the model's own by default); with
        ``planted`` they come from a planted fault, which the check must
        reject."""
        return held_logits(self.tag, what, got, want,
                           *(floor or self.floor), planted,
                           vocab=self.cfg.vocab)

    def block(self, what, got, want, planted=False) -> None:
        held_block(self.tag, what, got, want, FAMILY_BLOCK_TOL, planted)

    def flash_check(self, seen, layers, planted=False) -> None:
        """The kept flash calls (``calls_of`` ops.flash_attention) against
        the plain version on the same q, k, v at the layer's own window (0
        on a global layer of ``layer_flags``), within 2e-5; with
        ``planted`` the calls carry a planted fault, which the check must
        reject."""
        import torch
        from repro_torch.kernels import flash_attention
        from repro_torch.models import transformer as tfm
        flags = tfm.layer_flags(self.cfg).get("global_attn")
        for i in layers:
            (q_, k_, v_), kw, out, _ = seen[i]
            window = 0 if flags is not None and flags[i] else \
                self.cfg.attn.window
            plain = flash_attention.flash_attention_plain(
                q_, k_, v_, causal=kw["causal"], window=window,
                scale=kw["scale"], kv_len=kw["kv_len"])
            err = float((out - plain).abs().max())
            ok = bool(torch.allclose(out, plain, rtol=2e-5, atol=2e-5))
            print(f"{self.tag} layer {i} flash {tuple(q_.shape)} {q_.dtype} "
                  f"causal={kw['causal']} window={kw['window']} kv_len="
                  f"{kw['kv_len']}: max_abs_err "
                  f"{err:.3g} against the plain version at the layer's "
                  f"window {window} (rtol and atol 2e-5)"
                  f"{verdict_of(ok, planted)}", flush=True)
            if ok == planted:
                fail(f"{self.tag} layer {i} flash: max_abs_err {err:.3g}")

    def prefill_strategies(self, batch, budget, want):
        """A prefill at each strategy of the bf16 flash kernel (one launch
        a layer each), held against ``want`` (attention="chunked"'s) ->
        the OVERLAP prefill's (logits, state)."""
        from repro_torch.core.async_pipeline import Strategy
        from repro_torch.kernels import flash_attention, ops
        dense = None
        for st in Strategy:
            ops.set_default_config("flash_attention", strategy=st)
            before = flash_attention.LAUNCHES
            got, state = self.model.prefill(batch, budget=budget)
            n = flash_attention.LAUNCHES - before
            self.launches[("flash_attention-bf16", st)] = n
            self.close(f"prefill {st.value} ({n} flash launches): last-token "
                       f"logits, flash against chunked", got, want)
            if n != self.flash_per_prefill:
                fail(f"{self.tag} prefill {st.value}: {n} flash launches, "
                     f"not {self.flash_per_prefill}")
            if st is Strategy.OVERLAP:
                dense = (got, state)
        ops.reset_default_configs()
        return dense

    def greedy(self, logits, state, new: int, model=None):
        """``new`` greedy decode steps of ``model`` (this run's by default)
        from a prefill, each timed by CUDA events -> (fed tokens, each
        step's logits, median ms a step)."""
        import statistics
        import torch
        model = model or self.model
        tok = logits.argmax(-1).int()[:, None]
        fed, steps, events = [], [], []
        for _ in range(new):
            fed.append(tok)
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            logits, state = model.decode_step(state, tok)
            e1.record()
            events.append((e0, e1))
            steps.append(logits)
            tok = logits.argmax(-1).int()[:, None]
        torch.cuda.synchronize()
        return fed, steps, statistics.median(
            a.elapsed_time(z) for a, z in events)

    def count(self) -> None:
        """Read the counters (set to 0 just before the main path): the
        flash launches the strategy loop did not take go to OVERLAP, the
        products' to the model's spec."""
        from repro_torch.core.async_pipeline import Strategy
        from repro_torch.models.layers import MODEL_MATMUL_SPEC
        counts = read_launches()
        print(f"{self.tag} launches: "
              f"{ {k: n for k, n in counts.items() if n} }", flush=True)
        flash = sum(n for (k, _), n in self.launches.items()
                    if k == "flash_attention-bf16")
        if counts["flash_attention"]:
            key = ("flash_attention-bf16", Strategy.OVERLAP)
            self.launches[key] = self.launches.get(key, 0) + \
                counts["flash_attention"] - flash
        for k in ("matmul", "matmul-f32", "matmul-batched"):
            if counts[k]:
                self.launches[(k, MODEL_MATMUL_SPEC.strategy)] = counts[k]
        for k in ("matmul", "matmul-f32"):
            if not counts[k]:
                fail(f"{self.tag}: the {k} kernel was never launched")

    def times(self, prefill_ms, what_p, p_work, decode_ms, what_d, d_work):
        """Prefill and decode times beside their bounds: bf16 weights (and
        state) at HBM_BYTES_PER_S, products at BF16_TC_OPS_PER_S."""
        for what, ms, (ops_, bytes_) in ((what_p, prefill_ms, p_work),
                                         (what_d, decode_ms, d_work)):
            least, by = bound(ops_, bytes_, BF16_TC_OPS_PER_S)
            print(f"{self.tag} time {what}: {ms:.4f} ms, bound {least:.4f} ms "
                  f"by {by} ({least / ms:.1%} of it; {ops_ / 1e9:.1f} GFLOP, "
                  f"{bytes_ / 1e9:.3f} GB) ({self.card})", flush=True)

    def finish(self) -> dict:
        import torch
        peak = torch.cuda.max_memory_allocated()
        print(f"{self.tag} peak memory: {peak / 1e9:.2f} GB allocated "
              f"(torch.cuda.max_memory_allocated)", flush=True)
        print(f"{self.tag} phase: {time.perf_counter() - self.t0:.1f} s",
              flush=True)
        del self.model, self.chunked
        return self.launches

    def loss_refused(self, batch) -> None:
        """Model.loss under autograd raises ValueError before any launch."""
        import torch
        before, refused = model_launches(), None
        with torch.enable_grad():
            try:
                self.model.loss(batch)
            except ValueError as e:
                refused = str(e)
        n = sum(model_launches()) - sum(before)
        print(f"{self.tag} loss under autograd: "
              f"{'ValueError: ' + refused if refused else 'no error'}; {n} "
              f"launches", flush=True)
        if not refused or "backward pass" not in refused or n:
            fail(f"{self.tag} loss under autograd did not refuse before any "
                 f"launch")


def serve_trace(vocab: int, cohort: bool = False):
    """Phase 8's trace at ``vocab`` (with ``cohort``, cut as COHORT_ROWS
    says), and its requests made afresh (FIFO, reversed or all at once)."""
    from repro_torch.serve import Request, make_trace
    tr = dict(SERVE_TRACE)
    kind = tr.pop("kind")
    trace = make_trace(kind, vocab=vocab, **tr)
    if cohort:
        trace = [Request(uid=r.uid, arrival=r.arrival,
                         prompt=r.prompt[:COHORT_ROWS * max(
                             1, len(r.prompt) // (2 * COHORT_ROWS))],
                         max_new=-(-r.max_new // 2)) for r in trace]
    arr = [r.arrival for r in trace]

    def fresh(order="fifo"):
        return [Request(uid=r.uid, prompt=r.prompt, max_new=r.max_new,
                        arrival=0.0 if order == "solo" else
                        arr[len(trace) - 1 - i] if order == "reversed"
                        else arr[i])
                for i, r in enumerate(trace)]
    return trace, fresh


def vlm_model(card: str) -> dict:
    """phi-3-vision-4.2b: its counts; before the counters, the chunked
    prefill and the rounding floor; then, counted, a prefill of MODEL_B
    prompts of MODEL_S tokens after the 256 patch rows (S = 768 rows) at
    each strategy of the bf16 flash kernel, against attention="chunked";
    VLM_NEW greedy steps, VLM_CHECK_STEPS held against forward;
    decode_paged over the prefill's rows copied into an arena, against
    decode_step.  After the counters: layer 0's flash call (head dim 96
    padded to 128) against the plain version; a planted fault (the patch
    rows dropped) the check must reject; ServingLoop on phase 8's trace
    (continuous, FIFO and reversed at batch 4 bit-identical to each
    request alone; chunked prefill refused); the loss under autograd
    refused; times beside bounds."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import ServingLoop
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import ContinuousScheduler, next_pow2
    run = FamilyRun(VLM_ARCH, card)
    model, cfg, dev = run.model, run.cfg, run.dev
    b, s, new, p = MODEL_B, MODEL_S, VLM_NEW, cfg.n_patches
    rows = p + s
    toks = run.tokens(b, s + new)
    patches = torch.randn(b, p, cfg.d_model, generator=run.g, device=dev)
    prompt = {"tokens": toks[:, :s], "patches": patches}
    budget = rows + new
    want = run.reference(prompt, budget)
    reset_launches()
    logits, state = run.prefill_strategies(prompt, budget, want)
    fed, steps, decode_ms = run.greedy(logits, state_rows(state, slice(None)),
                                       new)
    seq = torch.cat([toks[:, :s]] + fed, dim=1)
    full = model.forward({"tokens": seq, "patches": patches})
    # decode_paged over the prefill's K/V rows copied into an arena of
    # PAGED_BLOCK-row blocks, against decode_step on the same state
    bl = PAGED_BLOCK
    mb = -(-budget // bl)
    tables = (1 + torch.arange(b * mb, device=dev, dtype=torch.int32)
              ).reshape(b, mb)
    paged = tfm.init_paged_state(cfg, 1 + b * mb, bl, device=dev)
    w = state.k.shape[2]
    idx = tables.long().reshape(-1)
    kv_shape = (cfg.n_layers, b * mb, bl) + state.k.shape[3:]

    def arena(x):
        return torch.nn.functional.pad(
            x, (0, 0, 0, 0, 0, mb * bl - w)).reshape(kv_shape)
    paged.k.index_copy_(1, idx, arena(state.k))
    paged.v.index_copy_(1, idx, arena(state.v))
    paged.pos.index_copy_(0, idx, torch.nn.functional.pad(
        state.kpos[0], (0, mb * bl - w), value=-1).reshape(b * mb, bl))
    dense = state_rows(state, slice(None))
    pairs = []
    for t in range(PAGED_NEW):
        got, paged = model.decode_paged(paged, fed[t], tables, dense.pos)
        want_t, dense = model.decode_step(dense, fed[t])
        pairs.append((got, want_t))
    run.count()
    del paged, dense
    for t in VLM_CHECK_STEPS:
        run.close(f"decode step {t} against forward over {p} patch rows and "
                  f"{seq.shape[1]} tokens", steps[t], full[:, rows + t])
    del full
    for t, (got, want_t) in enumerate(pairs):
        run.close(f"decode_paged step {t} against decode_step", got, want_t)
    print(f"{run.tag} decode_paged: "
          f"{sum(bool(torch.equal(a, z)) for a, z in pairs)} of {PAGED_NEW} "
          f"steps bit-identical to decode_step", flush=True)
    del pairs
    # after the counters: layer 0's flash call, the planted fault
    with calls_of(ops, "flash_attention") as seen:
        model.prefill(prompt)
    run.flash_check(seen, [0])
    run.close("prefill with a planted fault (the patch rows dropped) against "
              "chunked", model.prefill({"tokens": toks[:, :s]})[0], want,
              planted=True)
    run.loss_refused({"tokens": toks[:, :64], "labels": toks[:, :64],
                      "patches": patches})
    # serving: continuous at batch SERVE_BATCH, each request against itself
    # alone; chunked prefill refused
    trace, fresh = serve_trace(cfg.vocab)
    max_seq = max(max(next_pow2(len(r.prompt) + p), len(r.prompt) + p
                      + r.max_new) for r in trace) + SERVE_BLOCK

    def loop(**kw):
        return ServingLoop(model, batch=SERVE_BATCH, max_new=16,
                           block_len=SERVE_BLOCK, max_seq=max_seq, **kw)
    chunk_loop = loop(chunk_tokens=SERVE_CHUNK)
    try:
        ContinuousScheduler(model, batch=SERVE_BATCH, block_len=SERVE_BLOCK,
                            max_seq=max_seq, chunk_tokens=SERVE_CHUNK)
        refused = None
    except ValueError as e:
        refused = str(e)
    print(f"{run.tag} serve: ServingLoop with chunk_tokens={SERVE_CHUNK} runs "
          f"{chunk_loop.scheduler_kind} with chunk_tokens "
          f"{chunk_loop.chunk_tokens}; ContinuousScheduler refuses: "
          f"{refused}", flush=True)
    if chunk_loop.chunk_tokens is not None or not refused:
        fail(f"{run.tag} serve: chunked prefill was not refused")
    t0 = time.perf_counter()
    fifo = loop().run(fresh(), max_steps=64)
    t_fifo = time.perf_counter() - t0
    rev = loop().run(fresh("reversed"), max_steps=64)
    oracle = {}
    for r in fresh("solo"):
        oracle.update(loop().run([r], max_steps=64))
    serve_verdicts(run.tag, "continuous", (("FIFO", fifo), ("reversed", rev)),
                   oracle, "each request served alone")
    n_tok = sum(len(v) for v in fifo.values())
    print(f"{run.tag} serve time FIFO batch {SERVE_BATCH}: {n_tok} tokens in "
          f"{t_fifo:.3f} s, {n_tok / t_fifo:.2f} tokens/s", flush=True)
    # times beside bounds
    d, L, hd, h = cfg.d_model, cfg.n_layers, cfg.head_dim_, cfg.n_heads
    mm = L * (4 * d * h * hd + 3 * d * cfg.d_ff)
    w16 = run.n_params * 2
    kv_row = 2 * L * cfg.n_kv_heads * hd * 2
    w_mid = rows + new // 2
    prefill_ms = device_ms(lambda: model.prefill(prompt), reps=1, batches=3,
                           warmup=1)
    run.times(prefill_ms, f"prefill B={b} S={rows} ({p} patch rows)",
              (2 * mm * b * rows + 2 * L * b * h * rows * rows * hd
               + 2 * b * p * d * d + 2 * b * d * cfg.vocab,
               w16 + b * rows * kv_row),
              decode_ms, f"decode B={b}, {w_mid} cached rows, a step",
              (2 * mm * b + 4 * L * b * h * w_mid * hd
               + 2 * b * d * cfg.vocab, w16 + b * w_mid * kv_row))
    return run.finish()


def serve_verdicts(tag, kind, runs, oracle, what) -> None:
    for name, got in runs:
        diff = sorted(u for u in oracle if got.get(u) != oracle[u])
        print(f"{tag} serve {kind} {name} at batch {SERVE_BATCH}: "
              f"{len(oracle) - len(diff)} of {len(oracle)} requests' greedy "
              f"tokens identical to {what}"
              f"{'' if not diff else ' FAILED: ' + str(diff)}", flush=True)
        if diff:
            fail(f"{tag} serve {name}: requests {diff} differ from {what}")


def serve_cohort(run, model) -> None:
    """ServingLoop of ``model`` (run's arch, at a depth of its own) on phase
    8's trace, cut as COHORT_ROWS says, which falls back to the
    cohort scheduler (no paged decode for a recurrent state or an
    encoder-decoder), at batch SERVE_BATCH, FIFO and reversed.  A cohort
    left-pads its prompts to its longest, and the pad tokens run through the
    recurrences (as in the reference; only attention masks them), so a
    request's oracle is not its bare prompt: it is the request served alone
    with the same pad count, beside a filler prompt (zeros, one new token) of
    its cohort's width, in a batch-SERVE_BATCH loop (the same shapes, encdec's
    zero frames at that width too; rows share no op).  Every request has its
    oracle, one a (request, pad count, width): a request that meets the same
    cohort width and pad in both orders shares it."""
    import numpy as np
    from repro_torch.launch.serve import ServingLoop
    from repro_torch.serve import Request
    from repro_torch.serve import scheduler as sched
    trace, fresh = serve_trace(run.cfg.vocab, cohort=True)
    print(f"{run.tag} serve model: {model.cfg.n_layers} layers"
          + (f" and {model.cfg.n_enc_layers} encoder layers"
             if model.cfg.is_encdec else "")
          + ", every width as published", flush=True)

    def loop():
        return ServingLoop(model, batch=SERVE_BATCH, max_new=16,
                           block_len=SERVE_BLOCK)

    def served(reqs):
        """-> (tokens by uid, each uid's (pad, width)), the seconds."""
        pads = {}

        def keep(args, kw, out):
            for i, r in enumerate(args[0]):
                pads[r.uid] = (int(out[1][i]), out[0].shape[1])
        t0 = time.perf_counter()
        with calls_of(sched, "pack_prompts", float("inf"), keep=keep):
            out = loop().run(reqs, max_steps=64)
        return out, pads, time.perf_counter() - t0

    kind = loop().scheduler_kind
    if kind != "cohort":
        fail(f"{run.tag} serve: ServingLoop ran {kind}, not cohort")
    oracles, seconds = {}, {}
    for name in ("fifo", "reversed"):
        got, pads, seconds[name] = served(fresh(name))
        want = {}
        for r in fresh("solo"):
            pad, width = pads[r.uid]
            if (r.uid, pad, width) not in oracles:
                filler = Request(uid=10_000 + r.uid, max_new=1,
                                 prompt=np.zeros(width, np.int32))
                out, _, sec = served([r] + ([filler] if pad else []))
                oracles[(r.uid, pad, width)] = out[r.uid]
                seconds["oracles"] = seconds.get("oracles", 0.0) + sec
            want[r.uid] = oracles[(r.uid, pad, width)]
        widths = sorted({w for _, w in pads.values()})
        serve_verdicts(run.tag, kind, (("FIFO" if name == "fifo" else name,
                                        got),), want,
                       f"its prompt served alone at the same pad count "
                       f"(cohort widths {widths}, pads "
                       f"{[pads[u][0] for u in sorted(pads)]} by uid)")
    n_tok = sum(len(v) for v in got.values())
    print(f"{run.tag} serve time cohort batch {SERVE_BATCH}, "
          f"{model.cfg.n_layers} layers (phase 8's trace, "
          f"prompts {[len(r.prompt) for r in trace]}, max_new "
          f"{[r.max_new for r in trace]}): {n_tok} tokens a run, FIFO "
          f"{seconds['fifo']:.3f} s ({n_tok / seconds['fifo']:.2f} tokens/s), "
          f"reversed {seconds['reversed']:.3f} s; {len(oracles)} oracle runs "
          f"{seconds.get('oracles', 0.0):.3f} s", flush=True)


def ssm_model(card: str) -> dict:
    """xlstm-1.3b: its counts; counted, a prefill of MODEL_B prompts of
    MODEL_S, timed with its sLSTM blocks, SSM_NEW greedy steps and forward
    over S + SSM_NEW (3 batched launches a mLSTM layer).  After the
    counters: the rounding floor; the whole model at chunk 64 against
    SSM_ALT_CHUNK and decode against forward, held to twice the floor
    (``mlstm_step``'s h = num / max(|q n|, e^-m) divides by a near-zero q
    n at random weights, so 48 layers are chaotic and the floor is near
    uncorrelated logits); the same on the SSM_SHALLOW stack
    (``ssm_shallow``);
    each layer on the forward's own inputs to it: its block at chunk 64
    against SSM_ALT_CHUNK, and a prefill of S then SSM_NEW decode steps
    (stepwise) against the forward's rows (chunkwise).  Then layer 0's
    mLSTM and the first sLSTM block against their float64
    recomputations; a planted fault (layer 0's forget-gate bias negated)
    the mLSTM block check must reject; a decode step at batch B against
    each row alone; ServingLoop (``serve_cohort``); times beside
    bounds."""
    import torch
    from repro_torch.kernels import matmul
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tfm
    run = FamilyRun(SSM_ARCH, card)
    model, cfg = run.model, run.cfg
    b, s, new = MODEL_B, MODEL_S, SSM_NEW
    n_m, n_s = tfm.ssm_layer_counts(cfg)
    h, cdt = cfg.n_heads, torch.bfloat16
    dh = cfg.ssm.expand * cfg.d_model // h
    alt = dataclasses.replace(cfg.ssm, chunk=SSM_ALT_CHUNK)
    toks = run.tokens(b, s + new)
    prompt = {"tokens": toks[:, :s]}
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with calls_of(ssm, "mlstm_block") as m_pre, \
            calls_of(ssm, "slstm_block", n_s, timed=True) as s_pre:
        logits, state = model.prefill(prompt)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    spent = [sec for *_, sec in s_pre]
    print(f"{run.tag} prefill B={b} S={s}: {prefill_ms:.1f} ms (host clock, "
          f"synchronised), of it the {len(spent)} sLSTM blocks "
          f"{sum(spent) * 1e3:.1f} ms ({sum(spent) / (len(spent) * s) * 1e6:.1f}"
          f" us a step of the time loop, projections included), host-bound "
          f"({card})", flush=True)
    fed, steps, decode_ms = run.greedy(logits, state_rows(state, slice(None)),
                                       new)
    seq = torch.cat([toks[:, :s]] + fed, dim=1)
    before = matmul.BATCHED_LAUNCHES
    with calls_of(ssm, "mlstm_block", n_m) as m_fw, \
            calls_of(ssm, "slstm_block", n_s) as s_fw:
        full = model.forward({"tokens": seq})
    n_batched = matmul.BATCHED_LAUNCHES - before
    run.count()
    print(f"{run.tag} batched launches a forward: {n_batched} (3 a mLSTM "
          f"layer: {3 * n_m})", flush=True)
    if n_batched != 3 * n_m:
        fail(f"{run.tag}: {n_batched} batched launches a forward, not "
             f"{3 * n_m}")

    # after the counters: the whole model against its rounding floor, at
    # full depth and on the SSM_SHALLOW stack
    run.floor = run.floor_of(model, prompt, None, logits)
    with configured(model, ssm=alt):
        alt_logits, _ = model.prefill(prompt)
    run.close(f"whole model, prefill B={b} S={s}, chunk {cfg.ssm.chunk} "
              f"against chunk {SSM_ALT_CHUNK}", logits, alt_logits)
    run.close(f"whole model, {new} decode steps against forward over "
              f"{seq.shape[1]} tokens", torch.stack(steps, 1), full[:, s:])
    del full, alt_logits
    ssm_shallow(run, prompt, alt)

    # each layer on the forward's own inputs to it: chunk sizes, and
    # chunkwise against stepwise
    worst = {"chunk": 0.0, "step": 0.0, "slstm step": 0.0}
    alt_cfg = dataclasses.replace(cfg, ssm=alt)

    def held(kind, i, got, want):
        err = float((got.float() - want.float()).abs().max())
        lim = FAMILY_BLOCK_TOL * float(want.float().abs().max())
        worst[kind] = max(worst[kind], err / lim)
        if err > lim:
            fail(f"{run.tag} layer {i} {kind}: max_abs_err {err:.4g} beyond "
                 f"{lim:.4g}")
    for i, ((p_, x_, *_), kw, (out, _), _) in enumerate(m_fw):
        zero = ssm.mlstm_state_init(b, h, dh, device=run.dev)
        y64, st = ssm.mlstm_block(p_, x_[:, :s], cfg, zero, **kw)
        y32, _ = ssm.mlstm_block(p_, x_[:, :s], alt_cfg, zero, **kw)
        held("chunk", i, y32, y64)
        ys = []
        for t in range(new):
            y, st = ssm.mlstm_block(p_, x_[:, s + t:s + t + 1], cfg, st,
                                    mode="decode", n_heads=h,
                                    compute_dtype=cdt)
            ys.append(y)
        held("step", i, torch.cat(ys, 1), out[:, s:])
    for i, ((p_, x_, *_), kw, (out, _), _) in enumerate(s_fw):
        zero = ssm.slstm_state_init(b, h, cfg.d_model // h, device=run.dev)
        _, st = ssm.slstm_block(p_, x_[:, :s], cfg, zero, **kw)
        ys = []
        for t in range(new):
            y, st = ssm.slstm_block(p_, x_[:, s + t:s + t + 1], cfg, st,
                                    mode="decode", n_heads=h,
                                    compute_dtype=cdt)
            ys.append(y)
        held("slstm step", f"s{i}", torch.cat(ys, 1), out[:, s:])
    print(f"{run.tag} each layer on the forward's own inputs (of "
          f"{seq.shape[1]} tokens), max_abs_err over FAMILY_BLOCK_TOL x its "
          f"largest value, the worst layer: {n_m} mLSTM blocks at chunk "
          f"{cfg.ssm.chunk} against {SSM_ALT_CHUNK} over {s} rows "
          f"{worst['chunk']:.3g}; a prefill of {s} then {new} decode steps "
          f"against the forward's rows {worst['step']:.3g}; {n_s} sLSTM "
          f"blocks likewise {worst['slstm step']:.3g} (each at most 1)",
          flush=True)
    del m_fw, s_fw

    # layer 0's mLSTM and the first sLSTM block against float64
    ((p_, x_, *_), kw, (out, _), _), = m_pre
    sound = mlstm_block_plain(p_, x_, cfg)
    run.block(f"mLSTM layer 0 {tuple(x_.shape)} against its float64 "
              f"stepwise recomputation", out, sound)
    keep = p_["b_f"].clone()
    p_["b_f"].neg_()
    try:
        bad, _ = ssm.mlstm_block(p_, x_, cfg, ssm.mlstm_state_init(
            b, h, dh, device=run.dev), **kw)
    finally:
        p_["b_f"].copy_(keep)
    run.block("mLSTM layer 0 with a planted fault (its forget-gate bias "
              "negated) against the sound recomputation", bad, sound,
              planted=True)
    (p_, x_, *_), kw, (out, _), _ = s_pre[0]
    run.block(f"sLSTM layer 0 {tuple(x_.shape)} against its float64 "
              f"recomputation", out, slstm_block_plain(p_, x_, cfg))
    del m_pre, s_pre, sound, bad
    decode_invariance(run.tag, model, state, fed[0])
    run.loss_refused({"tokens": toks[:, :64], "labels": toks[:, :64]})
    depth, every = SSM_COHORT
    shallow = run.build(dataclasses.replace(
        cfg, n_layers=depth, ssm=dataclasses.replace(cfg.ssm,
                                                     slstm_every=every)))
    serve_cohort(run, shallow)
    del shallow
    # times beside bounds: the products and the chunkwise recurrence's
    # (q k^T and s v in a chunk, q C and the C update a token: 4 L dh +
    # 4 dh^2 a token a head) at the bf16 rate, the bf16 weights read once
    # and the f32 states written (prefill) or read and written (decode)
    d = cfg.d_model
    inner, dhs, L_c = cfg.ssm.expand * d, d // h, cfg.ssm.chunk
    m_tok = 2 * (3 * d * inner + 3 * inner * dh + 2 * inner * h)
    s_tok = 2 * (4 * d * d + 4 * h * dhs * dhs + 3 * d * d)
    rec = h * (4 * L_c * dh + 4 * dh * dh)
    state_b = 4 * (n_m * b * h * (dh * dh + dh + 1) + n_s * b * 4 * d)
    w16 = run.n_params * 2
    run.times(prefill_ms, f"prefill B={b} S={s} (host clock)",
              (b * s * (n_m * (m_tok + rec) + n_s * s_tok)
               + 2 * b * d * cfg.vocab, w16 + state_b),
              decode_ms, f"decode B={b}, a step",
              (b * (n_m * (m_tok + 4 * h * dh * dh) + n_s * s_tok)
               + 2 * b * d * cfg.vocab, w16 + 2 * state_b))
    return run.finish()


def ssm_shallow(run, prompt, alt) -> None:
    """xlstm on a shallow stack (SSM_SHALLOW, every width as published,
    its own weights seeded as the full model's): its rounding floor, then
    the prefill at chunk 64 against ``alt``'s chunk and SSM_NEW decode
    steps against forward, each held to twice that floor; a planted fault,
    every layer's state handed to the next layer of its kind after the
    prefill (an off-by-one in the carry), which the decode check must
    reject."""
    import torch
    from repro_torch.models import transformer as tfm
    depth, every = SSM_SHALLOW
    cfg = dataclasses.replace(run.cfg, n_layers=depth, ssm=dataclasses.replace(
        run.cfg.ssm, slstm_every=every))
    model = run.build(cfg)
    n_m, n_s = tfm.ssm_layer_counts(cfg)
    what = f" at {depth} layers ({n_s} groups of {every - 1} mLSTM + 1 sLSTM)"
    s = prompt["tokens"].shape[1]
    logits, state = model.prefill(prompt)
    floor = run.floor_of(model, prompt, None, logits, what)
    with configured(model, ssm=dataclasses.replace(alt, slstm_every=every)):
        alt_logits, _ = model.prefill(prompt)
    run.close(f"whole model{what}, chunk {cfg.ssm.chunk} against chunk "
              f"{alt.chunk}", logits, alt_logits, floor=floor)
    fed, steps, _ = run.greedy(logits, state_rows(state, slice(None)),
                               SSM_NEW, model)
    full = model.forward({"tokens": torch.cat([prompt["tokens"]] + fed, 1)})
    run.close(f"whole model{what}, {SSM_NEW} decode steps against forward",
              torch.stack(steps, 1), full[:, s:], floor=floor)
    bad = state_rows(state, slice(None))
    for f, axis in (("mlstm_c", 0), ("mlstm_n", 0), ("mlstm_m", 0),
                    ("slstm", 1)):
        x = getattr(bad, f)
        x.copy_(x.roll(1, axis))
    steps = []
    for tok in fed:
        out, bad = model.decode_step(bad, tok)
        steps.append(out)
    run.close(f"whole model{what}, {SSM_NEW} decode steps with a planted "
              f"fault (each layer's state handed to the next of its kind "
              f"after the prefill) against forward", torch.stack(steps, 1),
              full[:, s:], planted=True, floor=floor)
    del model, state, bad, full


def hybrid_model(card: str) -> dict:
    """hymba-1.5b: its counts; before the counters, the chunked prefill
    and the rounding floor; then, counted, a prefill of HYBRID_B prompts
    of HYBRID_S at each strategy of the bf16 flash kernel (windowed on 29
    layers, full causal on 3) against attention="chunked", HYBRID_NEW
    decode steps and forward.  After the counters: the decode steps
    against forward; layer 0's (global), layer 1's (local) and layer
    HYBRID_FAULT_LAYER's (global) flash calls against the plain version at
    the layer's window; layer 0's Mamba block, the SSD chunk against the
    associative scan; a decode step at batch SERVE_BATCH against each row
    alone; a planted fault (global layer HYBRID_FAULT_LAYER at the
    window), which the layer's flash check must reject (its effect on the
    last-token logits, printed, is below the rounding floor: attention
    over random weights averages); ServingLoop (``serve_cohort``); times
    beside bounds."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tfm
    run = FamilyRun(HYBRID_ARCH, card)
    model, cfg = run.model, run.cfg
    b, s, new = HYBRID_B, HYBRID_S, HYBRID_NEW
    toks = run.tokens(b, s + new)
    prompt = {"tokens": toks[:, :s]}
    glob = [int(i) for i in torch.nonzero(torch.as_tensor(
        tfm.layer_flags(cfg)["global_attn"]))[:, 0]]
    print(f"{run.tag} global layers {glob}, window {cfg.attn.window} on the "
          f"other {cfg.n_layers - len(glob)}", flush=True)
    want = run.reference(prompt, s + new)
    reset_launches()
    logits, state = run.prefill_strategies(prompt, s + new, want)
    fed, steps, decode_ms = run.greedy(logits, state_rows(state, slice(None)),
                                       new)
    seq = torch.cat([toks[:, :s]] + fed, dim=1)
    full = model.forward({"tokens": seq})
    run.count()
    run.close(f"{new} decode steps against forward over {seq.shape[1]} "
              f"tokens", torch.stack(steps, 1), full[:, s:])
    del full
    with calls_of(ops, "flash_attention", HYBRID_FAULT_LAYER + 1) as seen, \
            calls_of(ssm, "mamba_apply") as mb:
        model.prefill(prompt)
    run.flash_check(seen, [0, 1, HYBRID_FAULT_LAYER])
    del seen
    # layer 0's Mamba block on its prefill input from a zero state (the
    # state it was given has been written since), SSD and scan
    (p_, x_, cfg_, st0), kw, _, _ = mb[0]
    zero = ssm.MambaState(torch.zeros_like(st0.s))
    out, st = ssm.mamba_apply(p_, x_, cfg_, zero, **kw)
    real = ssm._mamba_ssd_chunk
    ssm._mamba_ssd_chunk = scan_chunk
    try:
        out_scan, st_scan = ssm.mamba_apply(p_, x_, cfg_, zero, **kw)
    finally:
        ssm._mamba_ssd_chunk = real
    run.block(f"Mamba layer 0 {tuple(x_.shape)}, the SSD chunk against the "
              f"associative scan", out, out_scan)
    err = float((st.s - st_scan.s).abs().max())
    lim = MAMBA_STATE_TOL * float(st_scan.s.abs().max())
    print(f"{run.tag} Mamba layer 0 final state, SSD against the scan: "
          f"max_abs_err {err:.4g} (at most {lim:.4g})"
          f"{verdict_of(err <= lim, False)}", flush=True)
    if err > lim:
        fail(f"{run.tag} Mamba state: {err:.4g} beyond {lim:.4g}")
    del mb, out, out_scan
    # a decode step at batch SERVE_BATCH: the prefill's rows repeated
    four = state_rows(state, torch.arange(SERVE_BATCH, device=run.dev) % b)
    decode_invariance(run.tag, model, four,
                      torch.cat([fed[0]] * (SERVE_BATCH // b)))
    del four
    real_flags = tfm.layer_flags

    def faulted(cfg_):
        flags = real_flags(cfg_)
        flags["global_attn"] = flags["global_attn"].copy()
        flags["global_attn"][HYBRID_FAULT_LAYER] = False
        return flags
    tfm.layer_flags = faulted
    try:
        with calls_of(ops, "flash_attention", HYBRID_FAULT_LAYER + 1) as seen:
            bad = model.prefill(prompt)[0]
    finally:
        tfm.layer_flags = real_flags
    run.flash_check(seen, [HYBRID_FAULT_LAYER], planted=True)
    del seen
    err, rel, _ = run.apart(bad, logits)
    print(f"{run.tag} the planted fault's effect on the last-token logits, "
          f"against the sound flash prefill: max_abs_err {err:.4g}, "
          f"relative l2 {rel:.3g} (the logits checks' limits: "
          f"{run.floor[0]:.4g}, {run.floor[1]:.3g})", flush=True)
    run.loss_refused({"tokens": toks[:, :64], "labels": toks[:, :64]})
    shallow = run.build(dataclasses.replace(cfg,
                                            n_layers=HYBRID_COHORT_LAYERS))
    serve_cohort(run, shallow)
    del shallow
    # times beside bounds: the products, attention (windowed rows on the
    # local layers) and the SSD chunks' products at the bf16 rate, the bf16
    # weights read once, the K/V rows and the f32 Mamba states
    d, L, hd, h = cfg.d_model, cfg.n_layers, cfg.head_dim_, cfg.n_heads
    inner, n_st, L_c = cfg.ssm.expand * d, cfg.ssm.d_state, cfg.ssm.chunk
    kvh = cfg.n_kv_heads
    dt_rank = max(d // 16, 8)
    mm = L * (2 * d * h * hd + 2 * d * kvh * hd + 3 * d * cfg.d_ff
              + 2 * d * inner + 2 * d * n_st + d * dt_rank + dt_rank * inner
              + inner * d)
    att_rows = len(glob) * s * (s + 1) // 2 + (L - len(glob)) * sum(
        min(t + 1, cfg.attn.window) for t in range(s))
    ssd_tok = 2 * L_c * n_st + 2 * L_c * inner + 4 * inner * n_st
    kv_row = 2 * L * kvh * hd * 2
    # a decode step reads the K/V rows a layer attends: all on a global
    # layer, the window on a local one
    w_mid = s + new // 2
    kv_read = 2 * kvh * hd * 2 * (len(glob) * w_mid + (
        L - len(glob)) * min(w_mid, cfg.attn.window))
    mamba_b = 4 * L * b * inner * n_st
    w16 = run.n_params * 2
    prefill_ms = device_ms(lambda: model.prefill(prompt), reps=1, batches=1,
                           warmup=0)
    run.times(prefill_ms, f"prefill B={b} S={s}",
              (2 * mm * b * s + 4 * b * h * hd * att_rows
               + L * b * s * ssd_tok + 2 * b * d * cfg.vocab,
               w16 + b * s * kv_row + mamba_b),
              decode_ms, f"decode B={b}, {w_mid} cached rows, a step",
              (2 * mm * b + 4 * b * h * hd * (
                  len(glob) * w_mid + (L - len(glob)) * cfg.attn.window)
               + L * b * 6 * inner * n_st + 2 * b * d * cfg.vocab,
               w16 + b * kv_read + 2 * mamba_b))
    return run.finish()


#: phase 11, the encdec family at full width and depth: whisper-medium (24
#: encoder and 24 decoder layers, d_model 1024, 16 heads of 64 over 16 kv
#: heads, d_ff 4096, tanh GELU, layernorm, sinusoidal positions, vocab
#: 51865 padded to 51968), weights from a seeded generator
ENCDEC_ARCH = "whisper-medium"
#: ENC_B rows: an encode of ENC_FRAMES frames (whisper's 30 s window,
#: configs/whisper_medium.py ENC_FRAMES_DECODE), a prefill of ENC_S tokens
#: (its text context) over as many frames, ENC_NEW greedy decode steps,
#: ENC_CHECK_STEPS of them held against a forward over the whole sequence.
#: Neither 1,500 nor 448 is a multiple of the flash kernel's 128 rows, so
#: every non-causal call runs with a key count below its padded length
ENC_B, ENC_FRAMES, ENC_S, ENC_NEW = 4, 1500, 448, 16
ENC_CHECK_STEPS = (0, 5, 10, 15)


class EncDecRun(FamilyRun):
    """FamilyRun for whisper-medium: its parameters against
    param_count(), a prefill's flash launches (one an encoder layer, two a
    decoder layer: self and cross) and its layer checks."""

    @property
    def flash_per_prefill(self) -> int:
        return self.cfg.n_enc_layers + 2 * self.cfg.n_layers

    def count_params(self) -> None:
        total = self.cfg.param_count()
        print(f"{self.tag} parameters: module {self.n_params}, "
              f"param_count() {total}, module - analytic "
              f"{self.n_params - total} (the vocab padding's rows, the "
              f"biases of the layernorms the count leaves out)", flush=True)

    def layer_check(self, what, call, causal: bool, kv_len: int,
                    planted=False) -> None:
        """A kept flash call (``calls_of`` ops.flash_attention) against the
        plain version on its own q, k, v at the layer's own mask (``causal``
        and ``kv_len``, whatever the call was given), within 2e-5; with
        ``planted`` the call carried a fault, which the check must
        reject."""
        import torch
        from repro_torch.kernels import flash_attention
        (q_, k_, v_), kw, out, _ = call
        plain = flash_attention.flash_attention_plain(
            q_, k_, v_, causal=causal, window=0, scale=kw["scale"],
            kv_len=kv_len)
        err = float((out - plain).abs().max())
        ok = bool(torch.allclose(out, plain, rtol=2e-5, atol=2e-5))
        print(f"{self.tag} {what} flash {tuple(q_.shape)} {q_.dtype} "
              f"causal={kw['causal']} kv_len={kw['kv_len']}: max_abs_err "
              f"{err:.3g} against the plain version at causal={causal} "
              f"kv_len={kv_len} (rtol and atol 2e-5)"
              f"{verdict_of(ok, planted)}", flush=True)
        if ok == planted:
            fail(f"{self.tag} {what} flash: max_abs_err {err:.3g}")


def encdec_forward(model, tokens, enc_out):
    """The logits of ``model``'s decoder over ``tokens`` (B, S) in train
    mode on ``enc_out`` (B, T, d) of T < S frames, a prefill's: forward's
    own attend_chunked takes as many frames as tokens, so the
    cross-attention runs as attend_prefix over every frame at the
    reference's decode query position 2**30; the self-attention runs on
    the model's flash kernel."""
    import torch
    from repro_torch.models import attention, encdec
    from repro_torch.models import transformer as tfm
    real = attention.attend_chunked

    def cross(q, k, v, idx, *, causal, **kw):
        if causal or k.shape[1] == q.shape[1]:
            return real(q, k, v, idx, causal=causal, **kw)
        b, t = k.shape[:2]
        pos = torch.arange(t, dtype=torch.int32, device=k.device).expand(b, t)
        far = torch.full((b, q.shape[1]), 2 ** 30, dtype=torch.int32,
                         device=k.device)
        return attention.attend_prefix(q, k, v, pos, idx, q_positions=far)
    attention.attend_chunked = cross
    try:
        x, _ = encdec.decoder(model.net, tokens, enc_out, mode="train",
                              attention=model.attention)
    finally:
        attention.attend_chunked = real
    return tfm.unembed(model.net, x)


def encdec_path(card: str) -> dict:
    """``encdec_phase`` without autograd but for its loss check, after
    phase 10 frees its last model."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        return encdec_phase(card)


def encdec_phase(card: str) -> dict:
    """Phase 11, whisper-medium at full width and depth (``EncDecRun``):
    its parameters beside param_count(); before the counters, attention=
    "chunked"'s encode and prefill and their rounding floors (bf16
    against float32); then, counted, a prefill of ENC_B prompts of ENC_S
    tokens over as many frames at each strategy of the bf16 flash kernel
    (72 launches each) and an encode of ENC_B x ENC_FRAMES frames at each
    (24 each), each against chunked within FAMILY_OWN times its floor,
    and ENC_NEW greedy decode steps.  After the counters: ENC_CHECK_STEPS
    against a forward over the whole sequence on the prefill's encoder
    output (``encdec_forward``); the decode with the carried cross K/V
    zeroed, which that check must reject; a decode step at batch ENC_B
    against each row alone, bit for bit; encoder layer 0's flash call at
    ENC_FRAMES and ENC_S and decoder layer 0's self and cross calls at
    ENC_S against the plain version at 2e-5; two faults planted in
    encoder layer 0's call (run causal; the key count dropped, so the
    padded keys are attended) that its check must reject, each one's
    effect on the logits printed; Model.loss under autograd refused;
    ServingLoop at full depth on phase 8's trace cut as COHORT_ROWS says
    (cohort fallback), FIFO and reversed at batch SERVE_BATCH
    bit-identical to each request's oracle; encode,
    prefill and decode times beside their bounds, the peak memory and the
    phase's seconds.  Returns the launches by (kernel, strategy)."""
    import torch
    from repro_torch.core.async_pipeline import Strategy
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.models import encdec
    run = EncDecRun(ENCDEC_ARCH, card)
    model, cfg, dev = run.model, run.cfg, run.dev
    b, s, new, t_long = ENC_B, ENC_S, ENC_NEW, ENC_FRAMES
    n_enc, L = cfg.n_enc_layers, cfg.n_layers
    toks = run.tokens(b, s + new)
    frames = torch.randn(b, s, cfg.d_model, generator=run.g, device=dev)
    long = torch.randn(b, t_long, cfg.d_model, generator=run.g, device=dev)
    prompt = {"tokens": toks[:, :s], "frames": frames}
    budget = s + new
    # before the counters: chunked's encode and prefill, and their floors
    want_enc = encdec.encode(run.chunked.net, long, "chunked")
    with configured(run.chunked, dtype="float32"):
        exact = encdec.encode(run.chunked.net, long, "chunked")
    err, rel, top = run.apart(want_enc, exact)
    enc_floor = (FAMILY_OWN * err, FAMILY_OWN * rel)
    print(f"{run.tag} rounding floor of the encode ({b} x {t_long} frames): "
          f"bf16 against float32: max_abs_err {err:.4g}, relative l2 "
          f"{rel:.3g}, |out| <= {top:.3g}; the encode checks hold "
          f"{FAMILY_OWN} times these", flush=True)
    del exact
    want = run.reference(prompt, budget)
    reset_launches()
    logits, state = run.prefill_strategies(prompt, budget, want)
    for st in Strategy:
        ops.set_default_config("flash_attention", strategy=st)
        before = flash_attention.LAUNCHES
        got = encdec.encode(model.net, long)
        n = flash_attention.LAUNCHES - before
        key = ("flash_attention-bf16", st)
        run.launches[key] = run.launches.get(key, 0) + n
        run.close(f"encode {b} x {t_long} frames {st.value} ({n} flash "
                  f"launches), flash against chunked", got, want_enc,
                  floor=enc_floor)
        if n != n_enc:
            fail(f"{run.tag} encode {st.value}: {n} flash launches, not "
                 f"{n_enc}")
    ops.reset_default_configs()
    del got
    fed, steps, decode_ms = run.greedy(logits, state_rows(state, slice(None)),
                                       new)
    run.count()
    n_flash = sum(n for (k, _), n in run.launches.items()
                  if k == "flash_attention-bf16")
    want_n = len(Strategy) * (n_enc + run.flash_per_prefill)
    print(f"{run.tag} flash launches in the counted calls: {n_flash} ("
          f"{len(Strategy)} prefills x {run.flash_per_prefill} and "
          f"{len(Strategy)} encodes x {n_enc}: {want_n})", flush=True)
    if n_flash != want_n:
        fail(f"{run.tag}: {n_flash} flash launches, not {want_n}")
    # decode against a forward over the whole sequence on the prefill's
    # encoder output; then with the carried cross K/V zeroed (planted)
    seq = torch.cat([toks[:, :s]] + fed, dim=1)
    enc_out = encdec.encode(model.net, frames)
    full = encdec_forward(model, seq, enc_out)
    picks = list(ENC_CHECK_STEPS)
    run.close(f"decode steps {picks} against forward over {seq.shape[1]} "
              f"tokens and the prefill's {s} frames",
              torch.stack([steps[t] for t in picks], 1),
              full[:, [s + t for t in picks]])
    bad = state_rows(state, slice(None))
    bad.xk.zero_()
    bad.xv.zero_()
    bad_steps = []
    for t in range(max(picks) + 1):
        out, bad = model.decode_step(bad, fed[t])
        bad_steps.append(out)
    run.close(f"decode steps {picks} with a planted fault (the carried cross "
              f"K/V zeroed) against forward",
              torch.stack([bad_steps[t] for t in picks], 1),
              full[:, [s + t for t in picks]], planted=True)
    del full, bad, bad_steps, enc_out
    decode_invariance(run.tag, model, state, fed[0])
    # layer checks on the model's own q, k and v
    with calls_of(ops, "flash_attention") as seen:
        encdec.encode(model.net, long)
    run.layer_check(f"encoder layer 0 S={t_long}", seen[0], False, t_long)
    with calls_of(ops, "flash_attention", n_enc + 2) as seen:
        sound = model.prefill(prompt)[0]
    run.layer_check(f"encoder layer 0 S={s}", seen[0], False, s)
    run.layer_check(f"decoder layer 0 self S={s}", seen[n_enc], True, s)
    run.layer_check(f"decoder layer 0 cross S={s}", seen[n_enc + 1], False,
                    s)
    for name, fault in (("the encoder run causal", {"causal": True}),
                        ("the key count dropped (padded keys attended)",
                         {"kv_len": None})):
        with calls_of(ops, "flash_attention", fault=fault) as seen:
            bad = model.prefill(prompt)[0]
        run.layer_check(f"encoder layer 0 S={s} with a planted fault ({name})",
                        seen[0], False, s, planted=True)
        err, rel, _ = run.apart(bad, sound)
        print(f"{run.tag} the planted fault's ({name}) effect on the "
              f"last-token logits, against the sound flash prefill: "
              f"max_abs_err {err:.4g}, relative l2 {rel:.3g} (the logits "
              f"checks' limits: {run.floor[0]:.4g}, {run.floor[1]:.3g})",
              flush=True)
    del seen, sound, bad
    run.loss_refused({"tokens": toks[:, :64], "labels": toks[:, :64],
                      "frames": frames[:, :64]})
    serve_cohort(run, model)
    # times beside bounds: the products and attention at the bf16 rate,
    # the bf16 weights read once, the caches written (prefill) or read
    # (decode: the self rows cached and the cross rows)
    d, hd, h, kvh, ff = (cfg.d_model, cfg.head_dim_, cfg.n_heads,
                         cfg.n_kv_heads, cfg.d_ff)
    enc_tok = 2 * (4 * d * h * hd + 2 * d * ff)
    dec_tok = 2 * (2 * d * h * hd + 2 * d * kvh * hd + 2 * d * h * hd
                   + 2 * d * ff)
    cross_kv = 2 * (2 * d * kvh * hd)
    n_enc_params = sum(p.numel() for p in model.net["enc_layers"].parameters())
    kv_row = 2 * kvh * hd * 2
    encode_ms = device_ms(lambda: encdec.encode(model.net, long), reps=1,
                          batches=3, warmup=1)
    least, by = bound(n_enc * (b * t_long * enc_tok
                               + 4 * b * h * t_long * t_long * hd),
                      n_enc_params * 2 + b * t_long * d * (4 + 2),
                      BF16_TC_OPS_PER_S)
    print(f"{run.tag} time encode B={b} T={t_long}: {encode_ms:.4f} ms, "
          f"bound {least:.4f} ms by {by} ({least / encode_ms:.1%} of it) "
          f"({card})", flush=True)
    prefill_ms = device_ms(lambda: model.prefill(prompt), reps=1, batches=3,
                           warmup=1)
    w_mid = s + new // 2
    run.times(prefill_ms, f"prefill B={b} S={s} over {s} frames",
              (n_enc * (b * s * enc_tok + 4 * b * h * s * s * hd)
               + L * (b * s * (dec_tok + cross_kv) + 2 * b * h * s * s * hd
                      + 4 * b * h * s * s * hd) + 2 * b * d * cfg.vocab,
               run.n_params * 2 + 2 * L * b * s * kv_row),
              decode_ms, f"decode B={b}, {w_mid} cached rows and {s} frames, "
              f"a step",
              (L * (b * dec_tok + 4 * b * h * (w_mid + s) * hd)
               + 2 * b * d * cfg.vocab,
               (run.n_params - n_enc_params) * 2
               + L * b * (w_mid + s) * kv_row))
    return run.finish()


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
            if label and label.startswith(FLASH_KERNELS + (
                    "matmul_f32_kernel", "matmul_bf16_batched_kernel")):
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
    # kvh, s, d), causal, window, q, k, v, plain, kv_len), N(0, 1), b = 0
    # for (h, s, d) operands; the "kv_len" cases at whisper-medium's heads,
    # S = 300 (a cohort width of phase 8's trace) and 1,500 (its encoder
    # window) padded up to 128-row blocks with noise in the padding, which
    # the key count must hide (the model pads with zeros)
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
            ("kv_len", (1, 16, 16, 384, 64, 300), False, 0),
            ("kv_len", (1, 16, 16, 1536, 64, 1500), False, 0),
            ("kv_len", (1, 12, 2, 384, 128, 300), True, 0),
            ("h100", (4, 12, 2, 4096, 128), True, 0)):
        b_, h_, kvh_, s_, d_, kv_len = (*shape, None)[:6]
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
                                 q_, k_, v_, causal=causal, window=window,
                                 kv_len=kv_len), kv_len))

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
        for label, shape, causal, window, q_, k_, v_, want, kv_len in \
                fa_cases if od == 2 else ():
            try:
                got = flash_attention.flash_attention_cuda(
                    q_, k_, v_, causal=causal, window=window, spec=spec,
                    kv_len=kv_len)
            except Exception as e:
                fail(f"flash_attention {spec} {shape}: {type(e).__name__}: {e}")
                continue
            err = held(f"flash_attention {spec} {shape} {q_.dtype} "
                       f"causal={causal} window={window} kv_len={kv_len}",
                       got, want, rtol=2e-5, atol=2e-5)
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
    # as FLASH_BF16_QK_PRODUCTS bf16 products and P.V as
    # FLASH_BF16_PV_PRODUCTS, which the design runs on wgmma (its floor,
    # printed beside, is the bound); q, k, v read in bf16 and out written
    # in f32; library: SDPA in bf16 (bf16 products and a bf16 P, a
    # yardstick only)
    fa16_work = ((FLASH_BF16_QK_PRODUCTS + FLASH_BF16_PV_PRODUCTS) * fa_ops / 2,
                 (hq.numel() + hk.numel() + hv.numel()) * 2 + hq.numel() * 4,
                 BF16_TC_OPS_PER_S)
    fa16_design = fa16_work[0] / BF16_TC_OPS_PER_S * 1e3
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
            floor = (f" (Q.K^T one bf16 product, P.V "
                     f"{FLASH_BF16_PV_PRODUCTS}, a bf16 term of P each; this "
                     f"design's {FLASH_BF16_QK_PRODUCTS} + "
                     f"{FLASH_BF16_PV_PRODUCTS} bf16 wgmma products "
                     f"{fa16_design:.4f} ms, {fa16_design / ms:.1%} of it; "
                     f"one bf16 product each, which the reference's f32 P "
                     f"rules out, {fa_ops / BF16_TC_OPS_PER_S * 1e3:.4f} ms)")
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

    # -- 7. the model path, 8. serving at full width, 9. moe, 10. the vlm,
    # ssm and hybrid families, 11. the encdec family ----------------------
    # the rows' launches: phase 4's cells and the model, serving, moe and
    # families paths' (the bf16 flash rows are theirs alone; the batched
    # matmul rows the moe and families paths', the moe path also timing
    # that kernel into ``timing``)
    for phase, fn in (("model path", model_path),
                      ("serving path", serving_path),
                      ("moe path", lambda c: moe_path(c, timing, max_err)),
                      ("families path", families_path),
                      ("encdec path", encdec_path)):
        try:
            for key, n_ in fn(card).items():
                launches[key] = launches.get(key, 0) + n_
        except Exception as e:
            fail(f"{phase}: {type(e).__name__}: {e}")

    # -- 12. result lines -------------------------------------------------
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
    expected = 12 * len(Strategy) + 4
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
