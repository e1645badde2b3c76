"""GPU smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, and builds the CUDA kernels from the sources in this
   checkout (one ``nvcc`` per source, all started together: the flash
   forward, the flash backward, the SSD scan forward and backward), timing
   the build and printing each kernel's ``ptxas -v`` registers and spills.
   Counts the HGMMA (wgmma), UTMALDG (TMA load) and HMMA (mma.sync)
   instructions in each library's SASS (``cuobjdump -sass``) and fails
   unless both flash libraries have HGMMA and UTMALDG and no HMMA and the
   SSD forward and backward have HMMA; fails if any ``ptxas`` log says it
   serialises wgmma (warning C7520, a wgmma under a branch; C7512, too few
   registers), if a forward kernel (D 32, 64, 80, 128), a bf16 kernel of
   the flash backward or a kernel of the SSD backward's bf16 path spills.
   Then TALP's device records, which come from CUPTI's activity API
   (read by a host library built here at first use): a sleep kernel's
   record against the CUDA events
   around it (CLOCK_BOUND), and a host sleep between two sleep kernels of
   one launch reported as device Idle.
2. Kernel phases: each hand-written kernel against its plain PyTorch
   version on the card, with the tolerance of tests/test_kernels.py::_tol
   printed per row:
   * the flash-attention forward over the shapes of the JAX package's
     kernel sweep, ragged shapes, the edges of the bf16 kernel's tiling,
     and the serving prefill shape of llama3.2-3b (B 8, S 1024, H 24, K 8,
     D 128, bf16), its output and its row log-sum-exp; then head dim 80
     (fp32 and bf16 MHA, GQA, ragged, window and soft-cap) and the serving
     prefill shape of zamba2-2.7b (B 8, S 4096, H = K 32, D 80, bf16;
     its plain version one request at a time). At both prefill shapes it
     times the plain version, then the kernel and one PyTorch library call
     (``scaled_dot_product_attention``, a yardstick only) in turns:
     library, kernel, kernel, library;
   * the flash-attention backward over the same rows and the training
     shape of llama3.2-3b (B 2, S 2048, H 24, K 8, D 128, bf16): dq, dk, dv
     against the plain backward and against autograd through the plain
     forward, both in fp32, and a second run bit-identical; at the training
     and the serving prefill shapes it times the plain version, then the
     kernels and the backward of ``scaled_dot_product_attention`` in turns;
   * the SSD chunked scan over the JAX package's SSD sweep, ragged L,
     initial state in and final state out, the edges of the bf16 kernels'
     chunk-parallel form, state size 64 and P = N = 128 on the bf16 path,
     and the serving prefill shapes of mamba2-130m (B 8, L 4096, H 24,
     P 64, G 1, N 128, chunk 256, bf16) and zamba2-2.7b (H 80, N 64),
     against the plain
     version evaluated in float64 on the same inputs (the plain version's
     own fp32 evaluation is printed beside it); at both prefill shapes it
     times the plain version and the kernel in turns: plain, kernel,
     kernel, plain (no single PyTorch call computes the scan);
   * the SSD backward over the same SSD rows and the training shape of
     mamba2-130m (B 8, L 4096, H 24, P 64, G 1, N 128, chunk 256, bf16):
     every gradient (dx, ddt, da, dB, dC, dD and, with a state, the initial
     state's) against autograd through the plain version evaluated in
     float64 on the same inputs (one request at a time at the training
     shape), fp32 rows elementwise at TOL[fp32], bf16 rows at TOL[bf16]
     on each gradient over its reference's max-abs, a second run
     bit-identical; at the training shape it times the plain backward
     (autograd through the plain version in fp32), the CUDA-core design
     (the fp32 path's kernels on the same values widened to fp32) and the
     tensor-core kernel in turns, beside the bound of ssd_backward_work,
     and prints one traced call's kernels by name.
   Timings are CUDA events around runs of back-to-back calls (ms per
   call), medians; kernel and yardstick are timed in turns.
3. Path checks: two narrow layers of each model's block on the card
   against the same layers on the CPU (plain versions), prefill then 4
   decode steps, the same bf16 weights (zamba2: its smoke config with head
   dim 80 and P 64, N 64, chunk 256, whose two shared-block repeats must
   write different KV rows); and one training step of the llama3.2-3b
   smoke config (head_dim 32) and one of the mamba2-130m smoke config, in
   fp32 and in bf16 compute, on the card against the CPU from the same
   state.
4. Serve phases: ``repro_torch.launch.serve.serve`` under the TALP monitor
   at full width, random weights from a seed: llama3.2-3b with 8 requests
   of 1024 prompt tokens and 64 generated tokens, then mamba2-130m (all
   24 layers) and zamba2-2.7b (all 54 layers) with 8 requests of 4096
   prompt tokens and 64 generated tokens. Every launch counter is set to 0
   just before each run and read just after: the prefill must launch each
   kernel as often as SERVE says (llama: the flash forward 28 times;
   mamba: the SSD scan 24 times; zamba2: 9 and 45) and no other. Checks
   the tokens and the TALP hierarchies.
5. Profile phases: prefills and decode steps of each model at its serve
   phase's shapes, timed without the profiler and traced with
   ``torch.profiler`` (CUDA activity only): the card's kernel time per
   call of each step (the union of its kernels) and its heaviest kernels.
   That kernel time over the serve phase's wall per call of the same step
   is the profiler's busy share of it, which TALP's device PE of the
   prefill and decode regions must match within PE_BOUND. The decode step
   is timed again with TALP's CUPTI collection open, for the collection's
   cost per step.
6. Train phases: ``repro_torch.launch.train.train`` under the TALP
   monitor at full width and depth, fp32 masters and AdamW moments on the
   card: llama3.2-3b (3.61 B parameters), 6 steps of 2 x 2048 tokens, and
   mamba2-130m (24 layers), 6 steps of 8 x 4096 tokens. The launch
   counters are set to 0 just before each run and read just after: per
   step, llama launches the flash forward 56 times (28 layers, twice with
   remat) and its backward 28 times; mamba the SSD forward 48 times and
   its backward 24 times. Prints each step's loss (all finite), step time,
   tokens/s, MFU, peak memory and TALP's train_loop numbers, then traces
   one more step with ``torch.profiler``: its kernel time over the
   train_loop's wall per step is the busy share TALP's train_loop device
   PE must match within PE_BOUND.
7. TALP flags phase: llama3.2-3b serving as in the serve phase, four
   times in turns: plain, with every runtime output of TALP (the
   ``--talp-*`` flags but the fault plan: step series of 64 decode steps,
   watchdog and its anomaly log, Chrome trace, JSONL stream, Prometheus on
   an ephemeral port of 127.0.0.1, spool, a sample every 16 tokens),
   plain, and flagged again with the JSON spool format; then a fifth run,
   flagged, with the step series draining at every step close as the
   JAX package's recorder does (what the deferral saves). Prints each run's
   prefill time and decode rate, the ratio of the medians, TALP Overhead,
   Computational Efficiency, the step rows and watchdog events, the bytes
   of the trace, stream and spool and the seconds of export and merge.
   Holds the trace valid with its device lane's Kernel time equal to the
   report's (1e-6 relative), one JSONL line per sample and one more, a
   scrape of ``/metrics`` during the run equal to the snapshot it names,
   the spool's one-rank job report, CE in (0, 1] and the step rows' mean
   device PE within PE_BOUND of the profiler's busy share of a decode
   step (the profile phase's kernel time over the rows' mean wall).
8. Fleet phase: two ``python -m repro_torch.launch.train`` processes on the
   one card, ranks 0 and 1 of mamba2-130m training at full width (global
   batch 8 x 4096, 4 x 4096 each, 6 steps), one spool, a step series,
   the watchdog and a sample every 3 steps. Both must exit 0, each
   launching the SSD kernels 48 and 24 times a step; the job report they
   publish must be byte-identical to an in-process merge of their two
   payloads, with two host-state rows; each rank's CE in (0, 1]; 6 step
   rows per rank. Prints each rank's step time, peak memory and device
   PE, and the job's host Load Balance and PE.
9. Prints one JSON line with every kernel's numbers, then, as the last
   line, ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no
result line. Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from unittest import mock
from contextlib import nullcontext, redirect_stdout
from pathlib import Path

import torch

SRC = Path(__file__).resolve().parent / "src"
sys.path.insert(0, str(SRC))

# Published peaks of one H100 SXM (dense): bf16 tensor cores, fp32 outside
# the tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

# rtol = atol, as tests/test_kernels.py::_tol.
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}

# (B, S, T, H, K, D, window, softcap, dtype): the rows of
# tests/test_kernels.py::ATTN_SWEEP, then ragged shapes the TPU kernel
# refused (S, T not multiples of the tile, S < T), then the serving
# prefill shape of llama3.2-3b.
SWEEP = [
    (1, 128, 128, 4, 4, 64, None, None, torch.float32),
    (2, 256, 256, 4, 2, 64, None, None, torch.float32),
    (1, 256, 256, 8, 2, 32, None, None, torch.float32),
    (1, 256, 256, 4, 1, 64, None, None, torch.float32),
    (1, 256, 256, 4, 2, 64, 64, None, torch.float32),
    (1, 256, 256, 4, 2, 64, None, 50.0, torch.float32),
    (1, 256, 256, 4, 2, 64, 128, 30.0, torch.float32),
    (1, 384, 384, 2, 2, 128, None, None, torch.float32),
    (2, 128, 128, 4, 2, 64, None, None, torch.bfloat16),
    (1, 256, 256, 4, 2, 64, 64, 50.0, torch.bfloat16),
    (1, 1000, 1000, 24, 8, 128, None, None, torch.bfloat16),
    (1, 1000, 1000, 4, 2, 64, 256, 30.0, torch.float32),
    (2, 100, 300, 8, 2, 32, None, None, torch.bfloat16),
    (1, 100, 300, 4, 2, 128, 50, None, torch.float32),
]
# The edges of the bf16 kernel's tiling (128 query rows, 128-key tiles, TMA
# boxes): S and T off the tile grid with S < T, window and soft-cap at D
# 128, D 32 (64-byte swizzle) with GQA 4, and S below one query tile.
SWEEP += [
    (1, 200, 328, 8, 2, 64, None, None, torch.bfloat16),
    (2, 384, 384, 4, 1, 128, 100, 50.0, torch.bfloat16),
    (2, 256, 256, 8, 2, 32, None, None, torch.bfloat16),
    (1, 64, 64, 4, 2, 128, None, None, torch.bfloat16),
]
# The edges of the bf16 backward's tiling (128-key and 128-row blocks, 64-row
# query steps): GQA 3 across a ragged 128-key block, T - S off the 64-row
# grid, a window inside one 128-key block with a soft-cap, one query row
# against a ragged key tile at D 32, and S < T with a window narrower than
# T - S, so that one 128-key block is seen by no query row.
SWEEP += [
    (1, 320, 320, 6, 2, 128, None, None, torch.bfloat16),
    (1, 150, 270, 4, 2, 64, None, None, torch.bfloat16),
    (1, 300, 300, 4, 2, 128, 96, 30.0, torch.bfloat16),
    (1, 1, 130, 4, 4, 32, None, None, torch.bfloat16),
    (1, 100, 400, 4, 2, 64, 64, None, torch.bfloat16),
]
PREFILL = (8, 1024, 1024, 24, 8, 128, None, None, torch.bfloat16)
# Head dim 80 (zamba2-2.7b's shared block, 2560 / 32 heads, MHA), forward
# only (the backward refuses D 80): fp32 and bf16 MHA, GQA 2:1, S and T off
# the tile grid with S < T, window and soft-cap; then zamba2's serving
# prefill shape.
SWEEP_D80 = [
    (1, 256, 256, 4, 4, 80, None, None, torch.float32),
    (2, 256, 256, 4, 4, 80, None, None, torch.bfloat16),
    (1, 256, 256, 8, 4, 80, None, None, torch.bfloat16),
    (1, 200, 328, 4, 2, 80, None, None, torch.bfloat16),
    (1, 256, 256, 4, 2, 80, 64, 30.0, torch.float32),
    (1, 384, 384, 4, 2, 80, 100, 50.0, torch.bfloat16),
]
ZAMBA_PREFILL = (8, 4096, 4096, 32, 32, 80, None, None, torch.bfloat16)

# (B, L, H, P, G, N, chunk, dtype, with_state): the rows of
# tests/test_kernels.py::SSD_SWEEP (no initial state, as the TPU kernel),
# then ragged L the TPU kernel refused and an initial state in, then the
# serving prefill shape of mamba2-130m. Every row checks the final state.
SSD_SWEEP = [
    (1, 64, 2, 16, 1, 16, 16, torch.float32, False),
    (2, 128, 4, 16, 2, 32, 32, torch.float32, False),
    (1, 128, 4, 64, 1, 64, 64, torch.float32, False),
    (1, 256, 8, 32, 1, 16, 128, torch.float32, False),
    (2, 128, 4, 16, 4, 32, 32, torch.float32, False),
    (1, 128, 4, 16, 2, 32, 32, torch.bfloat16, False),
    (1, 1000, 4, 64, 1, 128, 256, torch.bfloat16, True),
    (1, 1000, 4, 64, 1, 128, 256, torch.float32, True),
    (2, 100, 4, 16, 2, 32, 64, torch.float32, True),
    (2, 512, 8, 64, 1, 128, 256, torch.float32, True),
]
# The edges of the bf16 kernels' chunk-parallel form: L shorter than one
# chunk, many chunks (the state recurrence over 64), and two groups.
SSD_SWEEP += [
    (1, 100, 4, 64, 1, 128, 256, torch.bfloat16, True),
    (1, 4096, 4, 64, 1, 128, 64, torch.bfloat16, True),
    (2, 512, 8, 64, 2, 128, 256, torch.bfloat16, True),
]
# State size 64 on the bf16 path (zamba2-2.7b: P 64, N 64, chunk 256): one
# ragged chunk, many chunks, an initial state in every row, two groups.
SSD_SWEEP += [
    (1, 100, 4, 64, 1, 64, 256, torch.bfloat16, True),
    (1, 4096, 4, 64, 1, 64, 64, torch.bfloat16, True),
    (1, 1000, 8, 64, 1, 64, 256, torch.bfloat16, True),
    (2, 512, 8, 64, 2, 64, 256, torch.bfloat16, True),
]
SSD_PREFILL = (8, 4096, 24, 64, 1, 128, 256, torch.bfloat16, False)
ZAMBA_SSD_PREFILL = (8, 4096, 80, 64, 1, 64, 256, torch.bfloat16, False)
# P 128, N 128 on the bf16 path, after every other row (their seeds stay):
# there the backward's key pass gives each side of 16 key rows its own
# warp, where one warp holding dx's and dB's accumulators would spill.
SSD_P128 = (1, 600, 4, 128, 1, 128, 256, torch.bfloat16, True)

# TALP's device PE against the profiler's busy share of the same step:
# they must agree within this absolute bound on every serve path (prefill
# and decode) and on training (PERF.md, written before the first run).
PE_BOUND = 0.10
# The activity records' clock mapping against the CUDA-event yardstick:
# a sleep kernel's start and end within this many seconds of the events
# around it.
CLOCK_BOUND = 50e-6


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def time_samples(fn, reps: int = 25, warmup: int = 3, inner: int = 10) -> list:
    """``reps`` samples (ms per call), each a run of ``inner`` calls back to
    back between two CUDA events: the card's time per call, not the host's
    launch latency, which a single call between two events would add."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return times


def time_turns(*fns, reps: int = 25, inner: int = 10):
    """Medians (ms per call) of each of ``fns`` timed in turns: in order,
    then in reverse order (first, second, second, first for two), ``reps``
    samples each turn, so that a drift of the card's clock falls on all
    alike."""
    samples = [[] for _ in fns]
    for order in (range(len(fns)), reversed(range(len(fns)))):
        for k in order:
            samples[k] += time_samples(fns[k], reps, inner=inner)
    return tuple(statistics.median(t) for t in samples)


def attention_work(b, s, t, h, k, d, window, dtype):
    """(operations, bytes) the causal forward needs on these shapes:
    4·D operations per visible (query, key) pair; q, k, v read once and
    o written once."""
    rows = torch.arange(s)[:, None]
    cols = torch.arange(t)[None, :]
    vis = cols <= rows + (t - s)
    if window is not None:
        vis &= cols > rows + (t - s) - window
    flops = 4.0 * d * int(vis.sum()) * b * h
    esize = torch.finfo(dtype).bits // 8
    nbytes = esize * (2 * b * s * h * d + 2 * b * t * k * d)
    return flops, nbytes


KERNEL_NAMES = ("flash_fwd_wgmma", "flash_fwd_f32", "flash_bwd_preprocess",
                "flash_bwd_dkdv_f32", "flash_bwd_dq_f32", "flash_bwd_dkdv_wgmma",
                "flash_bwd_dq_wgmma", "ssd_chunk_state", "ssd_state_pass",
                "ssd_chunk_output", "ssd_fwd_f32", "ssd_bwd_outer",
                "ssd_bwd_tc_query", "ssd_bwd_tc_key", "ssd_bwd_query",
                "ssd_bwd_key", "ssd_bwd_chunk", "ssd_bwd_group_sum",
                "ssd_bwd_head_sum")


def _kernel_label(mangled: str) -> str:
    """A readable name for a mangled kernel instantiation."""
    base = re.search("|".join(KERNEL_NAMES), mangled)
    args = re.findall(r"Li(\d+)E", mangled)
    if "nv_bfloat16" in mangled:
        args.insert(0, "bf16")
    return f"{base.group(0) if base else mangled}<{','.join(args)}>"


def _trace_label(key: str) -> str:
    """A profiler row's kernel name without its return type, namespace and
    parameters: ``ssd_chunk_state<64, 128, 0>``."""
    return re.sub(r"^void |\(anonymous namespace\)::", "", key).split("(")[0]


def ptxas_summary(log: Path):
    """One line per kernel of a ``ptxas -v`` log: registers and spills."""
    for label, used, spill in ptxas_kernels(log):
        yield f"{label}: {used}; {spill}"


def ptxas_kernels(log: Path):
    """(kernel label, the "Used ... registers" text, the spill line) per
    kernel of a ``ptxas -v`` log."""
    fn, spill = None, ""
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and fn:
            yield _kernel_label(fn), line.split(':', 1)[1].strip(), spill
            fn = None


def spilled(spill_line: str) -> bool:
    """Whether a ptxas "N bytes spill stores, M bytes spill loads" line
    reports any spill."""
    return any(int(n) for n in re.findall(r"(\d+) bytes spill", spill_line))


SASS_OPS = ("HGMMA", "UTMALDG", "HMMA")


def sass_counts(lib: Path) -> dict:
    """How many ``wgmma`` (HGMMA), TMA load (UTMALDG) and ``mma.sync``
    (HMMA) instructions the library's SASS holds (``cuobjdump -sass``)."""
    from repro_torch.kernels import cuda_build

    tool = Path(cuda_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    ops = re.findall(r"\b(" + "|".join(SASS_OPS) + r")\b", sass)
    return {op: ops.count(op) for op in SASS_OPS}


def build_kernels() -> dict:
    """Compile every kernel source of the port at once, one ``nvcc`` per
    source, load the libraries, and check from their SASS that the flash
    forward and the flash backward run wgmma and TMA and no mma.sync and
    the SSD forward's and backward's kernels run mma.sync; that no
    ``ptxas`` log warns of serialised wgmma (C7520 or C7512); and that no
    flash forward kernel (D 32, 64, 80 and 128, bf16 and fp32), no bf16
    kernel of the flash backward and no kernel of the SSD backward's bf16
    path spills. Returns each kernel record's SASS counts."""
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.ssd import kernel as ssd

    def timed(source):
        t0 = time.perf_counter()
        lib = cuda_build.build(source)
        return lib, time.perf_counter() - t0

    t0 = time.perf_counter()
    sources = (flash.SOURCE, flash.BWD_SOURCE, ssd.SOURCE, ssd.BWD_SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(timed, sources))
    print(f"[build] {len(sources)} sources in {time.perf_counter() - t0:.1f}"
          f" s ({cuda_build.BUILD_DIR})")
    for source, (lib, secs) in zip(sources, built):
        print(f"[build] {source.name}: {secs:.1f} s")
        log = lib.with_suffix(".log")
        for line in ptxas_summary(log):
            print(f"[ptxas] {line}")
        text = log.read_text()
        assert "C7520" not in text and "instructions are serialized" not in text, (
            f"{source.name}: ptxas serialises wgmma:\n"
            + "\n".join(line for line in text.splitlines() if "serializ" in line))
    fwd_log = built[0][0].with_suffix(".log")
    fwd = [(label, spill) for label, _, spill in ptxas_kernels(fwd_log)]
    assert sorted(label for label, _ in fwd) == sorted(
        f"flash_fwd_{kind}<{d}>" for kind in ("wgmma", "f32")
        for d in (32, 64, 80, 128)), fwd
    assert not any(spilled(s) for _, s in fwd), fwd
    bwd_log = built[1][0].with_suffix(".log")
    spills = [(label, spill) for label, _, spill in ptxas_kernels(bwd_log)
              if label.startswith(("flash_bwd_dkdv_wgmma", "flash_bwd_dq_wgmma"))]
    assert len(spills) == 6, spills      # two passes at D 32, 64 and 128
    assert not any(spilled(s) for _, s in spills), spills
    # every kernel the SSD backward's bf16 path launches: four templated
    # tensor-core kernels (the two chunk-state modes, query, key) at each of
    # the 16 (P, N), the two recurrences, the chunk pass, the bf16 group sum
    # and the head sum
    ssd_bwd_log = built[3][0].with_suffix(".log")
    spills = [(label, spill) for label, _, spill in ptxas_kernels(ssd_bwd_log)
              if label.startswith(("ssd_chunk_state", "ssd_state_pass",
                                   "ssd_bwd_tc_", "ssd_bwd_chunk",
                                   "ssd_bwd_head_sum"))
              or label == "ssd_bwd_group_sum<bf16>"]
    assert len(spills) == 4 * 16 + 5, [label for label, _ in spills]
    assert not any(spilled(s) for _, s in spills), [
        (label, s) for label, s in spills if spilled(s)]
    flash.library()
    flash.backward_library()
    ssd.library()
    ssd.backward_library()
    counts = {name: sass_counts(lib) for name, (lib, _) in
              zip(("flash_attention_fwd", "flash_attention_bwd", "ssd_fwd",
                   "ssd_bwd"), built)}
    for name, c in counts.items():
        print(f"[sass] {name}: " + ", ".join(f"{op} {n}" for op, n in c.items()))
    f, b, s, sb = (counts[name] for name in (
        "flash_attention_fwd", "flash_attention_bwd", "ssd_fwd", "ssd_bwd"))
    assert f["HGMMA"] > 0 and f["UTMALDG"] > 0 and f["HMMA"] == 0, f
    assert b["HGMMA"] > 0 and b["UTMALDG"] > 0 and b["HMMA"] == 0, b
    assert s["HMMA"] > 0, s
    assert sb["HMMA"] > 0, sb
    return counts


def by_request(fn, *tensors, **kw):
    """``fn`` on each request (batch row) of ``tensors`` in turn, the
    outputs joined along the batch: the same function on the same inputs
    where the whole batch's fp32 score matrix would not fit the card
    (17 GB at zamba2-2.7b's prefill shape, about 52 GB at the plain
    version's peak)."""
    outs = [fn(*(x[i:i + 1] for x in tensors), **kw)
            for i in range(tensors[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def flash_timing(device, row, inputs, plain_by_request: bool) -> dict:
    """Times at one shape: the plain version, then the kernel and the
    library yardstick (``scaled_dot_product_attention``) in turns: library,
    kernel, kernel, library; and the bound from this shape's work."""
    from repro_torch.kernels.flash_attention import kernel, ref

    b, s, t, h, k, d, window, softcap, dtype = row
    q, kk, vv = inputs(99, b, s, t, h, k, d, dtype)
    plain = ((lambda: by_request(ref.attention_reference, q, kk, vv))
             if plain_by_request else
             (lambda: ref.attention_reference(q, kk, vv)))
    plain_ms = statistics.median(time_samples(plain, reps=5 if
                                              plain_by_request else 10,
                                              inner=2))
    # The library yardstick takes (B, H, S, D); the layout change is made
    # once, outside the timing. Library and kernel are timed in turns.
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kk, vv))
    library_ms, kernel_ms = time_turns(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True),
        lambda: kernel.flash_attention(q, kk, vv))
    flops, nbytes = attention_work(b, s, t, h, k, d, window, dtype)
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    shape = f"B{b} S{s} T{t} H{h} K{k} D{d} {str(dtype)[6:]} causal"
    print(f"[kernel] {shape}: kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms{' (one request at a time)' if plain_by_request else ''}"
          f", sdpa {library_ms:.4f} ms (in turns: sdpa, kernel, kernel, sdpa),"
          f" kernel/sdpa {kernel_ms / library_ms:.3f}, bound "
          f"{max(t_ops, t_bytes):.4f} ms ({flops / 1e9:.2f} GFLOP is "
          f"{t_ops:.4f} ms, {nbytes / 1e6:.1f} MB is {t_bytes:.4f} ms)")
    return dict(shape=shape, ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def kernel_phase(device: torch.device) -> dict:
    from repro_torch.kernels.flash_attention import kernel, ref

    def inputs(i, b, s, t, h, k, d, dtype):
        gen = torch.Generator(device=device).manual_seed(1000 + i)
        mk = lambda *shape: torch.randn(  # noqa: E731
            shape, generator=gen, device=device).to(dtype)
        return mk(b, s, h, d), mk(b, t, k, d), mk(b, t, k, d)

    errs = {}
    rows = SWEEP + SWEEP_D80 + [PREFILL, ZAMBA_PREFILL]
    for i, row in enumerate(rows):
        b, s, t, h, k, d, window, softcap, dtype = row
        q, kk, vv = inputs(i, b, s, t, h, k, d, dtype)
        out = kernel.flash_attention(q, kk, vv, causal=True, window=window,
                                     softcap=softcap)
        out2, lse = kernel.flash_attention(q, kk, vv, causal=True,
                                           window=window, softcap=softcap,
                                           return_lse=True)
        want, lse_want = by_request(
            ref.attention_reference_lse, q, kk, vv, causal=True,
            window=window, softcap=softcap)
        lse_want = lse_want.contiguous()
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        lse_err = (lse - lse_want).abs().max().item()
        print(f"[kernel] B{b} S{s} T{t} H{h} K{k} D{d} window={window} "
              f"softcap={softcap} {str(dtype)[6:]}: max_abs_err={err:.3e} "
              f"tol={TOL[dtype]}; lse max_abs_err={lse_err:.3e} "
              f"tol={TOL[torch.float32]}")
        torch.testing.assert_close(out.float(), want.float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])
        # asking for the LSE leaves the output as it was
        assert torch.equal(out, out2)
        torch.testing.assert_close(lse, lse_want, rtol=TOL[torch.float32],
                                   atol=TOL[torch.float32])
        errs[row] = err
        del q, kk, vv, out, out2, lse, want, lse_want

    llama = flash_timing(device, PREFILL, inputs, plain_by_request=False)
    zamba = flash_timing(device, ZAMBA_PREFILL, inputs,
                         plain_by_request=True)
    return {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:31",
        "replaces_fn": "_flash_kernel",
        "launches": None,
        "launches_on_path": None,
        "max_abs_err": errs[PREFILL],
        "tol": TOL[PREFILL[-1]],
        "ms": llama["ms"],
        "kernel_ms": llama["ms"],
        "plain_ms": llama["plain_ms"],
        "bound_ms": llama["bound_ms"],
        "bound_by": llama["bound_by"],
        "library_ms": llama["library_ms"],
        "shape": llama["shape"],
        "zamba2_prefill_shape": {**zamba,
                                 "max_abs_err": errs[ZAMBA_PREFILL],
                                 "plain": "one request at a time"},
        "note": "writes the row log-sum-exp, fp32 (B, H, S), when asked "
                "(training); serving passes a null pointer, as timed here",
    }


# The training shape of llama3.2-3b (global batch 2 x 2048 tokens), where
# the backward runs on the main path.
TRAIN_ATTN = (2, 2048, 2048, 24, 8, 128, None, None, torch.bfloat16)


def attention_backward_work(b, s, t, h, k, d, window, dtype):
    """(operations, bytes) the causal backward needs on these shapes: five
    products of 2·D operations per visible (query, key) pair (S and dP
    recomputed, dV, dQ, dK); q, k, v, o, dO and the fp32 LSE read once,
    dq, dk, dv written once."""
    flops, _ = attention_work(b, s, t, h, k, d, window, dtype)
    esize = torch.finfo(dtype).bits // 8
    nbytes = (esize * (4 * b * s * h * d + 4 * b * t * k * d)
              + 4 * b * h * s)
    return flops * 10 / 4, nbytes


def _sdpa_backend(fn) -> str:
    """Names of the CUDA kernels one call of ``fn`` runs (profiler)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    return "; ".join(sorted(n[:80] for n in names))


def backward_phase(device: torch.device) -> dict:
    """The flash backward on every row of SWEEP and at the training shape:
    the forward's output (at TOL[dtype], as in kernel_phase) and LSE (at
    TOL[fp32]) against the plain version's; dq/dk/dv of the kernels
    against ref.attention_backward_reference on the kernels' own inputs
    and against autograd through ref.attention_reference, both evaluated
    in fp32. fp32 rows elementwise at TOL[fp32]; bf16 rows at
    TOL[bf16] on each gradient divided by the reference gradient's
    max-abs. A second backward run must be bit-identical. Times (kernel vs
    the backward of scaled_dot_product_attention, in turns) at the
    training shape and at the serving prefill shape."""
    from repro_torch.kernels.flash_attention import kernel, ref

    def inputs(i, b, s, t, h, k, d, dtype):
        gen = torch.Generator(device=device).manual_seed(3000 + i)
        mk = lambda *shape: torch.randn(  # noqa: E731
            shape, generator=gen, device=device).to(dtype)
        return mk(b, s, h, d), mk(b, t, k, d), mk(b, t, k, d), mk(b, s, h, d)

    def rel_err(got, want, dtype):
        got, want = got.float(), want.float()
        if dtype == torch.bfloat16:
            m = want.abs().max().clamp_min(1e-30)
            got, want = got / m, want / m
        torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype])
        return (got - want).abs().max().item()

    train_err = train_o_err = None
    for i, row in enumerate(SWEEP + [TRAIN_ATTN]):
        b, s, t, h, k, d, window, softcap, dtype = row
        cfg = dict(causal=True, window=window, softcap=softcap)
        q, kk, vv, do = inputs(i, b, s, t, h, k, d, dtype)
        o, lse = kernel.flash_attention(q, kk, vv, return_lse=True, **cfg)
        o_want, lse_want = ref.attention_reference_lse(q, kk, vv, **cfg)
        got = kernel.flash_attention_backward(q, kk, vv, o, lse, do, **cfg)
        again = kernel.flash_attention_backward(q, kk, vv, o, lse, do, **cfg)
        up = [x.float() for x in (q, kk, vv, o, do)]
        plain = ref.attention_backward_reference(*up[:4], lse, up[4], **cfg)
        leaves = [x.requires_grad_() for x in up[:3]]
        ref.attention_reference(*leaves, **cfg).backward(up[4])
        torch.cuda.synchronize()
        o_err = (o.float() - o_want.float()).abs().max().item()
        lse_err = (lse - lse_want).abs().max().item()
        torch.testing.assert_close(o.float(), o_want.float(), rtol=TOL[dtype],
                                   atol=TOL[dtype])
        torch.testing.assert_close(lse, lse_want, rtol=TOL[torch.float32],
                                   atol=TOL[torch.float32])
        errs = [rel_err(g, w, dtype) for g, w in zip(got, plain)]
        errs_ag = [rel_err(g, x.grad, dtype) for g, x in zip(got, leaves)]
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        assert same, "two backward runs differ"
        kind = "max_abs_err / max|ref|" if dtype == torch.bfloat16 else \
            "max_abs_err"
        print(f"[backward] B{b} S{s} T{t} H{h} K{k} D{d} window={window} "
              f"softcap={softcap} {str(dtype)[6:]}: dq/dk/dv {kind} vs plain "
              f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}, vs autograd "
              f"{errs_ag[0]:.3e}/{errs_ag[1]:.3e}/{errs_ag[2]:.3e} "
              f"(tol {TOL[dtype]}); forward o max_abs_err {o_err:.3e} (tol "
              f"{TOL[dtype]}), lse {lse_err:.3e} (tol {TOL[torch.float32]}); "
              f"rerun bit-identical")
        if row is TRAIN_ATTN:
            train_err, train_o_err = max(errs + errs_ag), o_err
        del q, kk, vv, do, o, o_want, lse, got, again, plain, up, leaves

    timings = {}
    for label, row in (("train", TRAIN_ATTN), ("prefill", PREFILL)):
        b, s, t, h, k, d, window, softcap, dtype = row
        q, kk, vv, do = inputs(99, b, s, t, h, k, d, dtype)
        o, lse = kernel.flash_attention(q, kk, vv, return_lse=True)
        plain_ms = statistics.median(time_samples(
            lambda: ref.attention_backward_reference(q, kk, vv, o, lse, do),
            reps=5, warmup=1, inner=1))
        # the library yardstick: SDPA's backward on its own graph, (B, H,
        # S, D) layout made once outside the timing
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, kk, vv))
        dot = do.transpose(1, 2).contiguous()
        gqa_note = "enable_gqa"
        out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
        sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
            out, (qt, kt, vt), dot, retain_graph=True)
        backend = _sdpa_backend(sdpa_bwd)
        if not re.search("flash|cudnn|fmha", backend, re.I):
            # enable_gqa left the fused kernels: K/V expanded to H heads
            kt, vt = (x.detach().repeat_interleave(h // k, dim=1)
                      .requires_grad_() for x in (kt, vt))
            out = torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)
            backend = _sdpa_backend(sdpa_bwd)
            gqa_note = "K/V expanded to H heads (enable_gqa ran no fused kernel)"
        library_ms, kernel_ms = time_turns(
            sdpa_bwd,
            lambda: kernel.flash_attention_backward(q, kk, vv, o, lse, do))
        flops, nbytes = attention_backward_work(b, s, t, h, k, d, window,
                                                dtype)
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        print(f"[backward] {label} shape B{b} S{s} H{h} K{k} D{d}: kernel "
              f"{kernel_ms:.4f} ms (3 launches), plain {plain_ms:.4f} ms, sdpa"
              f" backward {library_ms:.4f} ms ({gqa_note}; in turns: sdpa, "
              f"kernel, kernel, sdpa), kernel/sdpa "
              f"{kernel_ms / library_ms:.3f}, bound {bound:.4f} ms "
              f"({flops / 1e9:.2f} GFLOP is {t_ops:.4f} ms, {nbytes / 1e6:.1f}"
              f" MB is {t_bytes:.4f} ms), kernel/bound {kernel_ms / bound:.2f}")
        print(f"[backward] sdpa backward kernels: {backend}")
        timings[label] = dict(ms=kernel_ms, plain_ms=plain_ms,
                              library_ms=library_ms, bound_ms=bound,
                              bound_by="operations" if t_ops >= t_bytes
                              else "bytes", library_note=gqa_note)
        del q, kk, vv, do, o, lse, qt, kt, vt, dot, out

    tr = timings["train"]
    return {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_bwd.cu",
        "replaces": "none in JAX: the backward of "
                    "src/repro/kernels/flash_attention/kernel.py:31 "
                    "(_flash_kernel), which JAX differentiates through XLA",
        "replaces_fn": None,
        "launches": None,
        "launches_on_path": None,
        "max_abs_err": train_err,
        "tol": TOL[torch.bfloat16],
        "forward_o_max_abs_err": train_o_err,
        "ms": tr["ms"],
        "kernel_ms": tr["ms"],
        "plain_ms": tr["plain_ms"],
        "bound_ms": tr["bound_ms"],
        "bound_by": tr["bound_by"],
        "library_ms": tr["library_ms"],
        "library": "scaled_dot_product_attention backward, "
                   + tr["library_note"],
        "shape": "B2 S2048 T2048 H24 K8 D128 bf16 causal (three launches: "
                 "Delta, dK/dV and dQ, both on wgmma fed by TMA)",
        "prefill_shape_ms": timings["prefill"],
    }


def ssd_work(b, l, h, p, g, n, chunk, dtype, with_state):
    """(operations, bytes) the scan needs on these shapes. Per chunk of q
    tokens: q(q+1)/2 (query, key) pairs at 2(N+P) operations (C·B and the
    gate times X) and 4·q·N·P for the carried-state term and the state
    update. Bytes: x, B, C, fp32 dt and the initial state read once, y and
    the final fp32 state written once."""
    flops = 0.0
    for c0 in range(0, l, chunk):
        q = min(chunk, l - c0)
        flops += q * (q + 1) / 2 * 2 * (n + p) + 4.0 * q * n * p
    flops *= b * h
    esize = torch.finfo(dtype).bits // 8
    state = 4 * b * h * p * n
    nbytes = (esize * (2 * b * l * h * p + 2 * b * l * g * n)
              + 4 * b * l * h + state * (2 if with_state else 1))
    return flops, nbytes


def ssd_kernel_phase(device: torch.device) -> dict:
    from repro_torch.kernels.ssd import kernel, ref

    def inputs(i, b, l, h, p, g, n, dtype, with_state):
        gen = torch.Generator(device=device).manual_seed(2000 + i)
        rnd = lambda *shape: torch.randn(  # noqa: E731
            shape, generator=gen, device=device)
        x = rnd(b, l, h, p).to(dtype)
        dt = torch.nn.functional.softplus(rnd(b, l, h))
        a = -torch.exp(rnd(h) * 0.3)
        bm, cm = rnd(b, l, g, n).to(dtype), rnd(b, l, g, n).to(dtype)
        d = torch.full((h,), 0.5, device=device)
        s0 = rnd(b, h, p, n) if with_state else None
        return x, dt, a, bm, cm, d, s0

    def up(t):
        return None if t is None else t.double()

    errs = {}
    for i, row in enumerate(SSD_SWEEP + [SSD_PREFILL, ZAMBA_SSD_PREFILL,
                                         SSD_P128]):
        b, l, h, p, g, n, chunk, dtype, with_state = row
        x, dt, a, bm, cm, d, s0 = inputs(i, *row[:6], dtype, with_state)
        y, s_out = kernel.ssd_scan(x, dt, a, bm, cm, chunk=chunk, d_skip=d,
                                   initial_state=s0, return_final_state=True)
        # the plain version on the same inputs, evaluated in float64 (the
        # exact side), and as the CPU path runs it (fp32 arithmetic)
        y64, s64 = ref.ssd_reference(
            up(x), up(dt), up(a), up(bm), up(cm), chunk=chunk, d_skip=up(d),
            initial_state=up(s0), return_final_state=True)
        y32, s32 = ref.ssd_reference(
            x, dt, a, bm, cm, chunk=chunk, d_skip=d, initial_state=s0,
            return_final_state=True)
        torch.cuda.synchronize()
        want = y64.to(dtype).float()
        err = (y.float() - want).abs().max().item()
        s_err = (s_out.double() - s64).abs().max().item()
        plain_err = (y32.float() - want).abs().max().item()
        plain_s_err = (s32.double() - s64).abs().max().item()
        print(f"[ssd] B{b} L{l} H{h} P{p} G{g} N{n} chunk={chunk} "
              f"{str(dtype)[6:]} state_in={with_state}: y max_abs_err="
              f"{err:.3e} rtol=atol={TOL[dtype]}; final state max_abs_err="
              f"{s_err:.3e} rtol=atol={TOL[torch.float32]} (plain fp32: y "
              f"{plain_err:.3e}, state {plain_s_err:.3e})")
        torch.testing.assert_close(y.float(), want, rtol=TOL[dtype],
                                   atol=TOL[dtype])
        torch.testing.assert_close(s_out, s64.float(),
                                   rtol=TOL[torch.float32],
                                   atol=TOL[torch.float32])
        errs[row] = max(err, s_err)
        del x, bm, cm, y, y64, y32, s_out, s64, s32, want

    def timing(row):
        b, l, h, p, g, n, chunk, dtype, with_state = row
        x, dt, a, bm, cm, d, _ = inputs(99, b, l, h, p, g, n, dtype, False)
        # plain and kernel in turns: plain, kernel, kernel, plain
        plain_ms, kernel_ms = time_turns(
            lambda: ref.ssd_reference(x, dt, a, bm, cm, chunk=chunk,
                                      d_skip=d, return_final_state=True),
            lambda: kernel.ssd_scan(x, dt, a, bm, cm, chunk=chunk, d_skip=d,
                                    return_final_state=True), reps=10)
        flops, nbytes = ssd_work(b, l, h, p, g, n, chunk, dtype, with_state)
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        nc = -(-l // chunk)
        shape = (f"B{b} L{l} H{h} P{p} G{g} N{n} chunk{chunk} "
                 f"{str(dtype)[6:]}, final state out")
        print(f"[ssd] {shape}: kernel {kernel_ms:.4f} ms (3 launches), "
              f"plain {plain_ms:.4f} ms (in turns: plain, kernel, kernel, "
              f"plain), no library call, bound {max(t_ops, t_bytes):.4f} ms "
              f"({flops / 1e9:.2f} GFLOP is {t_ops:.4f} ms at the bf16 rate, "
              f"{nbytes / 1e6:.1f} MB is {t_bytes:.4f} ms), "
              f"{b * nc * h} blocks in the chunk passes")
        return dict(shape=shape, ms=kernel_ms, plain_ms=plain_ms,
                    library_ms=None, bound_ms=max(t_ops, t_bytes),
                    bound_by="operations" if t_ops >= t_bytes else "bytes",
                    max_abs_err=errs[row])

    mamba, zamba = timing(SSD_PREFILL), timing(ZAMBA_SSD_PREFILL)
    return {
        "name": "ssd_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd_fwd.cu",
        "replaces": "src/repro/kernels/ssd/kernel.py:30",
        "replaces_fn": "_ssd_kernel",
        "launches": None,
        "launches_on_path": None,
        "max_abs_err": mamba["max_abs_err"],
        "tol": TOL[SSD_PREFILL[7]],
        "ms": mamba["ms"],
        "kernel_ms": mamba["ms"],
        "plain_ms": mamba["plain_ms"],
        "bound_ms": mamba["bound_ms"],
        "bound_by": mamba["bound_by"],
        "library_ms": None,
        "shape": mamba["shape"],
        "zamba2_prefill_shape": zamba,
    }


# The training shape of mamba2-130m (global batch 8 x 4096 tokens), where
# the SSD backward runs on the main path; no state in or out.
SSD_TRAIN = (8, 4096, 24, 64, 1, 128, 256, torch.bfloat16, False)


def ssd_backward_work(b, l, h, p, g, n, chunk, dtype, with_state):
    """(operations, bytes) the backward needs on these shapes, counted as
    ssd_work counts the forward. Per chunk of q tokens: q(q+1)/2 (query,
    key) pairs at 2(3N + 2P) operations (C·B and dy·x recomputed, the gate
    times dy, M times B and times C) and 10·q·N·P for the five state
    products (the recomputed local state, its gradient's local term, the
    carried state's term of dC, G·B and Gᵀx). Bytes: x, dy, B, C and fp32
    dt read once, dx, dB, dC and ddt written once; with a state, the
    initial state and the final state's gradient read and the initial
    state's gradient written."""
    flops = 0.0
    for c0 in range(0, l, chunk):
        q = min(chunk, l - c0)
        flops += q * (q + 1) / 2 * 2 * (3 * n + 2 * p) + 10.0 * q * n * p
    flops *= b * h
    esize = torch.finfo(dtype).bits // 8
    nbytes = (esize * (3 * b * l * h * p + 4 * b * l * g * n) + 8 * b * l * h
              + (3 * 4 * b * h * p * n if with_state else 0))
    return flops, nbytes


def ssd_backward_phase(device: torch.device) -> dict:
    """The SSD backward on every row of SSD_SWEEP and at the training shape
    (see the module docstring), then its timing at the training shape."""
    from repro_torch.kernels.ssd import kernel, ref

    names = ("dx", "ddt", "da", "dB", "dC", "dD", "ds0")

    def inputs(i, b, l, h, p, g, n, dtype, with_state):
        gen = torch.Generator(device=device).manual_seed(4000 + i)
        rnd = lambda *shape: torch.randn(  # noqa: E731
            shape, generator=gen, device=device)
        x = rnd(b, l, h, p).to(dtype)
        dt = torch.nn.functional.softplus(rnd(b, l, h))
        a = -torch.exp(rnd(h) * 0.3)
        bm, cm = rnd(b, l, g, n).to(dtype), rnd(b, l, g, n).to(dtype)
        d = torch.full((h,), 0.5, device=device)
        dy = rnd(b, l, h, p).to(dtype)
        s0 = rnd(b, h, p, n) if with_state else None
        dfin = rnd(b, h, p, n) if with_state else None
        return x, dt, a, bm, cm, d, s0, dy, dfin

    def grads64(chunk, x, dt, a, bm, cm, d, s0, dy, dfin):
        """Autograd through the plain version in float64, one request at a
        time (a and D's gradients summed over the requests)."""
        out = []
        for i in range(x.shape[0]):
            one = lambda t: None if t is None else t[i:i + 1]  # noqa: E731
            leaves = [t.double().requires_grad_() for t in
                      (one(x), one(dt), a, one(bm), one(cm), d)]
            s0_i = (one(s0).double().requires_grad_() if s0 is not None
                    else None)
            y, s_out = ref.ssd_reference(*leaves[:5], chunk=chunk,
                                         d_skip=leaves[5],
                                         initial_state=s0_i,
                                         return_final_state=True)
            outs, gouts = [y], [one(dy).double()]
            if dfin is not None:
                outs.append(s_out)
                gouts.append(one(dfin).double())
            out.append(torch.autograd.grad(
                outs, leaves + ([s0_i] if s0_i is not None else []), gouts))
            del leaves, y, s_out
        cat = [torch.cat(parts) for parts in zip(*out)]
        cat[2] = sum(o[2] for o in out)
        cat[5] = sum(o[5] for o in out)
        return cat

    def err(got, want, dtype):
        got, want = got.double(), want.double()
        if dtype == torch.bfloat16:
            m = want.abs().max().clamp_min(1e-30)
            got, want = got / m, want / m
        torch.testing.assert_close(got, want, rtol=TOL[dtype],
                                   atol=TOL[dtype])
        return (got - want).abs().max().item()

    train_err = None
    for i, row in enumerate(SSD_SWEEP + [SSD_TRAIN, SSD_P128]):
        b, l, h, p, g, n, chunk, dtype, with_state = row
        x, dt, a, bm, cm, d, s0, dy, dfin = inputs(i, *row[:6], dtype,
                                                   with_state)
        got = kernel.ssd_scan_backward(x, dt, a, bm, cm, dy, chunk, d, s0,
                                       dfin)
        again = kernel.ssd_scan_backward(x, dt, a, bm, cm, dy, chunk, d, s0,
                                         dfin)
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(got, again)
                   if u is not None), "two backward runs differ"
        want = grads64(chunk, x, dt, a, bm, cm, d, s0, dy, dfin)
        errs = {}
        for name, gg, ww in zip(names, got, want):
            try:
                errs[name] = err(gg, ww, dtype)
            except AssertionError as e:
                raise AssertionError(f"SSD backward {row} {name}: {e}")
        kind = ("max_abs_err / max|ref|" if dtype == torch.bfloat16
                else "max_abs_err")
        print(f"[ssd-backward] B{b} L{l} H{h} P{p} G{g} N{n} chunk={chunk} "
              f"{str(dtype)[6:]} state={with_state}: {kind} vs float64 "
              "autograd " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (tol {TOL[dtype]}); rerun bit-identical")
        if row is SSD_TRAIN:
            train_err = max(errs.values())
        del x, dt, a, bm, cm, d, s0, dy, dfin, got, again, want

    b, l, h, p, g, n, chunk, dtype, with_state = SSD_TRAIN
    x, dt, a, bm, cm, d, _, dy, _ = inputs(99, *SSD_TRAIN[:6], dtype, False)
    leaves = [t.clone().requires_grad_() for t in (x, dt, a, bm, cm, d)]
    y = ref.ssd_reference(*leaves[:5], chunk=chunk, d_skip=leaves[5])
    plain = lambda: torch.autograd.grad(  # noqa: E731
        y, leaves, dy, retain_graph=True)
    # the first design, kept as the fp32 path (products on the CUDA cores),
    # on the same values widened to fp32
    xf, bf, cf, dyf = (t.float() for t in (x, bm, cm, dy))
    plain_ms, cuda_core_ms, kernel_ms = time_turns(
        plain,
        lambda: kernel.ssd_scan_backward(xf, dt, a, bf, cf, dyf, chunk, d),
        lambda: kernel.ssd_scan_backward(x, dt, a, bm, cm, dy, chunk, d),
        reps=3, inner=2)
    del leaves, y, xf, bf, cf, dyf
    flops, nbytes = ssd_backward_work(*SSD_TRAIN)
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    bound = max(t_ops, t_bytes)
    shape = (f"B{b} L{l} H{h} P{p} G{g} N{n} chunk{chunk} {str(dtype)[6:]}, "
             "no state")
    print(f"[ssd-backward] {shape}: kernel {kernel_ms:.4f} ms (10 "
          f"launches, bf16 products on the tensor cores), CUDA-core design "
          f"{cuda_core_ms:.4f} ms (the fp32 path's kernels on the same values "
          f"widened to fp32), plain backward {plain_ms:.4f} ms (autograd "
          f"through the plain version in fp32); in turns: plain, CUDA-core, "
          f"kernel, kernel, CUDA-core, plain; no library call, bound "
          f"{bound:.4f} ms ({flops / 1e9:.2f} GFLOP is {t_ops:.4f} ms at the "
          f"bf16 rate, {nbytes / 1e6:.1f} MB is {t_bytes:.4f} ms), "
          f"kernel/bound {kernel_ms / bound:.2f}, CUDA-core/bound "
          f"{cuda_core_ms / bound:.2f}")
    # the kernels of a call, by name, from the profiler: three calls, a
    # sleep kernel at each edge (a collection may lose its first or last
    # rows)
    def padded():
        torch.cuda._sleep(200_000)
        kernel.ssd_scan_backward(x, dt, a, bm, cm, dy, chunk, d)
        torch.cuda._sleep(200_000)

    reps = 3
    prof, _, _, _ = traced(padded, reps)
    dev_time = lambda e: getattr(  # noqa: E731
        e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
    passes = sorted((e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and _trace_label(e.key).startswith("ssd_")),
                    key=dev_time, reverse=True)
    print(f"[ssd-backward] {reps} traced calls: "
          f"{sum(dev_time(e) for e in passes) * 1e-3 / reps:.4f} ms of "
          "kernels a call")
    for e in passes:
        print(f"[ssd-backward]   {dev_time(e) * 1e-3 / reps:9.4f} ms "
              f"x{e.count // reps} {_trace_label(e.key)}")
    return {
        "name": "ssd_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd_bwd.cu",
        "replaces": "none in JAX: the backward of "
                    "src/repro/kernels/ssd/kernel.py:30 (_ssd_kernel), which "
                    "JAX differentiates through XLA (ssd_reference)",
        "replaces_fn": None,
        "launches": None,
        "launches_on_path": None,
        "max_abs_err": train_err,
        "tol": TOL[dtype],
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "cuda_core_ms": cuda_core_ms,
        "bound_ms": bound,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
        "library": "none: no single PyTorch call computes the scan's "
                   "backward",
        "passes_ms": {_trace_label(e.key): dev_time(e) * 1e-3 / reps
                      for e in passes},
        "shape": shape + " (ten launches, bf16 mma.sync on the tensor cores, "
                         "fp32 operands split hi + lo)",
    }


def path_check(device: torch.device) -> None:
    """The model path on the card against the same path on the CPU (plain
    attention), on a small input: two layers of llama3.2-3b's block
    shape cut narrow (head_dim 128 and GQA 3:1 kept, so the kernel
    runs), the same bf16 weights on both, prefill then 4 decode steps.
    rtol = atol = 0.15 on the fp32 logits, the bf16 tolerance of
    tests/test_torch_lm.py."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = dataclasses.replace(
        get_config("llama3.2-3b"), num_layers=2, d_model=384, num_heads=3,
        num_kv_heads=1, d_ff=1024, vocab_size=4096, decode_hot_len=16)
    gen = torch.Generator().manual_seed(5)
    cpu_params = lm.init_params(cfg, gen, device="cpu", dtype=torch.bfloat16)
    gpu_params = lm.tree_map(lambda x: x.to(device), cpu_params)
    toks = torch.randint(0, cfg.vocab_size, (2, 72), generator=gen,
                         dtype=torch.int32)
    outs = []
    for params, dev in ((cpu_params, torch.device("cpu")),
                        (gpu_params, device)):
        with torch.inference_mode():
            logits, caches, pos = lm.prefill(cfg, params, toks[:, :68].to(dev))
            caches = lm.grow_caches(cfg, caches, 72)
            seq = [logits]
            for t in range(68, 72):
                logits, caches, pos = lm.decode_step(
                    cfg, params, toks[:, t:t + 1].to(dev), pos, caches)
                seq.append(logits)
        outs.append(torch.stack(seq).float().cpu())
    assert torch.isfinite(outs[1]).all(), "non-finite logits on the card"
    err = (outs[0] - outs[1]).abs().max().item()
    print(f"[path] 2-layer llama block, prefill 68 + 4 decode steps: card "
          f"vs CPU max_abs_err={err:.3e} (rtol=atol=0.15)")
    torch.testing.assert_close(outs[1], outs[0], rtol=0.15, atol=0.15)

def mamba_path_check(device: torch.device) -> None:
    """The mamba2 model path on the card against the same path on the CPU
    (plain SSD), on a small input: two layers of mamba2-130m's block cut
    narrow (d_model 256, so 8 SSD heads; P 64, N 128 and chunk 256 kept,
    so the kernel runs at its real tile sizes), the same bf16 weights on
    both, a 300-token prompt (a ragged second chunk), then 4 decode steps.
    rtol = atol = 0.15 on the fp32 logits, as the llama path check."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd import kernel
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_config("mamba2-130m"), num_layers=2,
                              d_model=256, vocab_size=4096)
    gen = torch.Generator().manual_seed(6)
    cpu_params = lm.init_params(cfg, gen, device="cpu", dtype=torch.bfloat16)
    gpu_params = lm.tree_map(lambda x: x.to(device), cpu_params)
    toks = torch.randint(0, cfg.vocab_size, (2, 304), generator=gen,
                         dtype=torch.int32)
    outs = []
    for params, dev in ((cpu_params, torch.device("cpu")),
                        (gpu_params, device)):
        before = kernel.ssd_scan.launches
        with torch.inference_mode():
            logits, caches, pos = lm.prefill(cfg, params,
                                             toks[:, :300].to(dev))
            caches = lm.grow_caches(cfg, caches, 304)
            seq = [logits]
            for t in range(300, 304):
                logits, caches, pos = lm.decode_step(
                    cfg, params, toks[:, t:t + 1].to(dev), pos, caches)
                seq.append(logits)
        want = cfg.num_layers if dev.type == "cuda" else 0
        assert kernel.ssd_scan.launches - before == want
        outs.append(torch.stack(seq).float().cpu())
    assert torch.isfinite(outs[1]).all(), "non-finite logits on the card"
    err = (outs[0] - outs[1]).abs().max().item()
    print(f"[path] 2-layer mamba2 block (P 64, N 128, chunk 256), prefill "
          f"300 + 4 decode steps: card vs CPU max_abs_err={err:.3e} "
          f"(rtol=atol=0.15)")
    torch.testing.assert_close(outs[1], outs[0], rtol=0.15, atol=0.15)


def zamba_path_check(device: torch.device) -> None:
    """The zamba2 model path on the card against the same path on the CPU
    (plain versions), on a small input: smoke_config("zamba2-2.7b") (two
    repeats of five SSM blocks and the shared attention block) with head
    dim 80, so that the flash forward runs its D-80 branch (the smoke 16 is
    no head dim the kernel takes), and P 64, N 64, chunk 256, so that the
    SSD kernel runs zamba2's head shape; the same bf16 weights on both, a
    300-token prompt (a ragged second chunk), then 4 decode steps. rtol =
    atol = 0.15 on the fp32 logits, as the llama and mamba path checks.
    The shared block's two repeats must write two different KV rows."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import lm

    cfg = dataclasses.replace(smoke_config("zamba2-2.7b"), head_dim=80,
                              ssm_head_dim=64, ssm_state=64, ssm_chunk=256)
    counters = launch_counters()
    gen = torch.Generator().manual_seed(8)
    cpu_params = lm.init_params(cfg, gen, device="cpu", dtype=torch.bfloat16)
    gpu_params = lm.tree_map(lambda x: x.to(device), cpu_params)
    toks = torch.randint(0, cfg.vocab_size, (2, 304), generator=gen,
                         dtype=torch.int32)
    outs, kv = [], []
    for params, dev in ((cpu_params, torch.device("cpu")),
                        (gpu_params, device)):
        before = {n: w.launches for n, w in counters.items()}
        with torch.inference_mode():
            logits, caches, pos = lm.prefill(cfg, params,
                                             toks[:, :300].to(dev))
            caches = lm.grow_caches(cfg, caches, 304)
            seq = [logits]
            for t in range(300, 304):
                logits, caches, pos = lm.decode_step(
                    cfg, params, toks[:, t:t + 1].to(dev), pos, caches)
                seq.append(logits)
        launches = {n: w.launches - before[n] for n, w in counters.items()}
        want = ({"flash_attention_fwd": cfg.repeats, "ssd_fwd": 5 * cfg.repeats,
                 "flash_attention_bwd": 0, "ssd_bwd": 0} if dev.type == "cuda"
                else dict.fromkeys(counters, 0))
        assert launches == want, (dev, launches, want)
        outs.append(torch.stack(seq).float().cpu())
        kv.append(caches["slot5"]["k"].float().cpu())
    assert torch.isfinite(outs[1]).all(), "non-finite logits on the card"
    assert not torch.equal(kv[1][0], kv[1][1]), "one KV row for two repeats"
    err = (outs[0] - outs[1]).abs().max().item()
    print(f"[path] zamba2 smoke (D 80, P 64, N 64, chunk 256, shared block "
          f"at layers 6 and 12), prefill 300 + 4 decode steps: card vs CPU "
          f"max_abs_err={err:.3e} (rtol=atol=0.15); the two repeats' KV rows "
          f"differ; shared-block KV rows card vs CPU, relative norm "
          f"{rel_norm(kv[1], kv[0]):.3e}")
    torch.testing.assert_close(outs[1], outs[0], rtol=0.15, atol=0.15)


def talp_backend_check(device: torch.device) -> None:
    """TALP's device records on the card (CUPTI activity read by
    repro_torch.core.backends.cuda_runtime.CuptiActivity). The clock: a
    sleep kernel queued behind another (so that no launch separates it
    from the event before it) starts and ends within CLOCK_BOUND of the
    CUDA events around it, in five tries over 0.3 s; and a sleep kernel
    launched on the idle card lies inside the host's window around its
    launch and wait, within CLOCK_BOUND, in five more. The gaps: a sleep
    kernel, a host sleep of 50 ms and a sleep kernel in one launch/wait
    window leave at least 40 ms of device Idle (a record spanning the
    launch counted them as Kernel)."""
    from repro_torch.core import TalpMonitor
    from repro_torch.core.backends import CudaRuntimeBackend

    be = CudaRuntimeBackend(device)
    t0 = time.perf_counter()
    be.start()
    opened = time.perf_counter() - t0

    def bracketed():
        torch.cuda._sleep(2_000_000)      # holds the queue while we enqueue
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        torch.cuda._sleep(1_000_000)
        e1.record()
        return e0, e1

    events, windows = [], []
    for _ in range(5):
        events.append(be.wait(be.launch(bracketed)))
        time.sleep(0.06)
    for _ in range(5):
        h0 = be.clock()
        be.wait(be.launch(torch.cuda._sleep, 1_000_000))
        windows.append((h0, be.clock()))
        time.sleep(0.02)
    [(_, kinds, starts, ends, _)] = be.flush_arrays()
    be.stop()
    assert len(kinds) == 15, kinds
    order = sorted(range(len(starts)), key=lambda i: starts[i])
    errs = [max(abs(starts[i] - be._event_time(e0)),
                abs(ends[i] - be._event_time(e1)))
            for (e0, e1), i in zip(events, order[1:10:2])]
    margins = [(starts[i] - h0, h1 - ends[i])
               for (h0, h1), i in zip(windows, order[10:])]
    print(f"[talp-backend] first collection opened in {opened:.3f} s; sleep "
          f"kernel vs the CUDA events around it: max |start or end "
          f"difference| {max(errs) * 1e6:.1f} us over 5 tries (bound "
          f"{CLOCK_BOUND * 1e6:.0f} us): "
          + ", ".join(f"{e * 1e6:.1f}" for e in errs)
          + "; on the idle card, start after the launch call and end before "
          "the wait's return (us): "
          + ", ".join(f"{a * 1e6:.1f}/{b * 1e6:.1f}" for a, b in margins))
    assert max(errs) <= CLOCK_BOUND, errs
    assert min(min(m) for m in margins) >= -CLOCK_BOUND, margins

    be = CudaRuntimeBackend(device)
    mon = TalpMonitor("gap", backend=be)

    def step():
        torch.cuda._sleep(1_000_000)
        time.sleep(0.05)
        torch.cuda._sleep(1_000_000)

    with mon.region("step"):
        h = be.launch(step, name="sleeps")
        with mon.offload():
            be.wait(h)
    r = mon.finalize()["step"]
    ds = r.device_states[0]
    print(f"[talp-backend] sleep kernel, host sleep 50 ms, sleep kernel in "
          f"one launch: region {r.elapsed * 1e3:.3f} ms, device kernel "
          f"{ds['kernel'] * 1e3:.3f} ms, idle {ds['idle'] * 1e3:.3f} ms, "
          f"device PE {r.device.parallel_efficiency:.4f}")
    assert ds["idle"] >= 0.04 and 0 < ds["kernel"] < 0.01, ds


def train_path_check(device: torch.device) -> None:
    """One ``make_train_step`` step of smoke_config("llama3.2-3b") with
    head_dim 32 (the smoke config's 16 is no head dim the kernels take),
    and one of smoke_config("mamba2-130m") (P 16, N 16, chunk 32: the SSD
    forward twice per layer with remat and its backward once), on
    the card (the kernels) and on the CPU (the plain versions) from the
    same fp32 state and batch, in fp32 and in bf16 compute. Loss and grad
    norm within rtol = atol = TOL[compute dtype]. The gradient, leaf by
    leaf, read from the first moment after the step ((1 - b1)·clip·g):
    fp32 elementwise at TOL[fp32] and at a relative norm of TOL[fp32]; bf16
    no further from the fp32 gradient, in relative norm, than twice the
    plain version's bf16 gradient is, plus TOL[bf16] (the plain version's
    own bf16 gradient of this step lies 1e-2 to 2e-2 from the fp32 one, as
    printed, so two bf16 implementations may differ by more than TOL[bf16]
    without a fault; a missing gradient is off by 1). The parameters after the step within rtol TOL[fp32] and atol
    2·lr + TOL[fp32]: Adam's first step moves each element by about
    lr·sign(g), so an element whose gradient lies within rounding of 0 can
    land 2·lr apart."""
    from repro_torch.configs import smoke_config
    from repro_torch.optim.adamw import AdamWConfig

    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    for base, per_layer in (
            (dataclasses.replace(smoke_config("llama3.2-3b"), head_dim=32),
             {"flash_attention_fwd": 2, "flash_attention_bwd": 1}),
            (smoke_config("mamba2-130m"), {"ssd_fwd": 2, "ssd_bwd": 1})):
        train_step_check(device, base, per_layer, opt)


def train_step_check(device, base, per_layer: dict, opt) -> None:
    """train_path_check's step for one smoke config ``base``, whose card
    run launches each kernel ``per_layer`` times per layer."""
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models import lm

    counters = launch_counters()
    ftol = TOL[torch.float32]
    grads32 = None      # the CPU's fp32 gradient, the bf16 round's yardstick
    for cdt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, compute_dtype=cdt)
        cpu_state = init_train_state(cfg, torch.Generator().manual_seed(7),
                                     device="cpu")
        gpu_state = lm.tree_map(
            lambda x: x.to(device, copy=True) if x.dim() else x.clone(),
            cpu_state)
        batch = SyntheticTokenPipeline(DataConfig(4, 64, cfg.vocab_size,
                                                  seed=1)).batch_at(0)
        out = []
        for state, dev in ((cpu_state, torch.device("cpu")),
                           (gpu_state, device)):
            before = {n: w.launches for n, w in counters.items()}
            new, metrics = make_train_step(cfg, opt)(
                state, {k: torch.from_numpy(v).to(dev)
                        for k, v in batch.items()})
            if dev.type == "cuda":
                torch.cuda.synchronize()
            launches = {n: w.launches - before[n] for n, w in counters.items()}
            want = {n: (per_layer.get(n, 0) * cfg.num_layers
                        if dev.type == "cuda" else 0) for n in counters}
            assert launches == want, (dev, launches, want)
            gn = float(metrics["grad_norm"])
            out.append((lm.tree_map(lambda x: x.cpu(), new["params"]),
                        first_step_grads(new["opt"]["mu"], gn, opt),
                        float(metrics["loss"]), gn))
        (p_cpu, g_cpu, loss_cpu, gn_cpu), (p_gpu, g_gpu, loss_gpu, gn_gpu) = out
        tol = TOL[getattr(torch, cdt)]
        pairs = list(zip(_leaves(p_gpu), _leaves(p_cpu)))
        p_err = max((a - b).abs().max().item() for a, b in pairs)
        if cdt == "float32":
            grads32 = g_cpu
            g_errs = {n: (rel_norm(g_gpu[n], g_cpu[n]),
                          (g_gpu[n] - g_cpu[n]).abs().max().item())
                      for n in g_cpu}
            worst = max(g_errs, key=lambda n: g_errs[n][0])
            g_note = (f"gradient leaf by leaf: worst relative norm "
                      f"{g_errs[worst][0]:.3e} ({worst}), worst max_abs_err "
                      f"{max(e[1] for e in g_errs.values()):.3e} (tol {ftol})")
        else:
            g_errs = {n: (rel_norm(g_gpu[n], grads32[n]),
                          rel_norm(g_cpu[n], grads32[n])) for n in g_cpu}
            worst = max(g_errs, key=lambda n: g_errs[n][0]
                        / (2 * g_errs[n][1] + tol))
            card, cpu = zip(*g_errs.values())
            g_note = (f"gradient leaf by leaf, relative norm from the fp32 "
                      f"gradient: card {min(card):.3e}-{max(card):.3e}, cpu "
                      f"{min(cpu):.3e}-{max(cpu):.3e} over the leaves; at "
                      f"the tightest leaf ({worst}) card "
                      f"{g_errs[worst][0]:.3e}, bound 2·cpu + {tol} = "
                      f"{2 * g_errs[worst][1] + tol:.3e}")
        print(f"[train-path] smoke {cfg.name} {cdt}: loss card "
              f"{loss_gpu:.6f} cpu {loss_cpu:.6f}, grad norm card "
              f"{gn_gpu:.6f} cpu {gn_cpu:.6f} (rtol=atol={tol}); {g_note}; "
              f"params after the step max_abs_err={p_err:.3e} (atol 2·lr + "
              f"{ftol})")
        assert math.isfinite(loss_gpu) and math.isfinite(gn_gpu)
        torch.testing.assert_close(torch.tensor([loss_gpu, gn_gpu]),
                                   torch.tensor([loss_cpu, gn_cpu]),
                                   rtol=tol, atol=tol)
        for n in g_cpu:
            if cdt == "float32":
                torch.testing.assert_close(g_gpu[n], g_cpu[n], rtol=ftol,
                                           atol=ftol, msg=n)
                assert g_errs[n][0] <= ftol, (n, g_errs[n])
            else:
                assert g_errs[n][0] <= 2 * g_errs[n][1] + tol, (n, g_errs[n])
        for a, b in pairs:
            torch.testing.assert_close(a, b, rtol=ftol,
                                       atol=2 * opt.lr + ftol)


def first_step_grads(mu, grad_norm: float, opt) -> dict:
    """The gradient of the first AdamW step, leaf by leaf, on the CPU,
    keyed by the leaf's path: the first moment is then (1 - b1)·clip·g,
    with clip = min(1, grad_clip / grad_norm)."""
    clip = min(1.0, opt.grad_clip / max(grad_norm, 1e-9))
    return {name: m.cpu() / ((1 - opt.b1) * clip)
            for name, m in _named_leaves(mu)}


def rel_norm(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _leaves(tree):
    for _, leaf in _named_leaves(tree):
        yield leaf


def launch_counters() -> dict:
    """Each kernel's wrapper, by the name of its JSON record; a wrapper's
    ``launches`` grows by one where it launches its kernel (the flash
    backward: one per call of its three launches; the SSD forward: one per
    call of its three, the SSD backward of its ten)."""
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.ssd import kernel as ssd

    return {"flash_attention_fwd": flash.flash_attention,
            "flash_attention_bwd": flash.flash_attention_backward,
            "ssd_fwd": ssd.ssd_scan,
            "ssd_bwd": ssd.ssd_scan_backward}


# (arch, requests, prompt tokens, generated tokens, the launches of each
# kernel in one prefill; every other kernel launches none)
SERVE = [
    ("llama3.2-3b", 8, 1024, 64, {"flash_attention_fwd": 28}),
    ("mamba2-130m", 8, 4096, 64, {"ssd_fwd": 24}),
    ("zamba2-2.7b", 8, 4096, 64, {"flash_attention_fwd": 9, "ssd_fwd": 45}),
]


def serve_phase(device: torch.device, arch: str, requests: int,
                prompt_len: int, gen_len: int, expected: dict,
                records: dict) -> dict:
    """Full-width serving of ``arch`` through the port's entry point.
    Returns TALP's device PE of the prefill and decode regions, each with
    the region's wall per call (the prefill; one decode step)."""
    from repro_torch.configs import get_config
    from repro_torch.core.report import render_tables
    from repro_torch.launch.serve import serve

    cfg = get_config(arch)
    # decode writes only the hot ring of an attention cache; past it the
    # oldest generated context is overwritten, as in the JAX serve loop
    assert gen_len <= cfg.decode_hot_len
    counters = launch_counters()
    for wrapper in counters.values():
        wrapper.launches = 0
    t0 = time.perf_counter()
    tokens, result = serve(cfg, requests=requests, prompt_len=prompt_len,
                           gen_len=gen_len, seed=0, verbose=False,
                           device=device)
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in counters.items()}
    assert tokens.shape == (requests, gen_len), tokens.shape
    assert (tokens >= 0).all() and (tokens < cfg.vocab_size).all()
    want = {name: expected.get(name, 0) for name in counters}
    assert launches == want, (
        f"{arch}: kernel launches {launches} in one prefill, want {want}")
    glob, dec = result.regions["Global"], result.regions["decode"]
    glob.host.validate(tol=1e-6)
    dec.host.validate(tol=1e-6)
    glob.device.validate(tol=1e-6)
    dec.device.validate(tol=1e-6)
    assert dec.device_states[0]["kernel"] > 0
    assert result.regions["prefill"].device_states[0]["kernel"] > 0
    print(render_tables(result))
    prefill_ms = result.regions["prefill"].elapsed * 1e3
    tok_s = requests * gen_len / dec.elapsed
    print(f"[serve] {arch} full width, {cfg.num_layers} layers, {requests} "
          f"requests x {prompt_len} prompt + {gen_len} generated: prefill "
          f"{prefill_ms:.3f} ms, decode {tok_s:.1f} tok/s "
          f"({dec.elapsed * 1e3 / gen_len:.3f} ms/step), wall {wall:.2f} s, "
          f"launches {launches}")
    for name in ("Global", "prefill", "decode"):
        r = result.regions[name]
        hs, ds = r.host_states[0], r.device_states[0]
        print(f"[talp] {arch} {name}: Host PE "
              f"{r.host.parallel_efficiency:.4f} (useful {hs['useful']:.6f} "
              f"s, offload {hs['offload']:.6f} s) | Device PE "
              f"{r.device.parallel_efficiency:.4f} (kernel "
              f"{ds['kernel']:.6f} s, idle {ds['idle']:.6f} s)")
    add_path_launches(records, f"serve {arch} (one prefill)", launches)
    pre = result.regions["prefill"]
    return {"prefill": (pre.device.parallel_efficiency, pre.elapsed),
            "decode": (dec.device.parallel_efficiency, dec.elapsed / gen_len)}


def add_path_launches(records: dict, path: str, launches: dict) -> None:
    """Record each kernel's launches in one main-path run; a record's
    ``launches`` is the sum over the paths that launched it."""
    for name, n in launches.items():
        if n:
            rec = records[name]
            rec["launches_on_path"] = {**(rec["launches_on_path"] or {}),
                                       path: n}
            rec["launches"] = sum(rec["launches_on_path"].values())


# (arch, steps, global batch, sequence length, AdamW lr, warmup steps, the
# launches of each kernel per training step; every other kernel launches
# none): the training phases at full width and full depth. Per layer and
# step the forward runs twice (the second from remat's recompute) and the
# backward once.
TRAIN = [
    ("llama3.2-3b", 6, 2, 2048, 3e-4, 2,
     {"flash_attention_fwd": 56, "flash_attention_bwd": 28}),
    ("mamba2-130m", 6, 8, 4096, 3e-4, 2, {"ssd_fwd": 48, "ssd_bwd": 24}),
]


def train_phase(device: torch.device, arch: str, steps: int, batch: int,
                seq: int, lr: float, warmup: int, per_step: dict,
                records: dict) -> None:
    """Full-width training of ``arch`` through the port's entry point
    (``repro_torch.launch.train.train``), random fp32 weights from a seed:
    per-step loss (all finite), step time, tokens/s and MFU (median of
    steps 2-5), peak memory, each kernel's launches (counts set to 0 just
    before, read just after: ``per_step`` times the steps), and TALP's
    train_loop hierarchies. Then one more step traced with
    ``torch.profiler``: device time by kernel and the busy share."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch.steps import make_train_step, model_flops
    from repro_torch.launch.train import train
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig, adamw_update

    cfg = get_config(arch)
    opt = AdamWConfig(lr=lr, warmup_steps=warmup, total_steps=steps)
    counters = launch_counters()
    for wrapper in counters.values():
        wrapper.launches = 0
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state, history, result = train(cfg, steps=steps, global_batch=batch,
                                   seq_len=seq, opt_cfg=opt, seed=0,
                                   verbose=False, device=device)
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in counters.items()}
    peak = torch.cuda.max_memory_allocated(device)
    want = {name: per_step.get(name, 0) * steps for name in counters}
    assert launches == want, (
        f"{arch} training: launches {launches} in {steps} steps, want {want}"
        " (per step and layer: the forward twice, remat, and one backward)")
    losses = [h["loss"] for h in history]
    assert len(history) == steps and all(map(math.isfinite, losses)), losses
    for h in history:
        print(f"[train] step {h['step']}: loss {h['loss']:.6f}, grad norm "
              f"{h['grad_norm']:.6f}, {h['time_s'] * 1e3:.3f} ms")
    step_s = statistics.median([h["time_s"] for h in history[1:5]])
    tokens = batch * seq
    flops = model_flops(cfg, ShapeConfig("train", seq, batch, "train"))
    note = (", the 6·N count, which leaves out the SSD scan's own "
            "operations" if "ssm" in cfg.pattern else "")
    print(f"[train] {arch} full width, {cfg.num_layers} layers, "
          f"{lm.param_count(state['params']) / 1e9:.3f} B params, global "
          f"batch {batch} x {seq}: step {step_s * 1e3:.3f} ms (median of "
          f"steps 2-5), {tokens / step_s:.1f} tokens/s, MFU "
          f"{flops / (step_s * PEAK_FLOPS[torch.bfloat16]):.4f} "
          f"({flops / 1e12:.2f} TFLOP model flops per step at 989 TFLOP/s"
          f"{note}), peak memory {peak / 2**30:.3f} GiB "
          f"({peak / 1e9:.3f} GB), wall {wall:.2f} s; launches {launches} "
          "(per step: " + ", ".join(f"{n} {launches[n] // steps}"
                                    for n in per_step) + ")")
    loop = result.regions["train_loop"]
    loop.host.validate(tol=1e-6)
    loop.device.validate(tol=1e-6)
    hs, ds = loop.host_states[0], loop.device_states[0]
    assert hs["useful"] > 0 and hs["offload"] > 0 and ds["kernel"] > 0
    print(f"[talp] {arch} train_loop: Host PE "
          f"{loop.host.parallel_efficiency:.4f} (useful {hs['useful']:.6f} s,"
          f" offload {hs['offload']:.6f} s), Offload Eff. "
          f"{loop.host.device_offload_efficiency:.4f} | Device PE "
          f"{loop.device.parallel_efficiency:.4f} (kernel {ds['kernel']:.6f} "
          f"s, idle {ds['idle']:.6f} s)")
    add_path_launches(records, f"train {arch} ({steps} steps)", launches)

    step_fn = make_train_step(cfg, opt)
    data = SyntheticTokenPipeline(DataConfig(batch, seq, cfg.vocab_size))
    b = {k: torch.from_numpy(v).to(device)
         for k, v in data.batch_at(steps).items()}
    prof, traced_wall, union, (state, _) = traced(lambda: step_fn(state, b))
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_time = lambda e: getattr(  # noqa: E731
        e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
    busy = sum(dev_time(e) for e in kernels) * 1e-6
    if busy <= 0:
        print("[profile] train step: torch.profiler shows no device time "
              "here, so the busy share is not measured")
        compare_pe(f"{arch} train_loop", loop.device.parallel_efficiency,
                   loop.elapsed / steps, None)
    else:
        print(f"[profile] {arch} train step: device kernel time "
              f"{busy * 1e3:.3f} ms in {sum(e.count for e in kernels)} "
              f"kernels ({busy / step_s:.4f} of the median step); traced "
              f"step {traced_wall * 1e3:.3f} ms, kernels busy "
              f"{union * 1e3:.3f} ms of it, busy share of the traced step "
              f"{union / traced_wall:.4f}")
        ranked = sorted(kernels, key=dev_time, reverse=True)
        for e in ranked[:10] + [e for e in ranked[10:] if re.search(
                "|".join(KERNEL_NAMES), e.key)]:
            print(f"[profile]   {dev_time(e) * 1e-3:9.3f} ms x{e.count:<5d} "
                  f"{e.key[:90]}")
        groups: dict = {}
        for e in kernels:
            group = next((g for g, pat in KERNEL_GROUPS
                          if re.search(pat, e.key)), "other")
            groups[group] = groups.get(group, 0.0) + dev_time(e) * 1e-3
        print("[profile] train step device time by group: " + ", ".join(
            f"{g} {ms:.3f} ms" for g, ms in sorted(
                groups.items(), key=lambda kv: -kv[1])))
        compare_pe(f"{arch} train_loop vs the traced step",
                   loop.device.parallel_efficiency, loop.elapsed / steps,
                   union)
    # the AdamW update alone (CUDA events around it; bf16 copies of the
    # parameters stand in for the gradients)
    grads = lm.tree_map(lambda x: x.to(torch.bfloat16), state["params"])
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    times = []
    for _ in range(3):
        start.record()
        adamw_update(opt, state["params"], grads, state["opt"])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    print(f"[train] AdamW update alone: {statistics.median(times):.3f} ms "
          f"(median of 3, CUDA events) of the {step_s * 1e3:.3f} ms step")
    del state, b, grads


# Kernel-name patterns by group, for the train step's device time.
KERNEL_GROUPS = (
    ("flash (this repo)", "flash_"),
    ("ssd (this repo)", "ssd_"),
    ("matmul (cuBLAS)", "nvjet|gemm|gemv|cutlass|sm90_xmma"),
    ("elementwise and copies", "elementwise|copy|Memcpy|Memset|fill"),
    ("reductions", "reduce|softmax|norm"),
)


def profile_phase(device: torch.device, arch: str, batch: int,
                  prompt_len: int, gen_len: int) -> dict:
    """Where the serving time goes on the card: the prefill and the decode
    step of full-width ``arch`` (its serve phase's shapes), each timed on
    the host clock without the profiler (median of 5), then traced by
    ``torch.profiler`` (CUDA activity only, see ``traced``; 3 prefills, 8
    decode steps) for the device time of every kernel. Returns each
    step's kernel time per call (the union of the traced calls' kernel
    intervals over the number of calls), which main() divides by the serve
    phase's wall per call of the same step for the profiler's busy share,
    and holds TALP's device PE of that region against it: TALP reads the
    kernel time through its markers and the engine's flattening, the
    profile from a session of its own. The decode step is then timed again
    with TALP's collection open: the difference is the collection's cost
    per step."""
    from repro_torch.configs import get_config
    from repro_torch.core.backends import CudaRuntimeBackend
    from repro_torch.models import lm

    cfg = get_config(arch)
    gen = torch.Generator(device=device).manual_seed(1)
    with torch.inference_mode():
        params = lm.init_params(cfg, gen, device=device, dtype=torch.bfloat16)
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                generator=gen, device=device,
                                dtype=torch.int32)
        logits, caches, pos = lm.prefill(cfg, params, prompts)
        caches = lm.grow_caches(cfg, caches, prompt_len + gen_len)
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        steps = {
            "prefill": lambda: lm.prefill(cfg, params, prompts),
            # rewrites the same hot-ring slot (attention) or advances the
            # state in place (SSM) each time: the same work per call
            "decode_step": lambda: lm.decode_step(cfg, params, tok, pos,
                                                  caches),
        }
        kernel_time = {}   # the kernel time (union) of one call, seconds

        def median_wall(step):
            walls = []
            for _ in range(5):
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            return statistics.median(walls)

        for name, step in steps.items():
            step()
            torch.cuda.synchronize()
            wall = median_wall(step)
            reps = 3 if name == "prefill" else 8
            prof, traced_wall, union, _ = traced(step, reps)
            kernels = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            dev_time = lambda e: getattr(  # noqa: E731
                e, "self_device_time_total",
                getattr(e, "self_cuda_time_total", 0.0))
            # per call of the step
            busy = sum(dev_time(e) for e in kernels) * 1e-6 / reps
            n_launch = sum(e.count for e in kernels) // reps
            n_kernels = sum(e.count for e in kernels if not e.key.startswith(
                ("Memcpy", "Memset"))) // reps
            if busy <= 0:
                print(f"[profile] {arch} {name}: wall {wall * 1e3:.3f} ms "
                      "(median of 5); torch.profiler shows no device time "
                      "here, so the busy share is not measured")
                continue
            kernel_time[name] = union / reps
            print(f"[profile] {arch} {name}: wall {wall * 1e3:.3f} ms (median"
                  f" of 5, no profiler), device kernel time "
                  f"{busy * 1e3:.3f} ms in {n_launch} kernels per call; "
                  f"{reps} calls traced in {traced_wall * 1e3:.3f} ms, kernels "
                  f"busy {union * 1e3:.3f} ms of it, busy share of the "
                  f"traced calls {union / traced_wall:.4f}")
            if name == "decode_step":
                # the same step with TALP's CUPTI collection open
                be = CudaRuntimeBackend(device)
                be.start()
                wall_on = median_wall(step)
                [(_, kinds, _, _, _)] = be.flush_arrays()
                be.stop()
                rows = int((kinds == 0).sum()) / 5
                print(f"[overhead] {arch} decode step: wall {wall * 1e3:.3f} "
                      f"ms without TALP's CUPTI collection, "
                      f"{wall_on * 1e3:.3f} ms with it open (medians of 5): "
                      f"{(wall_on - wall) * 1e3:.3f} ms per step, "
                      f"{(wall_on - wall) / n_launch * 1e6:.2f} us per "
                      f"kernel of the step's {n_launch}; the collection held "
                      f"{rows:.1f} kernel rows per step against the trace's "
                      f"{n_kernels} (memcpy and memset apart), "
                      f"{be.lost_markers} marker rows lost")
            ranked = sorted(kernels, key=dev_time, reverse=True)
            # the six heaviest, then every other kernel of this repository
            for e in ranked[:6] + [e for e in ranked[6:]
                                   if re.search("|".join(KERNEL_NAMES), e.key)]:
                print(f"[profile]   {dev_time(e) * 1e-3 / reps:9.3f} ms "
                      f"x{e.count // reps:<5d} {e.key[:90]}")
    del params, caches
    return kernel_time


def traced(step, reps: int = 1):
    """``reps`` calls of ``step`` traced by ``torch.profiler`` with CUDA
    activity only, the collection TALP's backend opens: (the profiler, the
    host wall of the calls up to their synchronise, the union of their
    kernels' intervals in seconds, the last call's result). The union over
    the wall is the step's busy share: a share of one window, never above
    1, which a sum of kernel times over another run's wall can exceed."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            out = step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cpu = torch.autograd.DeviceType.CPU
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() != cpu and not e.is_user_annotation()
                   and not e.name().startswith(("Memcpy", "Memset")))
    busy, reach = 0, None
    for start, end in spans:
        if reach is None or start > reach:
            busy, reach = busy + end - start, end
        elif end > reach:
            busy, reach = busy + end - reach, end
    return prof, wall, busy * 1e-9, out


def compare_pe(label: str, talp_pe: float, wall: float, kernel) -> None:
    """TALP's device PE of a region against the profiler's busy share of
    the same step: the profiler's kernel time for one call of the step
    (``kernel``, seconds, from ``profile_phase`` or the traced training
    step) over the region's own wall per call (``wall``), within
    PE_BOUND. Host stalls in the region (a first call's allocations, the
    collection's cost) lengthen both sides' window alike; what is held is
    TALP's kernel time, record by record, against the profiler's."""
    assert kernel is not None, f"{label}: the profiler measured no kernel time"
    busy = kernel / wall
    print(f"[talp-vs-profiler] {label}: TALP device PE {talp_pe:.4f} over "
          f"{wall * 1e3:.3f} ms per call; profiler kernel time "
          f"{kernel * 1e3:.3f} ms per call, busy share {busy:.4f} of that "
          f"wall; difference {talp_pe - busy:+.4f} (bound {PE_BOUND})")
    assert abs(talp_pe - busy) <= PE_BOUND, (label, talp_pe, busy)


# (arch, requests, prompt tokens, generated tokens, decode steps a sample):
# the serving run the TALP flags phase drives four times, and the flags
TALP_FLAGS_RUN = ("llama3.2-3b", 8, 1024, 64, 16)


class _Scraper:
    """A stand-in for stdout during a flagged run: lines beginning with
    ``[talp`` go to the real stdout; on the exporter's ``prometheus
    exposition on :PORT/metrics`` line it starts polling that endpoint on
    127.0.0.1 every 0.25 s, keeping each scrape that holds a snapshot."""

    def __init__(self, out):
        self.out, self.buf, self.scrapes = out, "", []
        self._stop = threading.Event()
        self._thread = None

    def write(self, text):
        self.buf += text
        *lines, self.buf = self.buf.split("\n")
        for line in lines:
            if line.startswith("[talp"):
                self.out.write(line + "\n")
            m = re.search(r"prometheus exposition on :(\d+)/metrics", line)
            if m and self._thread is None:
                self._thread = threading.Thread(
                    target=self._poll, args=(int(m.group(1)),), daemon=True)
                self._thread.start()
        return len(text)

    def flush(self):
        self.out.flush()

    def _poll(self, port):
        while not self._stop.wait(0.25):
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/metrics", timeout=2) as r:
                    body = r.read().decode()
            except OSError:
                continue
            if not body.startswith("# no samples"):
                self.scrapes.append(body)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join()


def _prom_value(body: str, family: str, region: str = "Global") -> float:
    m = re.search(rf'^{family}{{region="{region}",[^}}]*}} (\S+)$', body,
                  re.M)
    assert m, f"no {family} for region {region} in the scrape"
    return float(m.group(1))


def talp_flags_phase(device: torch.device, decode_kernel_s: float,
                     records: dict) -> None:
    """TALP's runtime outputs on llama3.2-3b serving at full width and depth
    (``repro_torch.launch.serve.serve`` with the keyword arguments of the
    ``--talp-*`` flags), in turns with plain runs of the same serve;
    ``decode_kernel_s`` is the profile phase's kernel time of one decode
    step. Each run's launch counters are set to 0 just before it and read
    just after: 28 flash forwards in its prefill."""
    from repro_torch.configs import get_config
    from repro_torch.core.backends import CudaRuntimeBackend
    from repro_torch.core.merge import (FileSpoolTransport,
                                        load_spool_payload, merge_spool)
    from repro_torch.core.report import to_json
    from repro_torch.core.telemetry import overhead as ovh
    from repro_torch.core.telemetry.traceexport import (
        PID_DEVICE, validate_chrome_trace)
    from repro_torch.launch.serve import serve

    arch, requests, prompt_len, gen_len, every = TALP_FLAGS_RUN
    cfg = get_config(arch)
    counters = launch_counters()
    runs = []
    # plain, flagged, plain, flagged with the JSON spool; then once more
    # flagged with the copy's step series, which drains at every step
    # close (the backend's flag that makes it defer, switched off)
    for i, (fmt, per_step) in enumerate(((None, False), ("binary", False),
                                         (None, False), ("json", False),
                                         ("binary", True))):
        tmp = Path(tempfile.mkdtemp(prefix="talp_flags_"))
        kw = {} if fmt is None else dict(
            talp_step_series=gen_len, talp_watchdog=True,
            talp_anomaly_log=str(tmp / "anomalies.jsonl"),
            talp_trace_out=str(tmp / "trace.json"),
            talp_metrics_jsonl=str(tmp / "metrics.jsonl"),
            talp_prometheus_port=0, talp_spool=str(tmp / "spool"),
            talp_spool_format=fmt, talp_sample_every=every)
        scraper = _Scraper(sys.stdout) if fmt else None
        for wrapper in counters.values():
            wrapper.launches = 0
        t0 = time.perf_counter()
        with redirect_stdout(scraper) if scraper else nullcontext(), (
                mock.patch.object(CudaRuntimeBackend,
                                  "flush_closes_collection", False)
                if per_step else nullcontext()):
            tokens, result = serve(cfg, requests=requests,
                                   prompt_len=prompt_len, gen_len=gen_len,
                                   seed=0, verbose=bool(fmt), device=device,
                                   **kw)
        wall = time.perf_counter() - t0
        if scraper:
            scraper.stop()
        launches = {name: w.launches for name, w in counters.items()}
        assert launches == {**{n: 0 for n in counters},
                            "flash_attention_fwd": 28}, launches
        add_path_launches(records, f"serve {arch} TALP flags run {i + 1}",
                          launches)
        assert tokens.shape == (requests, gen_len)
        acc = ovh.current().as_dict()
        sections, counts = acc["sections"], acc["counts"]
        glob, dec = result.regions["Global"], result.regions["decode"]
        glob.host.validate(tol=1e-6)
        glob.device.validate(tol=1e-6)
        run = {"flags": fmt, "per_step": per_step, "wall": wall,
               "tok_s": requests * gen_len
               / dec.elapsed, "prefill_ms":
               result.regions["prefill"].elapsed * 1e3,
               "overhead": glob.host.talp_overhead,
               "ce": glob.device.computational_efficiency}
        label = ("plain" if fmt is None else f"flagged, spool {fmt}"
                 + (", drained at every step close" if per_step else ""))
        print(f"[talp-flags] run {i + 1} ({label}): "
              f"prefill {run['prefill_ms']:.3f} ms, decode "
              f"{run['tok_s']:.2f} tok/s ({dec.elapsed * 1e3 / gen_len:.3f} "
              f"ms/step), decode device PE "
              f"{dec.device.parallel_efficiency:.4f}, wall {wall:.3f} s "
              f"(Global {glob.elapsed:.3f} s); TALP Overhead "
              f"{run['overhead']}, overhead sections (s) "
              + ", ".join(f"{k} {v:.3f}" for k, v in sorted(sections.items()))
              + f"; CE {run['ce']}")
        if fmt is not None:
            spool = tmp / "spool"
            # the trace: valid, its device lane's Kernel time the report's
            text = (tmp / "trace.json").read_text()
            summary = validate_chrome_trace(text)
            lane = sum(e["dur"] for e in json.loads(text)["traceEvents"]
                       if e.get("ph") == "X" and e.get("pid") == PID_DEVICE
                       and e.get("name") == "Kernel") * 1e-6
            kern = glob.device_states[0]["kernel"]
            assert abs(lane - kern) <= 1e-6 * kern, (lane, kern)
            # the stream: one line per sample, and the final one
            lines = (tmp / "metrics.jsonl").read_text().splitlines()
            assert len(lines) == gen_len // every + 1, len(lines)
            stream = [json.loads(line) for line in lines]
            # the scrape: the host PE of the snapshot it names
            assert scraper.scrapes, "no scrape of /metrics held a snapshot"
            body = scraper.scrapes[-1]
            seq = int(re.search(r"^talp_sample_seq\{[^}]*\} (\d+)$", body,
                                re.M).group(1))
            scraped = _prom_value(body, "talp_host_parallel_efficiency")
            want = stream[seq]["regions"]["Global"]["host"][
                "parallel_efficiency"]
            assert scraped == want, (seq, scraped, want)
            # the spool: a one-rank job report; its re-merge timed
            job = json.loads((spool / "talp_job.json").read_text())
            assert len(job["regions"]["Global"]["host_states"]) == 1
            t1 = time.perf_counter()
            merged = to_json(merge_spool(str(spool)))
            merge_s = time.perf_counter() - t1
            assert json.loads(merged)["regions"].keys() == job[
                "regions"].keys()
            rows = FileSpoolTransport(str(spool)).collect_steps()[0]
            _, timelines = load_spool_payload(
                str(next(spool.glob("talp_rank00000.*"))))
            n_rows = sum(tl.n_kernel_records for tl in timelines.values())
            anomalies = tmp / "anomalies.jsonl"
            n_events = (len(anomalies.read_text().splitlines())
                        if anomalies.exists() else 0)
            ce = run["ce"]
            assert ce is not None and 0 < ce <= 1, ce
            sizes = {f.name: f.stat().st_size for f in sorted(
                list(tmp.glob("*.json*")) + list(spool.iterdir()))}
            print(f"[talp-flags] run {i + 1}: {len(rows)} step rows, "
                  f"{n_events} watchdog events, {len(lines)} stream lines "
                  f"({stream[-1]['seq'] + 1} snapshots); scrape of /metrics "
                  f"named snapshot {seq}, host PE {scraped!r}; trace "
                  f"{summary['n_events']} events, device-lane Kernel "
                  f"{lane:.6f} s against the report's {kern:.6f} s; CE "
                  f"{ce:.6f} over {1 + gen_len} launches (counting the "
                  f"{n_rows} kernel rows in their place would read "
                  f"{ce * n_rows / (1 + gen_len):.1f}); bytes " + ", ".join(f"{k} {v}" for k, v in sizes.items())
                  + f"; export {sections.get('export', 0.0):.3f} s, spool "
                  f"publish {sections.get('spool', 0.0):.3f} s, re-merge of "
                  f"the spool {merge_s:.3f} s; {counts.get('drain', 0)} "
                  f"drains of the collection {sections.get('drain', 0.0):.3f}"
                  f" s ({sections.get('drain', 0.0) / n_rows * 1e6:.2f} us "
                  f"per kernel row)")
            assert len(rows) == gen_len, len(rows)
            pe = rows.column("device_parallel_efficiency")
            elapsed = rows.column("elapsed")
            compare_pe(f"{arch} decode_step rows (run {i + 1})",
                       float(pe.mean()), float(elapsed.mean()),
                       decode_kernel_s)
        runs.append(run)
        shutil.rmtree(tmp)
        del tokens, result
        torch.cuda.empty_cache()
    from repro_torch.core.backends.cuda_runtime import CuptiActivity

    print(f"[talp-flags] records CUPTI dropped in this process: "
          f"{CuptiActivity().dropped}")
    plain = [r for r in runs if r["flags"] is None]
    flagged = [r for r in runs if r["flags"] and not r["per_step"]]
    med = lambda rs, key: statistics.median(r[key] for r in rs)  # noqa: E731
    print(f"[talp-flags] decode rate, median of 2: plain "
          f"{med(plain, 'tok_s'):.2f} tok/s, flagged {med(flagged, 'tok_s'):.2f}"
          f" tok/s, flagged/plain "
          f"{med(flagged, 'tok_s') / med(plain, 'tok_s'):.4f}; prefill plain "
          f"{med(plain, 'prefill_ms'):.3f} ms, flagged "
          f"{med(flagged, 'prefill_ms'):.3f} ms; drained at every step "
          f"close: {runs[-1]['tok_s']:.2f} tok/s, "
          f"{runs[-1]['tok_s'] / med(plain, 'tok_s'):.4f} of plain")


# (arch, ranks, steps, global batch, sequence length, launches per step on
# each rank)
FLEET = ("mamba2-130m", 2, 6, 8, 4096, {"ssd_fwd": 48, "ssd_bwd": 24})


def fleet_phase(device: torch.device, records: dict) -> None:
    """Two ranks of one mamba2-130m training job as two concurrent
    ``python -m repro_torch.launch.train`` processes on the one card, with
    a shared spool, the step series, the watchdog and a sample every 3
    steps: each rank trains its half of the global batch (no collective;
    TALP's job report merges their spooled reports)."""
    from repro_torch.core.merge import (FileSpoolTransport, InProcessGather,
                                        load_spool_payload)
    from repro_torch.core.report import to_json

    arch, ranks, steps, batch, seq, per_step = FLEET
    tmp = Path(tempfile.mkdtemp(prefix="talp_fleet_"))
    spool = tmp / "spool"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--steps", str(steps), "--batch", str(batch), "--seq", str(seq),
         "--rank", str(r), "--world-size", str(ranks),
         "--talp-spool", str(spool), "--talp-step-series", str(steps),
         "--talp-watchdog", "--talp-sample-every", "3",
         "--history-json", str(tmp / f"history{r}.json")],
        env=env, cwd=str(SRC.parent), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(ranks)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=600))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    for r, (proc, (out, err)) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, (r, out[-3000:], err[-3000:])
    payloads = [load_spool_payload(str(spool / f"talp_rank{r:05d}.npz"))[0]
                for r in range(ranks)]
    gather = InProcessGather(world_size=ranks)
    for r, res in enumerate(payloads):
        gather.submit(res, rank=r)
    job_text = (spool / "talp_job.json").read_text()
    assert job_text == to_json(gather.merge(name="train")), (
        "the fleet's talp_job.json differs from the in-process merge")
    job = json.loads(job_text)
    g = job["regions"]["Global"]
    assert len(g["host_states"]) == ranks, g["host_states"]
    transport = FileSpoolTransport(str(spool))
    series = transport.collect_steps()
    assert sorted(series) == list(range(ranks)), sorted(series)
    assert all(len(s) == steps for s in series.values()), {
        r: len(s) for r, s in series.items()}
    table = transport.merge_steps(name="train")
    assert len(table) == steps, len(table)
    for r, ((out, _), res) in enumerate(zip(outs, payloads)):
        m = re.search(r"peak memory ([\d.]+) GiB; kernel launches (\{.*\})",
                      out)
        assert m, out[-2000:]
        launches = json.loads(m.group(2))
        want = {n: per_step.get(n, 0) * steps for n in launches}
        assert launches == want, (r, launches, want)
        add_path_launches(records, f"train {arch} rank {r} of {ranks} "
                                   f"({steps} steps)", launches)
        history = json.loads((tmp / f"history{r}.json").read_text())
        assert all(map(math.isfinite, (h["loss"] for h in history)))
        step_s = statistics.median(h["time_s"] for h in history[1:5])
        rg = res.regions["Global"]
        ce = rg.device.computational_efficiency
        assert ce is not None and 0 < ce <= 1, (r, ce)
        loop = res.regions["train_loop"]
        rows_pe = series[r].column("device_parallel_efficiency")
        print(f"[fleet] rank {r}: step {step_s * 1e3:.3f} ms (median of "
              f"steps 2-5), {batch // ranks * seq / step_s:.1f} tokens/s, "
              f"peak memory {float(m.group(1)):.3f} GiB, train_loop device "
              f"PE {loop.device.parallel_efficiency:.4f} (step rows' device "
              f"PE " + ", ".join(f"{v:.4f}" for v in rows_pe) + "), host PE "
              f"{loop.host.parallel_efficiency:.4f}, CE {ce:.6f}, losses "
              + ", ".join(f"{h['loss']:.4f}" for h in history))
    hm = g["host_metrics"]
    print(f"[fleet] {arch} {ranks} ranks on one card, global batch {batch} x "
          f"{seq}, {steps} steps: wall {wall:.2f} s; job Global host PE "
          f"{hm['parallel_efficiency']:.4f}, Load Balance "
          f"{hm['load_balance']:.4f}; step table {len(table)} rows of "
          f"{len(series)} ranks; talp_job.json equal to the in-process "
          f"merge ({len(job_text)} bytes)")
    shutil.rmtree(tmp)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {SRC}; run this script "
              "from a checkout of the repository", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[card] {nvidia_smi()}")
    print(f"[versions] python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    marks = []   # (phase, seconds since the start) after each phase

    def mark(phase):
        marks.append((phase, time.perf_counter() - t0))

    sass = build_kernels()
    mark("build")
    talp_backend_check(device)
    records = {rec["name"]: rec
               for rec in (kernel_phase(device), backward_phase(device),
                           ssd_kernel_phase(device),
                           ssd_backward_phase(device))}
    for name, counts in sass.items():
        records[name]["sass"] = counts
    mark("kernel phases")
    path_check(device)
    mamba_path_check(device)
    zamba_path_check(device)
    train_path_check(device)
    mark("path checks")
    busy_by_arch = {}
    for arch, requests, prompt_len, gen_len, expected in SERVE:
        talp = serve_phase(device, arch, requests, prompt_len, gen_len,
                           expected, records)
        torch.cuda.empty_cache()
        busy = busy_by_arch[arch] = profile_phase(device, arch, requests,
                                                  prompt_len, gen_len)
        for region, step in (("prefill", "prefill"), ("decode", "decode_step")):
            compare_pe(f"{arch} {region}", *talp[region], busy.get(step))
        torch.cuda.empty_cache()
    mark("serve and profile")
    for row in TRAIN:
        train_phase(device, *row, records)
        torch.cuda.empty_cache()
    mark("training")
    talp_flags_phase(device, busy_by_arch[TALP_FLAGS_RUN[0]].get(
        "decode_step"), records)
    mark("TALP flags")
    fleet_phase(device, records)
    mark("fleet")
    print("[time] seconds since the start, after each phase: " + ", ".join(
        f"{phase} {secs:.1f}" for phase, secs in marks))
    missing = [name for name, rec in records.items() if not rec["launches"]]
    assert not missing, f"kernels no main path launched: {missing}"
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
