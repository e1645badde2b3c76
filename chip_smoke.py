"""GPU smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, and builds the CUDA kernels from the sources in this
   checkout (one ``nvcc`` per source, all started together: the flash
   forward, the flash backward, the SSD scan forward and backward, the
   fused AdamW), timing
   the build and printing each kernel's ``ptxas -v`` registers and spills.
   Counts the HGMMA (wgmma), UTMALDG (TMA load) and HMMA (mma.sync)
   instructions in each library's SASS (``cuobjdump -sass``) and fails
   unless both flash libraries have HGMMA and UTMALDG and no HMMA and the
   SSD forward and backward have HMMA; fails if any ``ptxas`` log says it
   serialises wgmma (warning C7520, a wgmma under a branch; C7512, too few
   registers), if a forward kernel (D 32, 64, 80, 120, 128, 224, 256), a
   wgmma kernel of the flash backward (both passes at D 32, 64, 80, 120,
   128, 224 and 256) or a kernel of the SSD backward, the fused AdamW or
   the conv spills.
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
     (MHA, GQA, ragged, window and soft-cap) and the serving
     prefill shape of zamba2-2.7b (B 8, S 4096, H = K 32, D 80, bf16;
     its plain version one request at a time), then the serving prefill
     shape of granite-moe-3b-a800m (B 8, S 1024, H 24, K 8, D 64, bf16),
     then the head layouts of musicgen-large (MHA, H = K = 32, D 64),
     starcoder2-15b (GQA 48/4, D 128) and qwen2-vl-72b (64/8, D 128) and
     their serving prefill shapes (B 8, S 1024, bf16); then head dims 120
     and 256 (NEW_DIMS: MHA, GQA 4:1 and 2:1, ragged S < T,
     window with soft-cap, S below one query tile, a window narrower than
     T - S) and the serving prefills of gemma2-2b (B 4, S 8192, H 8, K 4,
     D 256, soft-cap 50; global layers, and local ones with window 4096)
     and h2o-danube-3-4b (B 4, S 8192, H 32, K 8, D 120, window 4096),
     whose plain version runs one KV group of one request at a time. Each
     row is also held per row (row_rel_err: each output row's error over
     that row's size, at the row's tolerance), and at bf16 with T of 4096
     and more two planted faults must fail that check (the output's columns
     D/2 and up zeroed; every element off by half the raw limit). At the
     nine prefill shapes it times the plain version, then the kernel and
     one PyTorch library call (a yardstick only) in turns: library, kernel,
     kernel, library. The call is ``scaled_dot_product_attention``, or with
     a window or a soft-cap ``flex_attention``, compiled, with the soft-cap
     as its score_mod and the window as a BlockMask (its output held to the
     kernel's per row); SDPA is then timed in the same turns as a side note
     (without the cap; with a window, an explicit boolean mask);
   * the flash-attention backward over the same rows, the new head
     layouts and the training shapes of llama3.2-3b (B 2, S 2048, H 24,
     K 8, D 128, bf16), of granite-moe-3b-a800m (the same at D 64) and of
     musicgen-large (H = K = 32, D 64), then NEW_DIMS (with its D-80 rows,
     the D-120 rows at D 80) and the training shapes of gemma2-2b (B 1,
     S 8192, D 256; global and local), h2o-danube-3-4b (B 1, S 8192,
     D 120, window 4096) and zamba2-2.7b (B 2, S 4096, H = K 32, D 80):
     dq, dk, dv against
     the plain backward and against autograd through the plain forward,
     both in fp32 (one KV group at a time where a request's fp32 scores
     exceed 2 GiB), bf16 rows also per row against the plain backward,
     with the planted faults at the 4096- and 8192-token training shapes,
     and a second run bit-identical; at the seven training shapes and
     llama's serving prefill
     shape it times the plain version, then the kernels and the backward
     of ``scaled_dot_product_attention`` in turns (of ``flex_attention``
     for windows and soft-caps, SDPA's as a side note, as in the forward);
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
     shape), at TOL[bf16] on each gradient over its reference's max-abs,
     a second run bit-identical; at the training shape it times the plain
     backward (autograd through the plain version in fp32) and the kernel
     in turns, beside the bound of ssd_backward_work, and prints one traced call's kernels by name; the same rows and
     timing at zamba2-2.7b's training shape (B 2, L 4096, H 80, P 64, G 1,
     N 64);
   * the fused AdamW (``adamw_phase``) on mamba2-2.7b's whole 2.83
     B-parameter tree with bf16 gradients: three steps past warmup, the
     clip on, against the plain arithmetic leaf by leaf (each leaf's
     change in p, mu and nu within ADAMW_CHANGE_TOL of the plain change;
     the grad norm; a rerun bit-identical), then the fused step, the
     plain one and the library route (``torch._fused_adamw_``) in turns,
     each pass alone beside its bound, and each route's peak memory
     beyond the state;
   * zamba2-7b's kernels (``zamba7_phase``): both flash kernels at head
     dim 224 with Zamba-2's scale (D/2)^-1/2 (the D-256 rows at D 224 and
     the training shape B 2, S 4096, H = K 32), output, LSE and dq, dk, dv
     per row against the plain versions, a second backward bit-identical,
     kernel, plain and cuDNN's SDPA (given the scale) timed there; the SSD
     forward at H 112, G 2, N 64 against float64, both SSD kernels timed.
   Timings are CUDA events around runs of back-to-back calls (ms per
   call), medians; kernel and yardstick are timed in turns.
3. Path checks: two narrow layers of each model's block on the card
   against the same layers on the CPU (plain versions), prefill then 4
   decode steps, the same bf16 weights (zamba2: its smoke config with head
   dim 80 and P 64, N 64, chunk 256, whose two shared-block repeats must
   write different KV rows; granite-moe-3b-a800m: its smoke config with
   head dim 64 and capacity factor 1.25, which drops tokens, with the
   share of equal routings printed; the embed frontend:
   musicgen-large's smoke config at head dim 64 and qwen2-vl-72b's at head
   dim 128 with M-RoPE sections (16, 24, 24), prefilled on random bf16
   embeddings and decoded on embedded frames, and M-RoPE with three
   distinct position streams; gemma2-2b at head dim 256 and
   h2o-danube-3-4b at head dim 120, a 300-token prompt past their smoke
   window of 64); and one training step of the llama3.2-3b smoke config
   (head_dim 32), one of the mamba2-130m smoke config, one of the
   musicgen-large smoke config (head_dim 64, fp32 embeddings) and one each
   of gemma2-2b (head_dim 256) and h2o-danube-3-4b (head_dim 120), in bf16
   compute, on the card against the CPU from the same state, held to the
   CPU's fp32 step (``card_rules``, which zamba2's path check follows too).
4. Serve phases: ``repro_torch.launch.serve.serve`` under the TALP monitor
   at full width, random weights from a seed: llama3.2-3b with 8 requests
   of 1024 prompt tokens and 64 generated tokens, then mamba2-130m (all
   24 layers) and zamba2-2.7b (all 54 layers) with 8 requests of 4096
   prompt tokens and 64 generated tokens, then granite-moe-3b-a800m (32
   layers, 40 experts top-8, 3.98 B parameters), musicgen-large (48
   layers, the embed frontend: random bf16 embedding prompts, zero decode
   frames), starcoder2-15b (40 layers, 22.0 B parameters, 41 GiB of bf16
   weights) and qwen2-vl-72b (M-RoPE, the embed frontend; its depth cut to
   16 of 80 layers, which the output states: 133 GiB of weights fit no
   one card) as llama; then h2o-danube-3-4b (24 layers, a window of 4096
   at each, D 120) and gemma2-2b (26 layers, local and global in turn,
   D 256, soft-caps 50 and 30) with 4 requests of 8192 prompt tokens (each
   model's context, past the window) and 64 generated tokens; then
   zamba2-7b (all 78 layers, 13 applications of its two shared blocks)
   with 4 requests of 4096 and 64 generated tokens. Every launch
   counter is set to 0 just before each run and read just after: the
   prefill must launch each kernel as often as SERVE says (llama: the
   flash forward 28 times; mamba: the SSD scan 24 times; zamba2: 9 and 45;
   granite: 32; musicgen: 48; starcoder2: 40; qwen2-vl: 16; danube: 24;
   gemma2: 26; zamba2-7b: 13 and 78) and no other. Checks the tokens and the TALP hierarchies.
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
   card: llama3.2-3b (3.61 B parameters), 6 steps of 2 x 2048 tokens,
   mamba2-130m (24 layers), 6 steps of 8 x 4096 tokens,
   granite-moe-3b-a800m, 6 steps of 2 x 2048, musicgen-large (3.23 B
   parameters, fp32 embedding batches), 6 steps of 2 x 2048,
   h2o-danube-3-4b (3.96 B) and gemma2-2b (3.20 B), 6 steps of 1 x 8192,
   and zamba2-2.7b (54 layers, the shared block at D 80), 6 steps of
   2 x 4096;
   first
   ``train`` must refuse starcoder2-15b and qwen2-vl-72b, whose train
   states (16 bytes a parameter) exceed the card, before allocating
   anything (``torch.cuda.memory_allocated`` unchanged). The launch
   counters are set to 0 just before each run and read just after: per
   step, llama launches the flash forward 56 times (28 layers, twice with
   remat) and its backward 28 times; mamba the SSD forward 48 times and
   its backward 24 times; granite the flash forward 64 times and its
   backward 32; musicgen 96 and 48; danube 48 and 24; gemma2 52 and 26;
   zamba2 the flash forward 18 and its backward 9 (9 repeats of the
   shared block) and the SSD forward 90 and its backward 45; every
   training step, here and in the path checks, the checkpoint, fleet and
   mesh phases, calls the fused AdamW's two passes once each
   (ADAMW_STEP).
   Prints
   each step's loss (all finite; granite's moe_aux too), step time,
   tokens/s, MFU, peak memory and TALP's train_loop numbers, then traces
   one more step with ``torch.profiler``: its kernel time over the
   train_loop's wall per step is the busy share TALP's train_loop device
   PE must match within PE_BOUND. For granite one more step is traced with
   CPU activity too, for the MoE's device time by part (routing,
   dispatch/combine, expert products; ``moe_step_breakdown``).
7. Checkpoint and restart phase: mamba2-130m training at full width (8 x
   4096, 6 steps) uninterrupted, then with a checkpoint every 3 steps and
   a failure injected before step 4 under ``run_with_restarts``: every
   step's loss and grad norm and the final state held to the
   uninterrupted run's (bit for bit, else within TOL[fp32], the largest
   difference printed), the restarted run's launches counted; one more
   save timed (its synchronous part, the writer, the bytes) and restored
   onto the card bit for bit against its host snapshot; TALP's train_loop
   host PE with its MPI child (the save's synchronous part).
8. TALP flags phase: llama3.2-3b serving as in the serve phase, four
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
9. Fleet phase: two ``python -m repro_torch.launch.train`` processes on the
   one card, ranks 0 and 1 of mamba2-130m training at full width (global
   batch 8 x 4096, 4 x 4096 each, 6 steps), one spool, a step series,
   the watchdog and a sample every 3 steps. Both must exit 0, each
   launching the SSD kernels 48 and 24 times a step; the job report they
   publish must be byte-identical to an in-process merge of their two
   payloads, with two host-state rows; each rank's CE in (0, 1]; 6 step
   rows per rank. Prints each rank's step time, peak memory and device
   PE, and the job's host Load Balance and PE.
10. Mesh phase (``mesh_phase``): a one-rank NCCL process group and a
   (1, 1) ("data", "model") DeviceMesh; llama3.2-3b's train steps (3 of
   2 x 2048, and one in fp32 compute with the plain attention) with the
   state placed by the
   partition plan held to the unsharded steps (loss, parameters, each
   leaf's gradient, flash launches), and
   zamba2-2.7b's decode steps (8 x 4096 + 16) on cache_pspec-placed caches
   held to the unsharded decode per row.
11. Dry-run phase (``dryrun_phase``): ``repro_torch.launch.dryrun`` on
   fake process groups, in subprocesses run side by side (no fake group
   meets the NCCL group above; nothing is allocated): llama3.2-3b's
   training (2 x 2048), prefill (8 x 1024) and decode step (8 x 1088),
   zamba2-2.7b's training (2 x 4096) and granite-moe-3b-a800m's (2 x
   2048), each counted on a (1, 1) "cuda" mesh of one fake rank and held
   to the same step measured above: the predicted kernel time (the larger
   of the compute and HBM terms) no more than the traced kernel time, the
   predicted peak within PEAK_BAND of max_memory_allocated, the TALP
   device trees printed side by side; then three calibrated production
   cells through the dry run's CLI (llama3.2-3b train_4k on 16x16,
   qwen3-moe-235b-a22b decode_32k on 16x16, mamba2-130m decode_32k on
   2x16x16), each printed as its JSON line with its seconds.
12. Prints one JSON line with every kernel's numbers, then, as the last
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
sys.path.insert(0, str(SRC.parent / "tests"))

from card_rules import TOL_BF16, bf16_no_worse, rel_norm  # noqa: E402

# Published peaks of one H100 SXM (dense): bf16 tensor cores, HBM3
# bandwidth.
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# rtol = atol, as tests/test_kernels.py::_tol.
TOL = {torch.float32: 2e-4, torch.bfloat16: TOL_BF16}

# (B, S, T, H, K, D, window, softcap, dtype): the rows of
# tests/test_kernels.py::ATTN_SWEEP, then ragged shapes the TPU kernel
# refused (S, T not multiples of the tile, S < T), then the serving
# prefill shape of llama3.2-3b. Every row is bf16, the one dtype the
# kernels take: a row the JAX package's sweep runs in fp32 keeps its
# shape, mask and soft-cap here.
SWEEP = [
    (1, 128, 128, 4, 4, 64, None, None, torch.bfloat16),
    (2, 256, 256, 4, 2, 64, None, None, torch.bfloat16),
    (1, 256, 256, 8, 2, 32, None, None, torch.bfloat16),
    (1, 256, 256, 4, 1, 64, None, None, torch.bfloat16),
    (1, 256, 256, 4, 2, 64, 64, None, torch.bfloat16),
    (1, 256, 256, 4, 2, 64, None, 50.0, torch.bfloat16),
    (1, 256, 256, 4, 2, 64, 128, 30.0, torch.bfloat16),
    (1, 384, 384, 2, 2, 128, None, None, torch.bfloat16),
    (2, 128, 128, 4, 2, 64, None, None, torch.bfloat16),
    (1, 256, 256, 4, 2, 64, 64, 50.0, torch.bfloat16),
    (1, 1000, 1000, 24, 8, 128, None, None, torch.bfloat16),
    (1, 1000, 1000, 4, 2, 64, 256, 30.0, torch.bfloat16),
    (2, 100, 300, 8, 2, 32, None, None, torch.bfloat16),
    (1, 100, 300, 4, 2, 128, 50, None, torch.bfloat16),
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
# Head dim 80 (zamba2-2.7b's shared block, 2560 / 32 heads, MHA) in the
# forward phase (NEW_DIMS holds its backward rows): MHA, GQA 2:1, S and T
# off the tile grid with S < T, window and soft-cap; then zamba2's serving
# prefill shape.
SWEEP_D80 = [
    (1, 256, 256, 4, 4, 80, None, None, torch.bfloat16),
    (2, 256, 256, 4, 4, 80, None, None, torch.bfloat16),
    (1, 256, 256, 8, 4, 80, None, None, torch.bfloat16),
    (1, 200, 328, 4, 2, 80, None, None, torch.bfloat16),
    (1, 256, 256, 4, 2, 80, 64, 30.0, torch.bfloat16),
    (1, 384, 384, 4, 2, 80, 100, 50.0, torch.bfloat16),
]
ZAMBA_PREFILL = (8, 4096, 4096, 32, 32, 80, None, None, torch.bfloat16)
# Head dim 64 at a model's shapes: the serving prefill of
# granite-moe-3b-a800m (1536 / 24 heads, GQA 3:1) and, below, its training
# shape.
GRANITE_PREFILL = (8, 1024, 1024, 24, 8, 64, None, None, torch.bfloat16)
# The head layouts of the embed-frontend and code models, checked after
# every row above (whose seeds stay): musicgen-large's MHA with H = K = 32
# at D 64, starcoder2-15b's GQA 48/4 (a ratio of 12) and qwen2-vl-72b's
# 64/8 at D 128, with S and T off the tile grid and S < T;
# then the three models' serving prefill shapes (8 x 1024).
NEW_HEADS = [
    (1, 256, 256, 32, 32, 64, None, None, torch.bfloat16),
    (1, 300, 428, 32, 32, 64, None, None, torch.bfloat16),
    (1, 300, 428, 48, 4, 128, None, None, torch.bfloat16),
    (1, 256, 256, 48, 4, 128, None, None, torch.bfloat16),
    (1, 300, 428, 64, 8, 128, None, None, torch.bfloat16),
]
MUSICGEN_PREFILL = (8, 1024, 1024, 32, 32, 64, None, None, torch.bfloat16)
STARCODER_PREFILL = (8, 1024, 1024, 48, 4, 128, None, None, torch.bfloat16)
QWEN_PREFILL = (8, 1024, 1024, 64, 8, 128, None, None, torch.bfloat16)
# Head dims 120 (h2o-danube-3-4b: 3840 / 32, GQA 4:1; the D-128 tiles over
# TMA's zero columns) and 256 (gemma2-2b, GQA 2:1; 64-key forward tiles, a
# dK/dV pass split over D, 32-key dQ tiles), forward and backward, checked
# after every row above (whose seeds stay): MHA, the model's GQA, S and T
# off the tile grid with S < T, a window with a soft-cap, S below one
# query tile, and S < T with a window narrower
# than T - S (a key block no query row sees). tests/test_torch_gpu.py::D120
# and D256 hold the same rows (there some in fp32, which the card's tests
# run at bf16).
NEW_DIMS = [
    (1, 256, 256, 4, 4, 120, None, None, torch.bfloat16),
    (2, 256, 256, 4, 4, 120, None, None, torch.bfloat16),
    (1, 256, 256, 8, 2, 120, None, None, torch.bfloat16),
    (1, 200, 328, 8, 2, 120, None, None, torch.bfloat16),
    (1, 256, 256, 4, 1, 120, 64, 30.0, torch.bfloat16),
    (1, 384, 384, 8, 2, 120, 100, 50.0, torch.bfloat16),
    (1, 40, 300, 4, 1, 120, None, None, torch.bfloat16),
    (1, 100, 400, 8, 2, 120, 64, 50.0, torch.bfloat16),
    (1, 256, 256, 4, 4, 256, None, None, torch.bfloat16),
    (2, 256, 256, 4, 4, 256, None, None, torch.bfloat16),
    (1, 256, 256, 8, 4, 256, None, None, torch.bfloat16),
    (1, 200, 328, 8, 4, 256, None, None, torch.bfloat16),
    (1, 256, 256, 4, 2, 256, 64, 30.0, torch.bfloat16),
    (1, 384, 384, 8, 4, 256, 100, 50.0, torch.bfloat16),
    (1, 40, 300, 4, 2, 256, None, None, torch.bfloat16),
    (1, 100, 400, 8, 4, 256, 64, 50.0, torch.bfloat16),
    # head dim 80 (zamba2-2.7b's shared block, 2560 / 32), whose backward
    # came last: the D-120 rows at D 80 (MHA, GQA 4:1 and 2:1)
    (1, 256, 256, 4, 4, 80, None, None, torch.bfloat16),
    (2, 256, 256, 4, 4, 80, None, None, torch.bfloat16),
    (1, 256, 256, 8, 2, 80, None, None, torch.bfloat16),
    (1, 200, 328, 8, 4, 80, None, None, torch.bfloat16),
    (1, 256, 256, 4, 1, 80, 64, 30.0, torch.bfloat16),
    (1, 384, 384, 8, 2, 80, 100, 50.0, torch.bfloat16),
    (1, 40, 300, 4, 1, 80, None, None, torch.bfloat16),
    (1, 100, 400, 8, 4, 80, 64, 50.0, torch.bfloat16),
]
# The two models' serving prefills (4 x 8192, each model's context, past
# its window of 4096): gemma2-2b's global layers (no window) and local
# layers (window 4096), both soft-capped at 50; h2o-danube-3-4b's layers,
# all windowed.
GEMMA_GLOBAL_PREFILL = (4, 8192, 8192, 8, 4, 256, None, 50.0, torch.bfloat16)
GEMMA_LOCAL_PREFILL = (4, 8192, 8192, 8, 4, 256, 4096, 50.0, torch.bfloat16)
DANUBE_PREFILL = (4, 8192, 8192, 32, 8, 120, 4096, None, torch.bfloat16)

# (B, L, H, P, G, N, chunk, dtype, with_state): the rows of
# tests/test_kernels.py::SSD_SWEEP (no initial state, as the TPU kernel),
# then ragged L the TPU kernel refused and an initial state in, then the
# serving prefill shape of mamba2-130m. Every row checks the final state.
SSD_SWEEP = [
    (1, 64, 2, 16, 1, 16, 16, torch.bfloat16, False),
    (2, 128, 4, 16, 2, 32, 32, torch.bfloat16, False),
    (1, 128, 4, 64, 1, 64, 64, torch.bfloat16, False),
    (1, 256, 8, 32, 1, 16, 128, torch.bfloat16, False),
    (2, 128, 4, 16, 4, 32, 32, torch.bfloat16, False),
    (1, 128, 4, 16, 2, 32, 32, torch.bfloat16, False),
    (1, 1000, 4, 64, 1, 128, 256, torch.bfloat16, True),
    (2, 100, 4, 16, 2, 32, 64, torch.bfloat16, True),
    (2, 512, 8, 64, 1, 128, 256, torch.bfloat16, True),
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


KERNEL_NAMES = ("flash_fwd_wgmma", "flash_bwd_preprocess",
                "flash_bwd_dkdv_wgmma", "flash_bwd_dkdv_split_wgmma",
                "flash_bwd_dq_wgmma", "ssd_chunk_state", "ssd_state_pass",
                "ssd_chunk_output", "ssd_bwd_tc_query", "ssd_bwd_tc_key",
                "ssd_bwd_chunk", "ssd_bwd_group_sum", "ssd_bwd_head_sum",
                "adamw_norm_partials", "adamw_norm_total",
                "adamw_update_pass", "causal_conv_silu_fwd",
                "causal_conv_silu_bwd", "causal_conv_dw_sum")


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
    flash forward kernel (D 32, 64, 80, 120, 128, 224 and 256), no wgmma
    kernel of the flash backward (its two passes at D 32, 64, 80, 120,
    128, 224 and 256), no kernel of the SSD backward, the fused AdamW or
    the conv spills. Returns each kernel record's SASS counts."""
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.adamw import kernel as adamw
    from repro_torch.kernels.conv import kernel as conv
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.ssd import kernel as ssd

    def timed(source):
        t0 = time.perf_counter()
        lib = cuda_build.build(source)
        return lib, time.perf_counter() - t0

    t0 = time.perf_counter()
    sources = (flash.SOURCE, flash.BWD_SOURCE, ssd.SOURCE, ssd.BWD_SOURCE,
               adamw.SOURCE, conv.SOURCE)
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
        f"flash_fwd_wgmma<{d}>" for d in (32, 64, 80, 120, 128, 224, 256)), fwd
    assert not any(spilled(s) for _, s in fwd), fwd
    bwd_log = built[1][0].with_suffix(".log")
    spills = [(label, spill) for label, _, spill in ptxas_kernels(bwd_log)
              if label.startswith(("flash_bwd_dkdv_wgmma", "flash_bwd_dq_wgmma",
                                   "flash_bwd_dkdv_split_wgmma"))]
    # two passes at D 32, 64, 80, 120, 128, 224 and 256 (the dK/dV pass's
    # split kernel at 224 and 256)
    assert sorted(label for label, _ in spills) == sorted(
        [f"flash_bwd_dq_wgmma<{d}>" for d in (32, 64, 80, 120, 128, 224, 256)]
        + [f"flash_bwd_dkdv_wgmma<{d}>" for d in (32, 64, 80, 120, 128)]
        + [f"flash_bwd_dkdv_split_wgmma<{d}>" for d in (224, 256)]), spills
    assert not any(spilled(s) for _, s in spills), spills
    # every kernel of the SSD backward: four templated tensor-core kernels
    # (the two chunk-state modes, query, key) at each of the 16 (P, N), the
    # two recurrences, the chunk pass, the group sum and the head sum
    ssd_bwd_log = built[3][0].with_suffix(".log")
    spills = [(label, spill) for label, _, spill in ptxas_kernels(ssd_bwd_log)]
    assert len(spills) == 4 * 16 + 5, [label for label, _ in spills]
    assert not any(spilled(s) for _, s in spills), [
        (label, s) for label, s in spills if spilled(s)]
    # the fused AdamW: both passes at each gradient dtype, and the sum
    adamw_kernels = list(ptxas_kernels(built[4][0].with_suffix(".log")))
    assert sorted(label for label, _, _ in adamw_kernels) == sorted(
        [f"{name}<{dt}>" for name in ("adamw_norm_partials",
                                      "adamw_update_pass")
         for dt in ("", "bf16")] + ["adamw_norm_total<>"]), adamw_kernels
    assert not any(spilled(s) for _, _, s in adamw_kernels), adamw_kernels
    # the conv: both passes (K 4), and dw's sum
    conv_kernels = list(ptxas_kernels(built[5][0].with_suffix(".log")))
    assert sorted(label for label, _, _ in conv_kernels) == sorted(
        ["causal_conv_silu_fwd<bf16,4>", "causal_conv_silu_bwd<bf16,4>",
         "causal_conv_dw_sum<bf16>"]), conv_kernels
    assert not any(spilled(s) for _, _, s in conv_kernels), conv_kernels
    adamw.library()
    conv.library()
    flash.library()
    flash.backward_library()
    ssd.library()
    ssd.backward_library()
    counts = {name: sass_counts(lib) for name, (lib, _) in
              zip(("flash_attention_fwd", "flash_attention_bwd", "ssd_fwd",
                   "ssd_bwd"), built[:4])}
    for name, c in counts.items():
        print(f"[sass] {name}: " + ", ".join(f"{op} {n}" for op, n in c.items()))
    f, b, s, sb = (counts[name] for name in (
        "flash_attention_fwd", "flash_attention_bwd", "ssd_fwd", "ssd_bwd"))
    assert f["HGMMA"] > 0 and f["UTMALDG"] > 0 and f["HMMA"] == 0, f
    assert b["HGMMA"] > 0 and b["UTMALDG"] > 0 and b["HMMA"] == 0, b
    assert s["HMMA"] > 0, s
    assert sb["HMMA"] > 0, sb
    return counts


# The plain version makes fp32 score tensors of B·H·S·T·4 bytes, several
# at once, and autograd saves more: plain_split runs it on pieces whose
# score tensor stays within this many bytes.
PLAIN_SCORE_BYTES = 2 ** 31


def plain_pieces(q, k) -> str:
    """How plain_split cuts (B, S, H, D) queries and (B, T, K, D) keys, in
    words for the output."""
    b, s, h, _ = q.shape
    t = k.shape[1]
    if b * h * s * t * 4 <= PLAIN_SCORE_BYTES:
        return ""
    if h * s * t * 4 <= PLAIN_SCORE_BYTES:
        return " (one request at a time)"
    return " (one KV group of one request at a time)"


def plain_split(fn, q, k, v, *extra, cat, **kw):
    """``fn`` (a plain version) on pieces of its inputs whose fp32 score
    tensor fits PLAIN_SCORE_BYTES, the outputs joined: the whole batch, else
    each request (batch row) in turn, else, within a request, each KV head
    with the query heads that read it. The same function on the same
    inputs, since attention is independent across requests and KV groups
    (zamba2-2.7b's prefill scores alone take 17 GB, one request of
    h2o-danube-3-4b's at 8192 tokens 8.6 GB). ``extra`` tensors are cut
    along their head dim, 2 for (B, S, H, D) and 1 for an LSE (B, H, S);
    ``cat`` names each output's head dim likewise."""
    b, s, h, _ = q.shape
    t, nk = k.shape[1], k.shape[2]
    if b * h * s * t * 4 <= PLAIN_SCORE_BYTES:
        return fn(q, k, v, *extra, **kw)
    if b > 1:
        parts = [plain_split(fn, *(x[i:i + 1] for x in (q, k, v, *extra)),
                             cat=cat, **kw) for i in range(b)]
        dims = [0] * len(cat)
    else:
        g, parts, dims = h // nk, [], cat
        for j in range(nk):
            hs, ks = slice(j * g, (j + 1) * g), slice(j, j + 1)
            cut = [x[:, :, hs] if x.dim() == 4 else x[:, hs] for x in extra]
            parts.append(fn(*(x.contiguous() for x in (
                q[:, :, hs], k[:, :, ks], v[:, :, ks], *cut)), **kw))
    parts = [p if isinstance(p, tuple) else (p,) for p in parts]
    joined = tuple(torch.cat(ps, dim=dim) for ps, dim in zip(zip(*parts), dims))
    return joined if len(joined) > 1 else joined[0]


# row_rel_err holds a row far below the typical row's size against this
# share of the rms row size instead: a causal first query's dq is zero in
# exact arithmetic and rounding noise in each computation of it.
ROW_FLOOR = 0.05


def row_rel_err(got, want) -> float:
    """Largest over rows (vectors along the last dim: one query's output,
    or one token's gradient, at one head) of ||got - want|| / ||want||,
    ||want|| at least ROW_FLOOR of its rms over the rows. An output row
    averages V over up to 8192 keys, so its values are about sqrt(e / n)
    (0.018 at 8192), as small as TOL[bf16] on the raw difference; this
    holds each row's error to that row's own size."""
    got, want = got.float(), want.float()
    size = want.norm(dim=-1)
    floor = ROW_FLOOR * size.square().mean().sqrt()
    num = (got - want).norm(dim=-1)
    return (num / torch.maximum(size, floor).clamp_min(1e-30)).max().item()


def scale_note(want) -> dict:
    """The size of a reference: its rms and median |value|."""
    w = want.float()
    return dict(ref_rms=w.square().mean().sqrt().item(),
                ref_median_abs=w.abs().median().item())


def planted_faults(got, want, limit, raw) -> dict:
    """row_rel_err of two planted faults, each of which must exceed
    ``limit``: ``got`` with its columns D/2 and up zeroed (what a kernel
    that dropped the product over V's second half of columns writes), and
    ``got`` off by half the raw limit ``raw`` at every element (which an
    elementwise check at ``raw`` lets through)."""
    d = got.shape[-1]
    dropped = got.float().clone()
    dropped[..., d // 2:] = 0
    found = {"columns D/2 and up zeroed": row_rel_err(dropped, want),
             "every element off by raw/2": row_rel_err(got.float() + raw / 2,
                                                        want)}
    assert all(r > limit for r in found.values()), found
    return found


def window_mask(s, t, window, device):
    """The (S, T) boolean mask of the aligned-end causal window: True where
    query row r sees key c (c <= r + T - S and c > r + T - S - window)."""
    rows = torch.arange(s, device=device)[:, None] + (t - s)
    cols = torch.arange(t, device=device)[None, :]
    return (cols <= rows) & (cols > rows - window)


def sdpa_yardstick(qt, kt, vt, window):
    """One ``scaled_dot_product_attention`` call on (B, H, S, D) tensors:
    causal, or with a window an explicit boolean mask over all T keys."""
    if window is None:
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    mask = window_mask(qt.shape[2], kt.shape[2], window, qt.device)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)


_FLEX = []


def flex_yardstick(s, t, d, window, softcap, device):
    """``flex_attention`` (compiled) as a function of (B, H, S, D) q, k, v,
    computing the kernel's function where SDPA cannot: the soft-cap as its
    score_mod, the aligned-end causal window as a BlockMask (whose blocks
    no query sees it skips, as the kernel does), GQA by ``enable_gqa``,
    scale D^-1/2. A yardstick only: the port never calls it."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    if not _FLEX:
        from repro_torch.kernels.cuda_build import BUILD_DIR

        # the compiler's caches in the checkout's build directory; one
        # compile per shape and function, forward and backward
        for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                         ("TRITON_CACHE_DIR", "triton")):
            os.environ.setdefault(var, str(BUILD_DIR / sub))
        torch._dynamo.config.recompile_limit = 64
        _FLEX.append(torch.compile(flex_attention, dynamic=False))

    def visible(b, h, qi, ki):
        seen = ki <= qi + (t - s)
        if window is not None:
            seen = seen & (ki > qi + (t - s) - window)
        return seen

    def capped(score, b, h, qi, ki):
        return softcap * torch.tanh(score / softcap)

    mask = create_block_mask(visible, None, None, s, t, device=device)
    kw = dict(score_mod=capped if softcap else None, block_mask=mask,
              scale=d ** -0.5, enable_gqa=True)
    return lambda q, k, v: _FLEX[0](q, k, v, **kw)


def flash_timing(device, row, inputs) -> dict:
    """Times at one shape: the plain version, then the kernel and one
    PyTorch library call in turns, and the bound from this shape's work.
    The library call is ``scaled_dot_product_attention``; with a window or
    a soft-cap, ``flex_attention`` (flex_yardstick; its output held to the
    kernel's at TOL[bf16] per row), and SDPA is timed in the same turns as
    a side note: without the cap, a different function; with a window, an
    explicit boolean mask, which computes every score."""
    from repro_torch.kernels.flash_attention import kernel, ref
    from repro_torch.kernels.flash_attention.work import attention_work

    b, s, t, h, k, d, window, softcap, dtype = row
    cfg = dict(causal=True, window=window, softcap=softcap)
    q, kk, vv = inputs(99, b, s, t, h, k, d, dtype)
    how = plain_pieces(q, kk)
    plain_ms = statistics.median(time_samples(
        lambda: plain_split(ref.attention_reference, q, kk, vv, cat=(2,),
                            **cfg),
        reps=5 if how else 10, inner=2))
    # The library calls take (B, H, S, D); the layout change is made once,
    # outside the timing.
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kk, vv))
    sdpa = sdpa_yardstick(qt, kt, vt, window)
    run = lambda: kernel.flash_attention(q, kk, vv, **cfg)  # noqa: E731
    flops, nbytes = attention_work(b, s, t, h, k, d, window, dtype)
    t_ops = flops / PEAK_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    shape = (f"B{b} S{s} T{t} H{h} K{k} D{d} {str(dtype)[6:]} causal"
             + (f" window {window}" if window else "")
             + (f" softcap {softcap}" if softcap else ""))
    out = dict(shape=shape, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    if window is None and softcap is None:
        lib_ms, kernel_ms = time_turns(sdpa, run)
        lib_note = (f"sdpa {lib_ms:.4f} ms (in turns: sdpa, kernel, kernel, "
                    f"sdpa), kernel/sdpa {kernel_ms / lib_ms:.3f}")
    else:
        flex = flex_yardstick(s, t, d, window, softcap, device)
        same = row_rel_err(flex(qt, kt, vt).transpose(1, 2), run())
        assert same <= TOL[dtype], (shape, "flex_attention vs kernel", same)
        lib_ms, kernel_ms, sdpa_ms = time_turns(
            lambda: flex(qt, kt, vt), run, sdpa)
        backend = _sdpa_backend(sdpa)
        side = ("without the soft-cap, a different function" if softcap else
                "with a boolean window mask over all T keys")
        lib_note = (f"flex_attention {lib_ms:.4f} ms (compiled; per-row "
                    f"error against the kernel {same:.3e}), kernel/flex "
                    f"{kernel_ms / lib_ms:.3f}; side note: sdpa {side} "
                    f"{sdpa_ms:.4f} ms, kernel/sdpa {kernel_ms / sdpa_ms:.3f} "
                    f"(in turns: flex, kernel, sdpa, sdpa, kernel, flex)")
        print(f"[kernel] sdpa kernels at {shape}: {backend}")
        out.update(library="flex_attention (compiled): score_mod soft-cap, "
                           "BlockMask window, enable_gqa",
                   flex_vs_kernel_row_rel_err=same, sdpa_ms=sdpa_ms,
                   sdpa_note=side, sdpa_backend=backend)
    print(f"[kernel] {shape}: kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms{how}, {lib_note}, bound "
          f"{max(t_ops, t_bytes):.4f} ms ({flops / 1e9:.2f} GFLOP is "
          f"{t_ops:.4f} ms, {nbytes / 1e6:.1f} MB is {t_bytes:.4f} ms)")
    out.update(ms=kernel_ms, library_ms=lib_ms)
    return out


def kernel_phase(device: torch.device) -> dict:
    from repro_torch.kernels.flash_attention import kernel, ref

    def inputs(i, b, s, t, h, k, d, dtype):
        gen = torch.Generator(device=device).manual_seed(1000 + i)
        mk = lambda *shape: torch.randn(  # noqa: E731
            shape, generator=gen, device=device).to(dtype)
        return mk(b, s, h, d), mk(b, t, k, d), mk(b, t, k, d)

    errs = {}
    rows = (SWEEP + SWEEP_D80 + [PREFILL, ZAMBA_PREFILL, GRANITE_PREFILL]
            + NEW_HEADS + [MUSICGEN_PREFILL, STARCODER_PREFILL, QWEN_PREFILL]
            + NEW_DIMS + [GEMMA_GLOBAL_PREFILL, GEMMA_LOCAL_PREFILL,
                          DANUBE_PREFILL])
    for i, row in enumerate(rows):
        b, s, t, h, k, d, window, softcap, dtype = row
        q, kk, vv = inputs(i, b, s, t, h, k, d, dtype)
        out = kernel.flash_attention(q, kk, vv, causal=True, window=window,
                                     softcap=softcap)
        out2, lse = kernel.flash_attention(q, kk, vv, causal=True,
                                           window=window, softcap=softcap,
                                           return_lse=True)
        cfg = dict(causal=True, window=window, softcap=softcap)
        want, lse_want = plain_split(ref.attention_reference_lse, q, kk, vv,
                                     cat=(2, 1), **cfg)
        lse_want = lse_want.contiguous()
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        rel = row_rel_err(out, want)
        lse_err = (lse - lse_want).abs().max().item()
        scale = scale_note(want)
        print(f"[kernel] B{b} S{s} T{t} H{h} K{k} D{d} window={window} "
              f"softcap={softcap} {str(dtype)[6:]}: max_abs_err={err:.3e} "
              f"tol={TOL[dtype]}; per-row error {rel:.3e} tol={TOL[dtype]} "
              f"(reference rms {scale['ref_rms']:.3e}, median |o| "
              f"{scale['ref_median_abs']:.3e}); lse max_abs_err="
              f"{lse_err:.3e} tol={TOL[torch.float32]}")
        torch.testing.assert_close(out.float(), want.float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])
        assert rel <= TOL[dtype], (row, rel)
        # asking for the LSE leaves the output as it was
        assert torch.equal(out, out2)
        torch.testing.assert_close(lse, lse_want, rtol=TOL[torch.float32],
                                   atol=TOL[torch.float32])
        errs[row] = dict(max_abs_err=err, row_rel_err=rel, **scale)
        if t >= 4096:
            # where |o| is as small as the raw limit, the per-row check is
            # the one that sees a fault
            found = planted_faults(out, want, TOL[dtype], TOL[dtype])
            errs[row]["planted_faults_row_rel_err"] = found
            print(f"[kernel] planted faults, per-row error: " + ", ".join(
                f"{name} {r:.3e}" for name, r in found.items()))
        del q, kk, vv, out, out2, lse, want, lse_want

    llama = flash_timing(device, PREFILL, inputs)
    zamba = flash_timing(device, ZAMBA_PREFILL, inputs)
    granite = flash_timing(device, GRANITE_PREFILL, inputs)
    new = {key: {**flash_timing(device, row, inputs), **errs[row]}
           for key, row in (("musicgen_prefill_shape", MUSICGEN_PREFILL),
                            ("starcoder2_prefill_shape", STARCODER_PREFILL),
                            ("qwen2_vl_prefill_shape", QWEN_PREFILL),
                            ("gemma2_prefill_global_shape",
                             GEMMA_GLOBAL_PREFILL),
                            ("gemma2_prefill_local_shape",
                             GEMMA_LOCAL_PREFILL),
                            ("danube_prefill_shape", DANUBE_PREFILL))}
    return {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:31",
        "replaces_fn": "_flash_kernel",
        "launches": None,
        "launches_on_path": None,
        "max_abs_err": errs[PREFILL]["max_abs_err"],
        "row_rel_err": errs[PREFILL]["row_rel_err"],
        "tol": TOL[PREFILL[-1]],
        "ms": llama["ms"],
        "kernel_ms": llama["ms"],
        "plain_ms": llama["plain_ms"],
        "bound_ms": llama["bound_ms"],
        "bound_by": llama["bound_by"],
        "library_ms": llama["library_ms"],
        "shape": llama["shape"],
        "zamba2_prefill_shape": {**zamba, **errs[ZAMBA_PREFILL],
                                 "plain": "one request at a time"},
        "granite_prefill_shape": {**granite, **errs[GRANITE_PREFILL]},
        **new,
        "note": "writes the row log-sum-exp, fp32 (B, H, S), when asked "
                "(training); serving passes a null pointer, as timed here",
    }


# The training shape of llama3.2-3b (global batch 2 x 2048 tokens), where
# the backward runs on the main path.
TRAIN_ATTN = (2, 2048, 2048, 24, 8, 128, None, None, torch.bfloat16)
# ... and of granite-moe-3b-a800m (head dim 64).
GRANITE_TRAIN_ATTN = (2, 2048, 2048, 24, 8, 64, None, None, torch.bfloat16)
# ... and of musicgen-large (MHA, H = K = 32, head dim 64).
MUSICGEN_TRAIN_ATTN = (2, 2048, 2048, 32, 32, 64, None, None, torch.bfloat16)
# ... and of gemma2-2b (global and local layers, soft-cap 50, D 256) and
# h2o-danube-3-4b (window 4096, D 120), 1 x 8192 tokens.
GEMMA_TRAIN_GLOBAL = (1, 8192, 8192, 8, 4, 256, None, 50.0, torch.bfloat16)
GEMMA_TRAIN_LOCAL = (1, 8192, 8192, 8, 4, 256, 4096, 50.0, torch.bfloat16)
DANUBE_TRAIN = (1, 8192, 8192, 32, 8, 120, 4096, None, torch.bfloat16)
# ... and of zamba2-2.7b's shared block (MHA 32, D 80), 2 x 4096 tokens.
ZAMBA_TRAIN_ATTN = (2, 4096, 4096, 32, 32, 80, None, None, torch.bfloat16)


def _sdpa_backend(fn) -> str:
    """Names of the CUDA kernels one call of ``fn`` runs (profiler). A
    session can come back with no device event at all (on the card, now
    and then; the first sessions after TALP's CUPTI collection stayed
    empty through three tries), so up to three are tried and an empty
    string means none saw a kernel."""
    names = set()
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA}
        if names:
            break
    return "; ".join(sorted(n[:80] for n in names))


def backward_phase(device: torch.device) -> dict:
    """The flash backward on every row of SWEEP and at the training shape:
    the forward's output (at TOL[dtype], as in kernel_phase) and LSE (at
    TOL[fp32]) against the plain version's; dq/dk/dv of the kernels
    against ref.attention_backward_reference on the kernels' own inputs
    and against autograd through ref.attention_reference, both evaluated
    in fp32, at TOL[bf16] on each gradient divided by the reference
    gradient's max-abs, and every row per row against the plain backward
    (row_rel_err). A second backward run must be bit-identical. The same
    at head dims 120 and 256 (NEW_DIMS) and at gemma2-2b's and
    h2o-danube-3-4b's training shapes (the plain versions on pieces,
    plain_split). Times (kernel vs the backward of
    scaled_dot_product_attention, in turns) at the training shape, at the
    serving prefill shape, at granite's and musicgen's training shapes
    (head dim 64) and at the two new models' (with a window or a
    soft-cap, flex_attention's backward, and SDPA's as a side note)."""
    from repro_torch.kernels.flash_attention import kernel, ref
    from repro_torch.kernels.flash_attention.work import (
        attention_backward_work)

    def inputs(i, b, s, t, h, k, d, dtype):
        gen = torch.Generator(device=device).manual_seed(3000 + i)
        mk = lambda *shape: torch.randn(  # noqa: E731
            shape, generator=gen, device=device).to(dtype)
        return mk(b, s, h, d), mk(b, t, k, d), mk(b, t, k, d), mk(b, s, h, d)

    def rel_err(got, want, dtype):
        m = want.float().abs().max().clamp_min(1e-30)
        got, want = got.float() / m, want.float() / m
        torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype])
        return (got - want).abs().max().item()

    def autograd_grads(q, k, v, do, **cfg):
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        ref.attention_reference(*leaves, **cfg).backward(do)
        return tuple(x.grad for x in leaves)

    train_errs = {}
    train_rows = (TRAIN_ATTN, GRANITE_TRAIN_ATTN, MUSICGEN_TRAIN_ATTN,
                  GEMMA_TRAIN_GLOBAL, GEMMA_TRAIN_LOCAL, DANUBE_TRAIN,
                  ZAMBA_TRAIN_ATTN)
    rows = (SWEEP + list(train_rows[:2]) + NEW_HEADS + [MUSICGEN_TRAIN_ATTN]
            + NEW_DIMS + list(train_rows[3:]))
    for i, row in enumerate(rows):
        b, s, t, h, k, d, window, softcap, dtype = row
        cfg = dict(causal=True, window=window, softcap=softcap)
        q, kk, vv, do = inputs(i, b, s, t, h, k, d, dtype)
        o, lse = kernel.flash_attention(q, kk, vv, return_lse=True, **cfg)
        got = kernel.flash_attention_backward(q, kk, vv, o, lse, do, **cfg)
        again = kernel.flash_attention_backward(q, kk, vv, o, lse, do, **cfg)
        up = [x.float() for x in (q, kk, vv, o, do)]
        o_want, lse_want = plain_split(ref.attention_reference_lse, q, kk, vv,
                                       cat=(2, 1), **cfg)
        plain = plain_split(ref.attention_backward_reference, *up[:4], lse,
                            up[4], cat=(2, 2, 2), **cfg)
        grads = plain_split(autograd_grads, *up[:3], up[4], cat=(2, 2, 2),
                            **cfg)
        torch.cuda.synchronize()
        o_err = (o.float() - o_want.float()).abs().max().item()
        lse_err = (lse - lse_want).abs().max().item()
        torch.testing.assert_close(o.float(), o_want.float(), rtol=TOL[dtype],
                                   atol=TOL[dtype])
        torch.testing.assert_close(lse, lse_want, rtol=TOL[torch.float32],
                                   atol=TOL[torch.float32])
        errs = [rel_err(g, w, dtype) for g, w in zip(got, plain)]
        errs_ag = [rel_err(g, w, dtype) for g, w in zip(got, grads)]
        # each gradient row (one token at one head) against its own size
        # (late keys' dK and dV rows are far below the largest gradient),
        # against the plain backward, which takes the kernel's bf16 o into
        # Delta as the kernel does (autograd's fp32 o differs there by o's
        # rounding, which early queries' dq rows magnify)
        rows_err = [row_rel_err(g, w) for g, w in zip(got, plain)]
        assert max(rows_err) <= TOL[dtype], (row, rows_err)
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        assert same, "two backward runs differ"
        print(f"[backward] B{b} S{s} T{t} H{h} K{k} D{d} window={window} "
              f"softcap={softcap} {str(dtype)[6:]}: dq/dk/dv max_abs_err / "
              f"max|ref| vs plain "
              f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}, vs autograd "
              f"{errs_ag[0]:.3e}/{errs_ag[1]:.3e}/{errs_ag[2]:.3e} "
              f"(tol {TOL[dtype]}); per-row error vs plain {rows_err[0]:.3e}/"
              f"{rows_err[1]:.3e}/{rows_err[2]:.3e} (tol {TOL[dtype]}); "
              f"forward o max_abs_err {o_err:.3e} (tol {TOL[dtype]}), per-row "
              f"{row_rel_err(o, o_want):.3e}, lse {lse_err:.3e} (tol "
              f"{TOL[torch.float32]}); rerun bit-identical")
        if row in train_rows:
            scales = [scale_note(w) for w in plain]
            train_errs[row] = dict(
                max_abs_err=max(errs + errs_ag), row_rel_err=max(rows_err),
                forward_o_max_abs_err=o_err,
                ref_rms=[x["ref_rms"] for x in scales],
                ref_median_abs=[x["ref_median_abs"] for x in scales],
                ref_max_abs=[w.abs().max().item() for w in plain])
            print(f"[backward] dq/dk/dv reference rms " + "/".join(
                f"{x:.3e}" for x in train_errs[row]["ref_rms"])
                + ", median |.| " + "/".join(
                f"{x:.3e}" for x in train_errs[row]["ref_median_abs"])
                + ", max |.| " + "/".join(
                f"{x:.3e}" for x in train_errs[row]["ref_max_abs"]))
            if t >= 4096:
                found = {f"{name} {key}": r for name, g, w in zip(
                    ("dq", "dk", "dv"), got, plain)
                    for key, r in planted_faults(
                        g, w, TOL[dtype],
                        TOL[dtype] * w.abs().max().item()).items()}
                train_errs[row]["planted_faults_row_rel_err"] = found
                print(f"[backward] planted faults, per-row error: "
                      + ", ".join(f"{n} {r:.3e}" for n, r in found.items()))
        del q, kk, vv, do, o, o_want, lse, got, again, plain, up, grads

    timings = {}
    for label, row in (("train", TRAIN_ATTN), ("prefill", PREFILL),
                       ("granite train", GRANITE_TRAIN_ATTN),
                       ("musicgen train", MUSICGEN_TRAIN_ATTN),
                       ("gemma2 train global", GEMMA_TRAIN_GLOBAL),
                       ("gemma2 train local", GEMMA_TRAIN_LOCAL),
                       ("danube train", DANUBE_TRAIN),
                       ("zamba2 train", ZAMBA_TRAIN_ATTN)):
        b, s, t, h, k, d, window, softcap, dtype = row
        cfg = dict(causal=True, window=window, softcap=softcap)
        q, kk, vv, do = inputs(99, b, s, t, h, k, d, dtype)
        o, lse = kernel.flash_attention(q, kk, vv, return_lse=True, **cfg)
        plain_ms = statistics.median(time_samples(
            lambda: plain_split(ref.attention_backward_reference, q, kk, vv,
                                o, lse, do, cat=(2, 2, 2), **cfg),
            reps=5, warmup=1, inner=1))
        # the library yardstick: SDPA's backward on its own graph, (B, H,
        # S, D) layout made once outside the timing; with a window or a
        # soft-cap, flex_attention's, and SDPA's as a side note (with a
        # window, an explicit boolean mask; without the cap)
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, kk, vv))
        dot = do.transpose(1, 2).contiguous()
        mask = None if window is None else window_mask(s, t, window, device)

        def forward(kt, vt):
            if mask is None:
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)

        gqa_note = "enable_gqa"
        out = forward(kt, vt)
        sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
            out, (qt, kt, vt), dot, retain_graph=True)
        backend = _sdpa_backend(sdpa_bwd)
        if not re.search("flash|cudnn|fmha", backend, re.I):
            # enable_gqa left the fused kernels: K/V expanded to H heads
            kt, vt = (x.detach().repeat_interleave(h // k, dim=1)
                      .requires_grad_() for x in (kt, vt))
            out = forward(kt, vt)
            backend = _sdpa_backend(sdpa_bwd)
            gqa_note = "K/V expanded to H heads (enable_gqa ran no fused kernel)"
        if mask is not None:
            gqa_note += ", boolean window mask"
        run = lambda: kernel.flash_attention_backward(  # noqa: E731
            q, kk, vv, o, lse, do, **cfg)
        flops, nbytes = attention_backward_work(b, s, t, h, k, d, window,
                                                dtype)
        t_ops = flops / PEAK_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        timings[label] = dict(plain_ms=plain_ms, bound_ms=bound,
                              bound_by="operations" if t_ops >= t_bytes
                              else "bytes")
        if window is None and softcap is None:
            lib_ms, kernel_ms = time_turns(sdpa_bwd, run)
            lib = (f"sdpa backward {lib_ms:.4f} ms ({gqa_note}; in turns: "
                   f"sdpa, kernel, kernel, sdpa), kernel/sdpa "
                   f"{kernel_ms / lib_ms:.3f}")
            timings[label]["library_note"] = gqa_note
        else:
            flex = flex_yardstick(s, t, d, window, softcap, device)
            qf, kf, vf = (x.detach().transpose(1, 2).contiguous()
                          .requires_grad_() for x in (q, kk, vv))
            outf = flex(qf, kf, vf)
            same = row_rel_err(outf.transpose(1, 2), o)
            assert same <= TOL[dtype], (label, "flex_attention vs kernel",
                                        same)
            flex_bwd = lambda: torch.autograd.grad(  # noqa: E731
                outf, (qf, kf, vf), dot, retain_graph=True)
            grads_diff = [row_rel_err(g.transpose(1, 2), w) for g, w in zip(
                flex_bwd(), run())]
            lib_ms, kernel_ms, sdpa_ms = time_turns(flex_bwd, run, sdpa_bwd)
            side = ("sdpa backward without the soft-cap, a different "
                    f"function ({gqa_note})" if softcap else
                    f"sdpa backward ({gqa_note}), which computes every score")
            lib = (f"flex_attention backward {lib_ms:.4f} ms (compiled; its "
                   f"forward's per-row error against the kernel {same:.3e}, "
                   f"dq/dk/dv per-row difference "
                   + "/".join(f"{x:.3e}" for x in grads_diff)
                   + f"), kernel/flex {kernel_ms / lib_ms:.3f}; side note: "
                   f"{side} {sdpa_ms:.4f} ms, kernel/sdpa "
                   f"{kernel_ms / sdpa_ms:.3f} (in turns: flex, kernel, sdpa, "
                   f"sdpa, kernel, flex)")
            timings[label].update(
                library_note="flex_attention backward (compiled): score_mod "
                             "soft-cap, BlockMask window, enable_gqa",
                flex_vs_kernel_row_rel_err=same,
                flex_vs_kernel_grads_row_rel_diff=grads_diff,
                sdpa_ms=sdpa_ms, sdpa_note=side)
            del qf, kf, vf, outf
        timings[label].update(ms=kernel_ms, library_ms=lib_ms)
        print(f"[backward] {label} shape B{b} S{s} H{h} K{k} D{d}"
              f"{f' window {window}' if window else ''}"
              f"{f' softcap {softcap}' if softcap else ''}: kernel "
              f"{kernel_ms:.4f} ms (3 launches), plain {plain_ms:.4f} ms"
              f"{plain_pieces(q, kk)}, {lib}, bound {bound:.4f} ms "
              f"({flops / 1e9:.2f} GFLOP is {t_ops:.4f} ms, {nbytes / 1e6:.1f}"
              f" MB is {t_bytes:.4f} ms), kernel/bound {kernel_ms / bound:.2f}")
        print(f"[backward] sdpa backward kernels: {backend}")
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
        **train_errs[TRAIN_ATTN],
        "tol": TOL[torch.bfloat16],
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
        **{key: {**timings[label], **train_errs[row], "shape": shape}
           for key, label, row, shape in (
               ("granite_train_shape", "granite train", GRANITE_TRAIN_ATTN,
                "B2 S2048 T2048 H24 K8 D64 bf16 causal"),
               ("musicgen_train_shape", "musicgen train", MUSICGEN_TRAIN_ATTN,
                "B2 S2048 T2048 H32 K32 D64 bf16 causal"),
               ("gemma2_train_global_shape", "gemma2 train global",
                GEMMA_TRAIN_GLOBAL,
                "B1 S8192 T8192 H8 K4 D256 bf16 causal softcap 50"),
               ("gemma2_train_local_shape", "gemma2 train local",
                GEMMA_TRAIN_LOCAL,
                "B1 S8192 T8192 H8 K4 D256 bf16 causal window 4096 "
                "softcap 50"),
               ("danube_train_shape", "danube train", DANUBE_TRAIN,
                "B1 S8192 T8192 H32 K8 D120 bf16 causal window 4096"),
               ("zamba2_train_shape", "zamba2 train", ZAMBA_TRAIN_ATTN,
                "B2 S4096 T4096 H32 K32 D80 bf16 causal (D-128 tiles over "
                "TMA's zero columns 80-127)"))},
    }


def ssd_kernel_phase(device: torch.device) -> dict:
    from repro_torch.kernels.ssd import kernel, ref
    from repro_torch.kernels.ssd.work import ssd_work

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
        t_ops = flops / PEAK_FLOPS * 1e3
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
# ... and of zamba2-2.7b's SSD layers (2 x 4096 tokens, H 80, N 64).
ZAMBA_SSD_TRAIN = (2, 4096, 80, 64, 1, 64, 256, torch.bfloat16, False)
# ... and of zamba2-7b's Mamba-2 layers: 112 heads of 64, two groups of B
# and C, state 64 (2 x 4096 tokens)
ZAMBA7_SSD_TRAIN = (2, 4096, 112, 64, 2, 64, 256, torch.bfloat16, False)


def ssd_backward_phase(device: torch.device) -> dict:
    """The SSD backward on every row of SSD_SWEEP and at the training shape
    (see the module docstring), then its timing at the training shape."""
    from repro_torch.kernels.ssd import kernel, ref
    from repro_torch.kernels.ssd.work import ssd_backward_work

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
        m = want.double().abs().max().clamp_min(1e-30)
        got, want = got.double() / m, want.double() / m
        torch.testing.assert_close(got, want, rtol=TOL[dtype],
                                   atol=TOL[dtype])
        return (got - want).abs().max().item()

    train_err = {}
    for i, row in enumerate(SSD_SWEEP + [SSD_TRAIN, SSD_P128,
                                         ZAMBA_SSD_TRAIN, ZAMBA7_SSD_TRAIN]):
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
        print(f"[ssd-backward] B{b} L{l} H{h} P{p} G{g} N{n} chunk={chunk} "
              f"{str(dtype)[6:]} state={with_state}: max_abs_err / max|ref| "
              "vs float64 "
              "autograd " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (tol {TOL[dtype]}); rerun bit-identical")
        if row in (SSD_TRAIN, ZAMBA_SSD_TRAIN):
            train_err[row] = max(errs.values())
        del x, dt, a, bm, cm, d, s0, dy, dfin, got, again, want

    def timing(row):
        """The plain backward and the kernel in turns at a training shape,
        beside its bound."""
        b, l, h, p, g, n, chunk, dtype, with_state = row
        x, dt, a, bm, cm, d, _, dy, _ = inputs(99, *row[:6], dtype, False)
        leaves = [t.clone().requires_grad_() for t in (x, dt, a, bm, cm, d)]
        y = ref.ssd_reference(*leaves[:5], chunk=chunk, d_skip=leaves[5])
        plain = lambda: torch.autograd.grad(  # noqa: E731
            y, leaves, dy, retain_graph=True)
        plain_ms, kernel_ms = time_turns(
            plain,
            lambda: kernel.ssd_scan_backward(x, dt, a, bm, cm, dy, chunk, d),
            reps=3, inner=2)
        del leaves, y
        flops, nbytes = ssd_backward_work(*row)
        t_ops = flops / PEAK_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        shape = (f"B{b} L{l} H{h} P{p} G{g} N{n} chunk{chunk} "
                 f"{str(dtype)[6:]}, no state")
        print(f"[ssd-backward] {shape}: kernel {kernel_ms:.4f} ms (10 "
              f"launches, bf16 products on the tensor cores), plain backward "
              f"{plain_ms:.4f} ms (autograd through the plain version in "
              f"fp32); in turns: plain, kernel, kernel, plain; no library "
              f"call, bound {bound:.4f} ms ({flops / 1e9:.2f} GFLOP is "
              f"{t_ops:.4f} ms at the bf16 rate, {nbytes / 1e6:.1f} MB is "
              f"{t_bytes:.4f} ms), kernel/bound {kernel_ms / bound:.2f}")
        return (x, dt, a, bm, cm, d, dy), dict(
            ms=kernel_ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
            bound_ms=bound,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=None, max_abs_err=train_err[row], shape=shape)

    zamba = timing(ZAMBA_SSD_TRAIN)[1]
    (x, dt, a, bm, cm, d, dy), mamba = timing(SSD_TRAIN)
    chunk, dtype = SSD_TRAIN[6], SSD_TRAIN[7]
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
        **mamba,
        "tol": TOL[dtype],
        "library": "none: no single PyTorch call computes the scan's "
                   "backward",
        "passes_ms": {_trace_label(e.key): dev_time(e) * 1e-3 / reps
                      for e in passes},
        "shape": mamba["shape"] + " (ten launches, bf16 mma.sync on the "
                                  "tensor cores, fp32 operands split hi + lo)",
        "zamba2_train_shape": zamba,
    }


# mamba2-2.7b (state-spaces/mamba2-2.7b) at its published widths, as the
# benchmark's training cell runs it: the program's mamba2-130m at 64
# layers of 2560 and a vocabulary of 50277 (17 leaves, 2.83 B parameters).
ADAMW_TREE = dict(name="mamba2-2.7b", num_layers=64, d_model=2560,
                  vocab_size=50277)
# The check's steps, its first step count (past the cell's 10 warmup
# steps) and its gradients' norm (above grad_clip: the clip is on).
ADAMW_CHECK = dict(steps=3, count=20, grad_norm=1.5)
# The fused steps' error on a leaf may reach this share of the largest
# element of the plain steps' change to the leaf, plus 4 eps of the value
# (a few roundings of the value itself).
ADAMW_CHANGE_TOL = 1e-3
ADAMW_SLICE = 2 ** 26   # elements of a leaf checked at a time


# Head dim 224 (zamba2-7b's shared blocks: 7168 / 32 heads, MHA; the D-256
# tiles over TMA's zero columns 224-255) with Zamba-2's softmax scale
# (D/2)^-1/2, forward and backward: the D-256 rows of NEW_DIMS at D 224
# (MHA, GQA 2:1, S and T off the tile grid, a window with a soft-cap, S
# below one query tile), then the model's training shape, 2 x 4096.
ZAMBA7_SCALE = (224 / 2) ** -0.5
D224_ROWS = [
    (1, 256, 256, 4, 4, 224, None, None, torch.bfloat16),
    (2, 256, 256, 8, 4, 224, None, None, torch.bfloat16),
    (1, 200, 328, 8, 4, 224, None, None, torch.bfloat16),
    (1, 384, 384, 8, 4, 224, 100, 50.0, torch.bfloat16),
    (1, 40, 300, 4, 2, 224, None, None, torch.bfloat16),
]
ZAMBA7_TRAIN_ATTN = (2, 4096, 4096, 32, 32, 224, None, None, torch.bfloat16)


def zamba7_phase(device: torch.device) -> dict:
    """zamba2-7b's kernels: both flash kernels at head dim 224 with the
    scale (D/2)^-1/2 on D224_ROWS and at the training shape, the output
    per row against the plain version at TOL[dtype] and the LSE at
    TOL[fp32], dq, dk and dv per row against the plain backward at
    TOL[dtype] (the plain versions on pieces, plain_split), a second
    backward bit-identical; kernel, plain and SDPA (cuDNN, given the same
    scale) timed at the training shape, the library in turns with the
    kernel. Then the SSD forward at H 112, G 2, N 64 against the plain
    version in float64 per row, and both SSD kernels timed at the training
    shape (ssd_backward_phase holds the backward to float64 autograd at
    ZAMBA7_SSD_TRAIN)."""
    from repro_torch.kernels.flash_attention import kernel, ref
    from repro_torch.kernels.flash_attention.work import (
        attention_backward_work, attention_work)
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.ssd import ref as ssd_ref
    from repro_torch.kernels.ssd.work import ssd_backward_work, ssd_work

    scale = ZAMBA7_SCALE

    def bound_ms(work):
        return max(work[0] / PEAK_FLOPS, work[1] / PEAK_BYTES) * 1e3

    out = {}
    for i, row in enumerate(D224_ROWS + [ZAMBA7_TRAIN_ATTN]):
        b, s, t, h, k, d, window, softcap, dtype = row
        cfg = dict(causal=True, window=window, softcap=softcap, scale=scale)
        gen = torch.Generator(device=device).manual_seed(7000 + i)
        q, kk, vv, do = (torch.randn(shape, generator=gen,
                                     device=device).to(dtype)
                         for shape in ((b, s, h, d), (b, t, k, d),
                                       (b, t, k, d), (b, s, h, d)))
        o, lse = kernel.flash_attention(q, kk, vv, return_lse=True, **cfg)
        got = kernel.flash_attention_backward(q, kk, vv, o, lse, do, **cfg)
        again = kernel.flash_attention_backward(q, kk, vv, o, lse, do, **cfg)
        o_want, lse_want = plain_split(ref.attention_reference_lse, q, kk,
                                       vv, cat=(2, 1), **cfg)
        up = [x.float() for x in (q, kk, vv, o, do)]
        plain = plain_split(ref.attention_backward_reference, *up[:4], lse,
                            up[4], cat=(2, 2, 2), **cfg)
        torch.cuda.synchronize()
        o_err = row_rel_err(o, o_want)
        lse_err = (lse - lse_want.contiguous()).abs().max().item()
        g_err = [row_rel_err(g, w) for g, w in zip(got, plain)]
        shape = (f"B{b} S{s} T{t} H{h} K{k} D{d} {str(dtype)[6:]} causal"
                 + (f" window {window}" if window else "")
                 + (f" softcap {softcap}" if softcap else "")
                 + f" scale (D/2)^-1/2")
        print(f"[zamba7] {shape}: o per-row {o_err:.3e}, lse {lse_err:.3e}, "
              f"dq dk dv per-row " + ", ".join(f"{e:.3e}" for e in g_err)
              + f" (tol {TOL[dtype]}, lse {TOL[torch.float32]})")
        assert o_err <= TOL[dtype] and max(g_err) <= TOL[dtype], (row, o_err,
                                                                   g_err)
        assert lse_err <= TOL[torch.float32], (row, lse_err)
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        del o_want, lse_want, plain, again, up
    # the training shape's times: kernel, plain (one request at a time),
    # cuDNN's SDPA in turns with the kernel
    fw = attention_work(b, s, t, h, k, d, None, dtype)
    bw = attention_backward_work(b, s, t, h, k, d, None, dtype)
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, kk, vv, do))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True, scale=scale)
    run = lambda: kernel.flash_attention(q, kk, vv, scale=scale)  # noqa: E731
    lib_ms, k_ms = time_turns(sdpa, run, reps=10, inner=5)
    plain_ms = statistics.median(time_samples(
        lambda: plain_split(ref.attention_reference, q, kk, vv, cat=(2,),
                            causal=True, scale=scale), reps=3, inner=1))
    leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
    ys = torch.nn.functional.scaled_dot_product_attention(
        *leaves, is_causal=True, scale=scale)
    sdpa_b = lambda: torch.autograd.grad(ys, leaves, dot,  # noqa: E731
                                         retain_graph=True)
    run_b = lambda: kernel.flash_attention_backward(  # noqa: E731
        q, kk, vv, o, lse, do, scale=scale)
    lib_b, k_b = time_turns(sdpa_b, run_b, reps=10, inner=3)
    up = [x.float() for x in (q, kk, vv, o, do)]
    plain_b = statistics.median(time_samples(
        lambda: plain_split(ref.attention_backward_reference, *up[:4], lse,
                            up[4], cat=(2, 2, 2), causal=True, scale=scale),
        reps=3, inner=1))
    out["fwd"] = dict(shape=shape, ms=k_ms, plain_ms=plain_ms,
                      library_ms=lib_ms, bound_ms=bound_ms(fw),
                      gflop=fw[0] / 1e9, row_rel_err=o_err,
                      library="sdpa (cuDNN), the same scale")
    out["bwd"] = dict(shape=shape, ms=k_b, plain_ms=plain_b,
                      library_ms=lib_b, bound_ms=bound_ms(bw),
                      gflop=bw[0] / 1e9, row_rel_err=max(g_err),
                      library="sdpa's backward (cuDNN), the same scale")
    print(f"[zamba7] {shape}: forward kernel {k_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (kernel/sdpa "
          f"{k_ms / lib_ms:.3f}), bound {bound_ms(fw):.4f} ms; backward "
          f"kernel {k_b:.4f} ms, plain {plain_b:.4f} ms, sdpa {lib_b:.4f} ms "
          f"(kernel/sdpa {k_b / lib_b:.3f}), bound {bound_ms(bw):.4f} ms")
    del q, kk, vv, do, o, lse, got, qt, kt, vt, dot, leaves, ys, up

    b, l, h, p, g, n, chunk, dtype, _ = ZAMBA7_SSD_TRAIN
    gen = torch.Generator(device=device).manual_seed(7100)
    rnd = lambda *shape: torch.randn(shape, generator=gen,  # noqa: E731
                                     device=device)
    x = rnd(b, l, h, p).to(dtype)
    dt = torch.nn.functional.softplus(rnd(b, l, h))
    a = -torch.exp(rnd(h) * 0.3)
    bm, cm = rnd(b, l, g, n).to(dtype), rnd(b, l, g, n).to(dtype)
    dsk = torch.full((h,), 0.5, device=device)
    dy = rnd(b, l, h, p).to(dtype)
    y = ssd_kernel.ssd_scan(x, dt, a, bm, cm, chunk=chunk, d_skip=dsk)
    y64 = ssd_ref.ssd_reference(*(t.double() for t in (x, dt, a, bm, cm)),
                                chunk=chunk, d_skip=dsk.double())
    torch.cuda.synchronize()
    y_err = row_rel_err(y, y64)
    del y64
    assert y_err <= TOL[dtype], y_err
    f_ms = statistics.median(time_samples(
        lambda: ssd_kernel.ssd_scan(x, dt, a, bm, cm, chunk=chunk,
                                    d_skip=dsk), reps=10, inner=5))
    b_ms = statistics.median(time_samples(
        lambda: ssd_kernel.ssd_scan_backward(x, dt, a, bm, cm, dy, chunk,
                                             dsk), reps=10, inner=3))
    pf_ms = statistics.median(time_samples(
        lambda: ssd_ref.ssd_reference(x.float(), dt, a, bm.float(),
                                      cm.float(), chunk=chunk, d_skip=dsk),
        reps=3, inner=1))
    sw = ssd_work(b, l, h, p, g, n, chunk, dtype, False)
    sbw = ssd_backward_work(b, l, h, p, g, n, chunk, dtype, False)
    shape = f"B{b} L{l} H{h} P{p} G{g} N{n} chunk {chunk} {str(dtype)[6:]}"
    out["ssd_fwd"] = dict(shape=shape, ms=f_ms, plain_ms=pf_ms,
                          bound_ms=bound_ms(sw), row_rel_err=y_err)
    out["ssd_bwd"] = dict(shape=shape, ms=b_ms, bound_ms=bound_ms(sbw))
    print(f"[zamba7] SSD {shape}: y per-row {y_err:.3e} (tol {TOL[dtype]}); "
          f"forward kernel {f_ms:.4f} ms, plain {pf_ms:.4f} ms, bound "
          f"{bound_ms(sw):.4f} ms; backward kernel {b_ms:.4f} ms, bound "
          f"{bound_ms(sbw):.4f} ms")
    return out


def _like(tree, leaves):
    """A tree shaped like ``tree`` holding the next of ``leaves`` at each
    leaf, in ``_leaves``' order."""
    if isinstance(tree, dict):
        return {k: _like(v, leaves) for k, v in tree.items()}
    return next(leaves)


def adamw_phase(device: torch.device) -> list:
    """The fused AdamW (``kernels.adamw``) on mamba2-2.7b's whole parameter
    tree with bf16 gradients, the benchmark cell's AdamW settings:

    (a) ADAMW_CHECK's steps of ``adamw_update`` (the timed multi-tensor
    pair) past warmup, with gradients of norm 1.5 (the clip on) and
    moments of a clipped gradient's scale, against the plain version's
    arithmetic (``optim.adamw.update_leaf`` with the plain global norm's
    scale) leaf by leaf, each leaf's start made anew from its seed: the
    change to each leaf's p, mu and nu within ADAMW_CHANGE_TOL of the
    plain change's largest element plus 4 eps of the value, and at most a
    hundredth of it; each step's grad norm within 1e-5 of the plain norm.
    The same steps from the same start again give the same bits (the
    first run's result held in host memory).

    (b) On the tree as (a) leaves it, the fused step, the plain one and
    the library route in turns (CUDA events): the library route is
    ``torch._foreach_norm`` and ``torch._fused_adamw_`` on fp32 copies of
    the gradients (its kernel takes no bf16 gradient beside fp32
    masters), the clip as its ``grad_scale`` on the device, first held to
    ``update_leaf`` on three small leaves. Then the norm pass and the
    update pass alone, each beside its bound (its ``work`` bytes at 3.35
    TB/s); the plain global norm alone beside the norm pass; each route's
    peak device memory beyond the state's.

    Returns the kernel table's two records, ``adamw_norm`` and
    ``adamw_update``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.adamw import kernel
    from repro_torch.kernels.adamw.work import (adamw_norm_work,
                                                adamw_update_work)
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                         adamw_update_reference, update_leaf)

    opt = AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=10000)
    cfg = dataclasses.replace(get_config("mamba2-130m"), **ADAMW_TREE)
    steps, count0 = ADAMW_CHECK["steps"], ADAMW_CHECK["count"]
    gen = torch.Generator(device=device).manual_seed(12)
    params = lm.init_params(cfg, gen, device=device)
    names = [name for name, _ in _named_leaves(params)]
    n = lm.param_count(params)
    sigma = 1 / math.sqrt(n)   # an element of a gradient of norm 1
    grads = lm.tree_map(lambda p: torch.randn(
        p.shape, generator=gen, device=device, dtype=torch.bfloat16).mul_(
            ADAMW_CHECK["grad_norm"] * sigma), params)
    p0 = lm.tree_map(torch.clone, params)

    def moments(k, like):
        """Leaf k's moments at the start, from its own seed: mu of a
        clipped gradient's scale, nu of its square's."""
        g = torch.Generator(device=device).manual_seed(1000 + k)
        mu = torch.randn(like.shape, generator=g, device=device).mul_(sigma)
        nu = torch.randn(like.shape, generator=g, device=device).square_()
        return mu, nu.add_(0.5).mul_(sigma * sigma)

    def fused_run():
        for p, q in zip(_leaves(params), _leaves(p0)):
            p.copy_(q)
        start = [moments(k, q) for k, q in enumerate(_leaves(p0))]
        state = {"mu": _like(params, (m for m, _ in start)),
                 "nu": _like(params, (v for _, v in start)),
                 "count": torch.tensor(count0, dtype=torch.int32)}
        del start
        norms = []
        for _ in range(steps):
            _, state, m = adamw_update(opt, params, grads, state)
            norms.append(m["grad_norm"])
        torch.cuda.synchronize()
        return torch.stack(norms), state

    def result(state):
        return [t for tree in (params, state["mu"], state["nu"])
                for t in _leaves(tree)]

    # (a) the check, on the whole tree
    t0 = time.perf_counter()
    norms, state = fused_run()
    first = (norms.cpu(), [t.cpu() for t in result(state)])
    del state
    norms, state = fused_run()
    identical = torch.equal(norms.cpu(), first[0]) and all(
        torch.equal(t.cpu(), h) for t, h in zip(result(state), first[1]))
    del first
    assert identical, "two fused runs of the same steps differ"
    gnorm = adamw._global_norm(grads)
    scale = torch.clamp_max(opt.grad_clip / torch.clamp_min(gnorm, 1e-9),
                            1.0)
    hypers = [adamw._prepare(opt, params, grads, {"count": torch.tensor(
        count0 + k, dtype=torch.int32)})[3] for k in range(steps)]
    norm_err = (norms - gnorm).abs().max().item()
    torch.testing.assert_close(norms, gnorm.expand(steps), rtol=1e-5, atol=0)
    rtol = 4 * torch.finfo(torch.float32).eps
    share = dict.fromkeys(("p", "mu", "nu"), 0.0)
    abs_err = 0.0
    for k, (name, p, g, mu, nu, q) in enumerate(zip(
            names, _leaves(params), _leaves(grads), _leaves(state["mu"]),
            _leaves(state["nu"]), _leaves(p0))):
        # slices of ADAMW_SLICE elements: a leaf holds up to 0.84 B
        start = (q, *moments(k, q))
        change, err, excess = ([0.0] * 3 for _ in range(3))
        for lo in range(0, q.numel(), ADAMW_SLICE):
            cut = slice(lo, lo + ADAMW_SLICE)
            want = [t.reshape(-1)[cut].clone() for t in start]
            for hyper in hypers:
                update_leaf(opt, want[0], g.reshape(-1)[cut], want[1],
                            want[2], scale, *hyper)
            for j, (got, w, b) in enumerate(zip((p, mu, nu), want, start)):
                diff = (got.reshape(-1)[cut] - w).abs()
                change[j] = max(change[j], (w - b.reshape(-1)[cut]).abs()
                                .max().item())
                err[j] = max(err[j], diff.max().item())
                excess[j] = max(excess[j], diff.sub_(w.abs().mul_(rtol))
                                .max().item())
            del want, diff
        for j, part in enumerate(share):
            # as assert_close(rtol, atol=ADAMW_CHANGE_TOL * change) would
            assert change[j] > 0, (part, name)
            assert excess[j] <= ADAMW_CHANGE_TOL * change[j], (
                part, name, err[j], change[j])
            share[part] = max(share[part], err[j] / change[j])
            abs_err = max(abs_err, err[j])
        del start
    assert max(share.values()) <= 1e-2, share
    print(f"[adamw] {cfg.name}: {n / 1e9:.3f} B params in {len(names)} "
          f"leaves, bf16 gradients of norm {gnorm.item():.4f} (clip scale "
          f"{scale.item():.4f}), {steps} fused steps from count {count0} "
          f"against the plain arithmetic, leaf by leaf: the largest error "
          f"over the plain change's largest element p {share['p']:.3e}, mu "
          f"{share['mu']:.3e}, nu {share['nu']:.3e} (tol {ADAMW_CHANGE_TOL} "
          f"+ {rtol:.2e}·|x|); grad norm max_abs_err {norm_err:.3e}; rerun "
          f"bit-identical: {identical} ({time.perf_counter() - t0:.1f} s)")
    del p0
    torch.cuda.empty_cache()

    # the library route, held to the plain arithmetic on three small leaves
    lr_f, b1c_f, b2c_f = hypers[0]

    def library_step(ps, gs, ms, vs, counts):
        g32 = [g.float() for g in gs]
        total = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(g32)))
        torch._fused_adamw_(
            ps, g32, ms, vs, [], counts, lr=lr_f, beta1=opt.b1,
            beta2=opt.b2, weight_decay=opt.weight_decay, eps=opt.eps,
            amsgrad=False, maximize=False,
            grad_scale=torch.clamp_min(total / opt.grad_clip, 1.0),
            found_inf=None)

    sizes = (2 ** 20 + 3, 999, 4096)
    ps = [torch.randn(k, generator=gen, device=device) for k in sizes]
    gs = [torch.randn(k, generator=gen, device=device, dtype=torch.bfloat16)
          for k in sizes]
    ms = [torch.randn(k, generator=gen, device=device).mul_(1e-3)
          for k in sizes]
    vs = [torch.randn(k, generator=gen, device=device).square_().add_(0.5)
          .mul_(1e-6) for k in sizes]
    counts = [torch.full((), float(count0 + 1), device=device) for _ in ps]
    before = [[t.clone() for t in x] for x in (ps, ms, vs)]
    want = [[t.clone() for t in x] for x in (ps, ms, vs)]
    small_scale = torch.clamp_max(opt.grad_clip / torch.linalg.vector_norm(
        torch.stack([g.float().norm() for g in gs])), 1.0)
    for p, g, m, v in zip(want[0], gs, want[1], want[2]):
        update_leaf(opt, p, g, m, v, small_scale, lr_f, b1c_f, b2c_f)
    library_step(ps, gs, ms, vs, counts)
    for got, w, b in zip((ps, ms, vs), want, before):
        for x, y, z in zip(got, w, b):
            torch.testing.assert_close(
                x, y, rtol=rtol,
                atol=ADAMW_CHANGE_TOL * (y - z).abs().max().item())
    del ps, gs, ms, vs, want, before

    # (b) timing on the whole tree
    pl, gl, ml, vl = (list(_leaves(t)) for t in (
        params, grads, state["mu"], state["nu"]))
    counts = [torch.full((), float(count0 + 1), device=device) for _ in pl]
    leaves = [(g.numel(), g.dtype) for g in gl]
    norm_bytes = adamw_norm_work(leaves)[1]
    upd_bytes = adamw_update_work(leaves)[1]
    plain_ms, fused_ms, library_ms = time_turns(
        lambda: adamw_update_reference(opt, params, grads, state),
        lambda: adamw_update(opt, params, grads, state),
        lambda: library_step(pl, gl, ml, vl, counts), reps=3, inner=2)
    sumsq = kernel.adamw_norm(gl)
    kw = dict(lr=lr_f, b1=opt.b1, b2=opt.b2, eps=opt.eps,
              weight_decay=opt.weight_decay, grad_clip=opt.grad_clip,
              b1c=b1c_f, b2c=b2c_f)
    norm_ms = statistics.median(time_samples(
        lambda: kernel.adamw_norm(gl), reps=5, inner=5))
    upd_ms = statistics.median(time_samples(
        lambda: kernel.adamw_update(pl, gl, ml, vl, sumsq, **kw), reps=5,
        inner=2))
    plain_norm_ms = statistics.median(time_samples(
        lambda: adamw._global_norm(grads), reps=5, inner=2))
    peaks = {}
    for label, fn in (
            ("plain", lambda: adamw_update_reference(opt, params, grads,
                                                     state)),
            ("fused", lambda: adamw_update(opt, params, grads, state)),
            ("library", lambda: library_step(pl, gl, ml, vl, counts))):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        fn()
        torch.cuda.synchronize()
        peaks[label] = torch.cuda.max_memory_allocated(device) - base
    bound_norm = norm_bytes / PEAK_BYTES * 1e3
    bound_upd = upd_bytes / PEAK_BYTES * 1e3
    shape = (f"{cfg.name}: {n / 1e9:.3f} B fp32 params in "
             f"{len(leaves)} leaves, bf16 gradients")
    print(f"[adamw] {shape}: the step fused {fused_ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, library route {library_ms:.3f} ms (in turns: "
          f"plain, fused, library, library, fused, plain), bound "
          f"{bound_norm + bound_upd:.3f} ms ({(norm_bytes + upd_bytes) / 1e9:.2f}"
          f" GB at 3.35 TB/s; fused at "
          f"{(bound_norm + bound_upd) / fused_ms:.1%} of it); norm pass "
          f"{norm_ms:.3f} ms (bound {bound_norm:.3f}, {norm_bytes / 1e9:.2f} "
          f"GB; the plain norm {plain_norm_ms:.3f} ms), update pass "
          f"{upd_ms:.3f} ms (bound {bound_upd:.3f}, {upd_bytes / 1e9:.2f} GB);"
          " peak memory beyond the state: " + ", ".join(
              f"{k} {v / 1e9:.3f} GB" for k, v in peaks.items()))
    del params, grads, state, pl, gl, ml, vl, sumsq
    torch.cuda.empty_cache()
    common = dict(route="cuda",
                  source="src/repro_torch/kernels/adamw/csrc/adamw.cu",
                  replaces=None, replaces_fn=None, launches=None,
                  launches_on_path=None, tol=ADAMW_CHANGE_TOL,
                  bound_by="bytes", shape=shape, step_ms=fused_ms,
                  step_plain_ms=plain_ms, step_library_ms=library_ms,
                  step_bound_ms=bound_norm + bound_upd,
                  peak_beyond_state=dict(peaks))
    return [
        {"name": "adamw_norm", **common, "max_abs_err": norm_err,
         "ms": norm_ms, "kernel_ms": norm_ms, "plain_ms": plain_norm_ms,
         "library_ms": None, "bound_ms": bound_norm},
        {"name": "adamw_update", **common, "max_abs_err": abs_err,
         "max_change_err": dict(share), "ms": upd_ms, "kernel_ms": upd_ms,
         "plain_ms": plain_ms, "library_ms": library_ms,
         "bound_ms": bound_upd},
    ]


# (name, B, L, widths of x, B and C) of the conv's calls in the two
# benchmark cells' training steps: mamba2-2.7b at 4 x 2048 (d_inner 5120,
# G·N 128) and zamba2-7b at 2 x 4096 (7168, 2·64); K 4, bf16.
CONV_SHAPES = (("mamba2-2.7b", 4, 2048, (5120, 128, 128)),
               ("zamba2-7b", 2, 4096, (7168, 128, 128)))


def conv_library(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """silu(causal_conv(x, w)) by the library, as mamba_ssm's reference
    mixer writes it: cuDNN's depthwise ``F.conv1d`` over (B, C, L) padded
    by K - 1 zeros before the sequence (its first L outputs), then
    ``F.silu``. A yardstick for conv_phase, no path of the port."""
    f = torch.nn.functional
    k, length = w.shape[0], x.shape[1]
    y = f.conv1d(x.transpose(1, 2), w.t().unsqueeze(1), padding=k - 1,
                 groups=x.shape[2])[..., :length]
    return f.silu(y).transpose(1, 2)


def conv_phase(device: torch.device) -> list:
    """The Mamba-2 mixer's conv + SiLU kernels (``kernels.conv``) at the
    benchmark cells' layer shapes in bf16: the forward (one launch for x, B
    and C), dx and dw against the plain version evaluated in float64 (its
    closed-form backward) at TOL[bf16], each element; a second forward and
    backward give the same bits. Then each pass's time on the card beside
    the plain version's eager chain (the forward: ``ref.causal_conv`` of
    each tensor; the backward: autograd through it, with the forward that
    builds its graph outside the timing) and beside the library route, a
    yardstick and no path (``conv_library``: cuDNN's depthwise conv1d and
    ``F.silu``, autograd for the backward; its y and dx held to the same
    float64 values first, its dw's error printed), each timed by CUDA events around calls queued behind a sleep
    kernel, and beside its bound (its ``work`` bytes at 3.35 TB/s).
    Returns the kernel table's two records,
    ``causal_conv_fwd`` and ``causal_conv_bwd``, at mamba2-2.7b's shape,
    zamba2-7b's under ``zamba2_7b_train_shape``."""
    from repro_torch.kernels.conv import kernel, ref
    from repro_torch.kernels.conv.work import conv_backward_work, conv_work

    dtype, k = torch.bfloat16, 4
    rows = {}
    for name, b, l, widths in CONV_SHAPES:
        gen = torch.Generator(device=device).manual_seed(21)
        xs = [torch.randn((b, l, c), generator=gen, device=device).to(dtype)
              for c in widths]
        ws = [(0.5 * torch.randn((k, c), generator=gen, device=device)).to(
            dtype) for c in widths]
        dys = [torch.randn((b, l, c), generator=gen, device=device).to(dtype)
               for c in widths]
        ys = kernel.causal_conv_fwd(xs, ws)
        dxs, dws = kernel.causal_conv_bwd(xs, ws, dys)
        same = all(torch.equal(a, c) for a, c in zip(
            ys + dxs + dws, kernel.causal_conv_fwd(xs, ws)
            + sum(kernel.causal_conv_bwd(xs, ws, dys), ())))
        assert same, f"{name}: two runs of the conv kernels differ"
        err = dict.fromkeys(("y", "dx", "dw"), 0.0)
        lib_err = dict(err)
        for x, w, dy, y, dx, dw in zip(xs, ws, dys, ys, dxs, dws):
            want_dx, want_dw = ref.causal_conv_silu_backward_reference(
                x, w, dy)
            for part, got, want in (
                    ("y", y, ref.causal_conv(x.double(), w.double())),
                    ("dx", dx, want_dx), ("dw", dw, want_dw)):
                torch.testing.assert_close(got.double(), want,
                                           rtol=TOL[dtype], atol=TOL[dtype],
                                           msg=f"{name} {part}")
                err[part] = max(err[part], (got.double() - want).abs().max()
                                .item() / want.abs().max().item())
            lib_leaves = [t.clone().requires_grad_() for t in (x, w)]
            lib_y = conv_library(*lib_leaves)
            lib_dx, lib_dw = torch.autograd.grad(lib_y, lib_leaves, dy)
            for part, got, want in (("y", lib_y, ref.causal_conv(
                    x.double(), w.double())), ("dx", lib_dx, want_dx),
                                    ("dw", lib_dw, want_dw)):
                if part != "dw":   # cuDNN's bf16 dw is printed, not held
                    torch.testing.assert_close(
                        got.double(), want, rtol=TOL[dtype], atol=TOL[dtype],
                        msg=f"{name} library {part}")
                lib_err[part] = max(lib_err[part], (
                    got.double() - want).abs().max().item()
                    / want.abs().max().item())
            del want_dx, want_dw, lib_leaves, lib_y, lib_dx, lib_dw
        leaves = [t.clone().requires_grad_() for t in xs + ws]

        def device_ms(calls, reps=10, warmup=2):
            """The card's time a call of ``calls()`` (a list of calls),
            from CUDA events around them queued behind a sleep kernel, so
            the host's time (a kernel call takes about as long on the host
            as on the card) is not timed."""
            samples = []
            for i in range(warmup + reps):
                queued = calls()
                torch.cuda._sleep(10_000_000)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for call in queued:
                    call()
                end.record()
                end.synchronize()
                if i >= warmup:
                    samples.append(start.elapsed_time(end) / len(queued))
                del queued
            return statistics.median(samples)

        def autograd_backward(conv):
            """Three backward calls of autograd through ``conv`` of the
            three tensors, each call's graph built before the timed
            window."""
            graphs = [[conv(x, w) for x, w in zip(leaves[:3], leaves[3:])]
                      for _ in range(3)]
            return [lambda outs=outs: torch.autograd.grad(outs, leaves, dys)
                    for outs in graphs]

        kern_f = device_ms(lambda: [lambda: kernel.causal_conv_fwd(xs, ws)]
                           * 10)
        kern_b = device_ms(lambda: [lambda: kernel.causal_conv_bwd(
            xs, ws, dys)] * 10)
        plain_f = device_ms(lambda: [lambda: [ref.causal_conv(x, w) for x, w
                                              in zip(xs, ws)]] * 3)
        plain_b = device_ms(lambda: autograd_backward(ref.causal_conv))
        lib_f = device_ms(lambda: [lambda: [conv_library(x, w) for x, w
                                            in zip(xs, ws)]] * 3)
        lib_b = device_ms(lambda: autograd_backward(conv_library))
        fwd_bytes = conv_work(b, l, widths, k, dtype)[1]
        bwd_bytes = conv_backward_work(b, l, widths, k, dtype)[1]
        bound_f, bound_b = (n / PEAK_BYTES * 1e3 for n in (fwd_bytes,
                                                          bwd_bytes))
        shape = f"{name}: B{b} L{l} C {'+'.join(map(str, widths))} K{k} bf16"
        print(f"[conv] {shape}: forward {kern_f:.4f} ms (1 launch), plain "
              f"{plain_f:.4f} ms, library {lib_f:.4f} ms, bound "
              f"{bound_f:.4f} ms ({fwd_bytes / 1e6:.1f} MB; kernel at "
              f"{bound_f / kern_f:.1%}); backward {kern_b:.4f} ms (2 "
              f"launches), plain {plain_b:.4f} ms (autograd through the "
              f"eager forward), library {lib_b:.4f} ms (autograd through "
              f"cuDNN's conv1d), bound {bound_b:.4f} ms "
              f"({bwd_bytes / 1e6:.1f} MB; kernel at {bound_b / kern_b:.1%});"
              f" largest error over the plain float64 value's largest: y "
              f"{err['y']:.3e}, dx {err['dx']:.3e}, dw {err['dw']:.3e} (tol "
              f"{TOL[dtype]} each element); the library's y {lib_err['y']:.3e}"
              f", dx {lib_err['dx']:.3e}, dw {lib_err['dw']:.3e}; rerun "
              f"bit-identical: {same}")
        common = dict(shape=shape, tol=TOL[dtype], bound_by="bytes")
        rows[name] = (
            {**common, "ms": kern_f, "kernel_ms": kern_f, "plain_ms": plain_f,
             "library_ms": lib_f, "bound_ms": bound_f,
             "max_abs_err": err["y"]},
            {**common, "ms": kern_b, "kernel_ms": kern_b, "plain_ms": plain_b,
             "library_ms": lib_b, "bound_ms": bound_b,
             "max_abs_err": max(err["dx"], err["dw"])})
        del xs, ws, dys, ys, dxs, dws, leaves
        torch.cuda.empty_cache()
    source = dict(route="cuda", source="src/repro_torch/kernels/conv/csrc/"
                  "conv.cu", replaces=None, replaces_fn=None, launches=None,
                  launches_on_path=None)
    return [{"name": f"causal_conv_{part}", **source,
             **rows[CONV_SHAPES[0][0]][j],
             "zamba2_7b_train_shape": rows[CONV_SHAPES[1][0]][j]}
            for j, part in enumerate(("fwd", "bwd"))]


# The benchmark cells' training steps whose conv calls conv_cells_check
# counts: (configuration under perfbench/configs, batch, sequence length,
# forward calls a step, backward calls a step). Two forward calls a Mamba-2
# layer (the forward and remat's recompute) and one backward call: 64
# layers in mamba2-2.7b, 24 in zamba2-7b's cut.
CONV_CELLS = (("mamba2-2.7b", 4, 2048, 128, 64),
              ("zamba2-7b", 2, 4096, 48, 24))


def conv_cells_check(device: torch.device) -> None:
    """One make_train_step step at each benchmark cell's configuration
    (its file's ``port`` section as the program's ModelConfig, or
    HybridConfig where it holds ``shared_blocks``) and batch, from fresh
    weights on random tokens: the conv's counters move by CONV_CELLS's
    counts (every counter's move printed), and the loss is finite."""
    from repro_torch.configs.base import HybridConfig, ModelConfig
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.optim.adamw import AdamWConfig

    counters = launch_counters()
    for name, batch, seq, fwd, bwd in CONV_CELLS:
        port = json.loads((SRC.parent / "perfbench" / "configs"
                           / f"{name}.json").read_text())["port"]
        port["pattern"] = tuple(port["pattern"])
        cfg = (HybridConfig if "shared_blocks" in port else ModelConfig)(
            **port)
        state = init_train_state(
            cfg, torch.Generator(device=device).manual_seed(0), device)
        labels = torch.randint(0, cfg.vocab_size, (batch, seq),
                               generator=torch.Generator(device=device)
                               .manual_seed(1), device=device,
                               dtype=torch.int32)
        inputs = torch.roll(labels, 1, dims=1)
        inputs[:, 0] = 0
        before = {n: w.launches for n, w in counters.items()}
        state, metrics = make_train_step(cfg, AdamWConfig())(
            state, {"inputs": inputs, "labels": labels})
        loss = float(metrics["loss"])
        moved = {n: w.launches - before[n] for n, w in counters.items()}
        print(f"[conv] {name} training step at {batch} x {seq} "
              f"({cfg.num_layers} layers): launches {json.dumps(moved)}; "
              f"loss {loss:.4f}")
        assert math.isfinite(loss), (name, loss)
        assert (moved["causal_conv_fwd"], moved["causal_conv_bwd"]) == (
            fwd, bwd), (name, moved)
        del state, metrics, labels, inputs
        torch.cuda.empty_cache()


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
    300-token prompt (a ragged second chunk), then 4 decode steps. The
    card's logits and shared-block KV rows held to the CPU's fp32 run of
    the same weights by card_rules.bf16_no_worse: the card's conv kernel
    sums in fp32 and rounds once where the plain version rounds after
    every op, and this model's random weights carry that ulp to some 5% of
    the logits' norm, past the 0.15 of the other path checks on about 1.6%
    of the logits. The shared block's two repeats must write two different
    KV rows."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import lm

    cfg = dataclasses.replace(smoke_config("zamba2-2.7b"), head_dim=80,
                              ssm_head_dim=64, ssm_state=64, ssm_chunk=256)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    counters = launch_counters()
    gen = torch.Generator().manual_seed(8)
    cpu_params = lm.init_params(cfg, gen, device="cpu", dtype=torch.bfloat16)
    toks = torch.randint(0, cfg.vocab_size, (2, 304), generator=gen,
                         dtype=torch.int32)
    outs, kv = [], []
    for dev, c, dtype in ((torch.device("cpu"), cfg, torch.bfloat16),
                          (torch.device("cpu"), cfg32, torch.float32),
                          (device, cfg, torch.bfloat16)):
        params = lm.tree_map(lambda x: x.to(dev, dtype), cpu_params)
        before = {n: w.launches for n, w in counters.items()}
        with torch.inference_mode():
            logits, caches, pos = lm.prefill(c, params,
                                             toks[:, :300].to(dev))
            caches = lm.grow_caches(c, caches, 304)
            seq = [logits]
            for t in range(300, 304):
                logits, caches, pos = lm.decode_step(
                    c, params, toks[:, t:t + 1].to(dev), pos, caches)
                seq.append(logits)
        launches = {n: w.launches - before[n] for n, w in counters.items()}
        want = dict.fromkeys(counters, 0)
        if dev.type == "cuda":
            want.update(flash_attention_fwd=cfg.repeats,
                        ssd_fwd=5 * cfg.repeats,
                        causal_conv_fwd=5 * cfg.repeats)
        assert launches == want, (dev, launches, want)
        outs.append(torch.stack(seq).float().cpu())
        kv.append(caches["slot5"]["k"].float().cpu())
    cpu, cpu32, card = outs
    assert torch.isfinite(card).all(), "non-finite logits on the card"
    assert not torch.equal(kv[2][0], kv[2][1]), "one KV row for two repeats"
    card_err, cpu_err = bf16_no_worse(card, cpu, cpu32, "zamba2 logits")
    kv_card, kv_cpu = bf16_no_worse(kv[2], kv[0], kv[1], "zamba2 KV rows")
    print(f"[path] zamba2 smoke (D 80, P 64, N 64, chunk 256, shared block "
          f"at layers 6 and 12), prefill 300 + 4 decode steps in bf16, "
          f"relative norm from the CPU's fp32 run: logits card "
          f"{card_err:.3e}, cpu {cpu_err:.3e} (bound 2·cpu + {TOL_BF16} = "
          f"{2 * cpu_err + TOL_BF16:.3e}); shared-block KV rows card "
          f"{kv_card:.3e}, cpu {kv_cpu:.3e}; card vs CPU bf16 max_abs_err "
          f"{(card - cpu).abs().max().item():.3e}, share past rtol=atol=0.15 "
          f"{((card - cpu).abs() > 0.15 + 0.15 * cpu.abs()).float().mean().item():.4f}"
          f"; the two repeats' KV rows differ")


def granite_path_check(device: torch.device) -> None:
    """The MoE model path on the card against the same path on the CPU
    (plain attention), on a small input: smoke_config("granite-moe-3b-a800m")
    (two layers, 4 experts of 64, top-2, 44 dead expert slots) with head
    dim 64, so that the flash forward runs (the smoke 16 is no head dim the
    kernel takes), and granite's own capacity factor 1.25, so that tokens
    are dropped; a 2 x 300 prompt (600 tokens: groups of 60, the largest
    divisor of 600 under the 64 of the config), then 4 decode steps, the
    same bf16 weights on both. Each run's launches are counted as in
    zamba_path_check: the flash forward once per layer in the prefill.

    Prints the share of (token, layer) routings (a token's experts and
    slots in one layer, read through ``moe.route``) that agree, and of its
    experts alone; some assignments are dropped; holds the logits to 0.15,
    the bf16 tolerance of tests/test_torch_lm.py. The bf16 router logits
    tie or nearly tie often (8 bits of mantissa), so the card's and the
    CPU's roundings pick different experts for some tokens, and every
    later token of the group routed to those experts then takes another
    capacity slot: the routings are printed, and the logits, which carry
    the flips' effect, are what is held."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import lm, moe

    counters = launch_counters()
    cfg = dataclasses.replace(smoke_config("granite-moe-3b-a800m"),
                              head_dim=64, capacity_factor=1.25)
    gen = torch.Generator().manual_seed(10)
    cpu_params = lm.init_params(cfg, gen, device="cpu", dtype=torch.bfloat16)
    toks = torch.randint(0, cfg.vocab_size, (2, 304), generator=gen,
                         dtype=torch.int32)
    outs, routes = [], []
    for dev in (torch.device("cpu"), device):
        params = lm.tree_map(lambda x: x.to(dev), cpu_params)
        seen, real = [], moe.route

        def spy(cfg_, router, xg):
            out = real(cfg_, router, xg)
            seen.append((out[2].cpu(), out[4].cpu()))
            return out

        before = {n: w.launches for n, w in counters.items()}
        with torch.inference_mode(), mock.patch.object(moe, "route", spy):
            logits, caches, pos = lm.prefill(cfg, params,
                                             toks[:, :300].to(dev))
            caches = lm.grow_caches(cfg, caches, 304)
            seq = [logits]
            for t in range(300, 304):
                logits, caches, pos = lm.decode_step(
                    cfg, params, toks[:, t:t + 1].to(dev), pos, caches)
                seq.append(logits)
        launches = {n: w.launches - before[n] for n, w in counters.items()}
        want = {n: 0 for n in counters}
        if dev.type == "cuda":
            want["flash_attention_fwd"] = cfg.num_layers
        assert launches == want, (dev, launches, want)
        outs.append(torch.stack(seq).float().cpu())
        routes.append(seen)
    assert torch.isfinite(outs[1]).all(), "non-finite logits on the card"
    assert len(routes[0]) == len(routes[1]) == 5 * cfg.num_layers
    # (token, layer) routings: a token's k experts (and slots), per call
    same = same_experts = total = 0
    for (ei, si), (ej, sj) in zip(*routes):
        experts = (ei == ej).all(-1)
        agree = experts & (si == sj).all(-1)
        same, total = same + int(agree.sum()), total + agree.numel()
        same_experts += int(experts.sum())
    c = moe.moe_capacity(cfg, 60)
    dropped = int(sum((s >= c).sum() for _, s in routes[0][:cfg.num_layers]))
    err = (outs[0] - outs[1]).abs().max().item()
    tol = 0.15
    print(f"[path] granite-moe smoke bf16 (D 64, 4 experts top-2, "
          f"capacity factor 1.25: capacity {c} in groups of 60, "
          f"{dropped} of {2 * 300 * 2 * cfg.num_layers} prefill "
          f"assignments dropped on the CPU), prefill 300 + 4 decode "
          f"steps: (token, layer) routings equal on card and CPU "
          f"{same} of {total} ({same / total:.4f}; the experts alone "
          f"{same_experts / total:.4f}); logits card vs CPU "
          f"max_abs_err={err:.3e} (rtol=atol={tol})")
    assert dropped > 0, "no token dropped: the check shows nothing"
    torch.testing.assert_close(outs[1], outs[0], rtol=tol, atol=tol)


def embed_path_check(device: torch.device) -> None:
    """The ``embed`` frontend on the card against the same path on the CPU
    (plain attention), on a small input: smoke_config("musicgen-large")
    with its head dim 64 (MHA), and smoke_config("qwen2-vl-72b") with its
    head dim 128 and M-RoPE sections (16, 24, 24) (the smoke head dim 16,
    with sections (2, 3, 3), is none the kernels take), two layers each;
    the same bf16 weights, a 2 x 300 prompt of random bf16 embeddings,
    then 4 decode steps on embedded frames. The flash forward runs once a
    layer in the prefill on the card and never on the CPU; rtol = atol =
    0.15 on the fp32 logits, as the other path checks. With the stub
    frontend's three equal position streams M-RoPE equals RoPE, so its
    rotation at D 128 is also run with three distinct streams on both
    devices, where a wrong band split would show."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import attention, common, lm

    counters = launch_counters()
    for arch, change in (("musicgen-large", dict(head_dim=64)),
                         ("qwen2-vl-72b", dict(head_dim=128,
                                               mrope_sections=(16, 24, 24)))):
        cfg = dataclasses.replace(smoke_config(arch), **change)
        gen = torch.Generator().manual_seed(14)
        cpu_params = lm.init_params(cfg, gen, device="cpu",
                                    dtype=torch.bfloat16)
        emb = torch.randn((2, 304, cfg.d_model), generator=gen).to(
            torch.bfloat16)
        outs = []
        for dev in (torch.device("cpu"), device):
            params = lm.tree_map(lambda x: x.to(dev), cpu_params)
            before = {n: w.launches for n, w in counters.items()}
            with torch.inference_mode():
                logits, caches, pos = lm.prefill(cfg, params,
                                                 emb[:, :300].to(dev))
                caches = lm.grow_caches(cfg, caches, 304)
                seq = [logits]
                for t in range(300, 304):
                    logits, caches, pos = lm.decode_step(
                        cfg, params, emb[:, t:t + 1].to(dev), pos, caches)
                    seq.append(logits)
            launches = {n: w.launches - before[n] for n, w in counters.items()}
            want = {n: 0 for n in counters}
            if dev.type == "cuda":
                want["flash_attention_fwd"] = cfg.num_layers
            assert launches == want, (arch, dev, launches, want)
            outs.append(torch.stack(seq).float().cpu())
        assert torch.isfinite(outs[1]).all(), "non-finite logits on the card"
        err = (outs[0] - outs[1]).abs().max().item()
        print(f"[path] {arch} smoke, embed frontend (D {cfg.resolved_head_dim}"
              f", H {cfg.num_heads}, K {cfg.num_kv_heads}"
              f"{', M-RoPE (16, 24, 24)' if cfg.mrope_sections else ''}), "
              f"prefill 300 + 4 decode steps on bf16 embeddings: card vs CPU "
              f"max_abs_err={err:.3e} (rtol=atol=0.15)")
        torch.testing.assert_close(outs[1], outs[0], rtol=0.15, atol=0.15)
    # M-RoPE with distinct streams, card against CPU, fp32 at TOL[fp32];
    # cfg is the loop's last, qwen2-vl-72b's
    gen = torch.Generator().manual_seed(15)
    x = torch.randn((2, 300, cfg.num_heads, 128), generator=gen)
    pos = torch.randint(0, 8192, (3, 2, 300), generator=gen,
                        dtype=torch.int32)
    want = common.apply_mrope(x, pos, cfg.mrope_sections, cfg.rope_theta)
    got = attention._rope(cfg, x.to(device), pos.to(device)).cpu()
    err = (got - want).abs().max().item()
    print(f"[path] M-RoPE at D 128, sections (16, 24, 24), three distinct "
          f"position streams: card vs CPU max_abs_err={err:.3e} "
          f"(tol {TOL[torch.float32]})")
    torch.testing.assert_close(got, want, rtol=TOL[torch.float32],
                               atol=TOL[torch.float32])


def windowed_path_check(device: torch.device) -> None:
    """The windowed models on the card against the same path on the CPU
    (plain attention): smoke_config("gemma2-2b") (local and global layers
    in turn, attention soft-cap 50, final soft-cap 30) at its head dim 256
    and smoke_config("h2o-danube-3-4b") (a window at every layer) at its
    head dim 120 (the smoke head dim 16 is none the kernels take), two
    repeats each; the same bf16 weights, a 2 x 300 prompt, past the smoke
    window of 64, so the kernels mask keys by the window and the windowed
    caches wrap, then 4 decode steps. The flash forward runs once a layer
    in the prefill on the card and never on the CPU; rtol = atol = 0.15 on
    the fp32 logits, as the other path checks."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import lm

    counters = launch_counters()
    for arch, head_dim in (("gemma2-2b", 256), ("h2o-danube-3-4b", 120)):
        cfg = dataclasses.replace(smoke_config(arch), head_dim=head_dim)
        assert cfg.window is not None and cfg.window < 300
        gen = torch.Generator().manual_seed(16)
        cpu_params = lm.init_params(cfg, gen, device="cpu",
                                    dtype=torch.bfloat16)
        toks = torch.randint(0, cfg.vocab_size, (2, 304), generator=gen,
                             dtype=torch.int32)
        outs = []
        for dev in (torch.device("cpu"), device):
            params = lm.tree_map(lambda x: x.to(dev), cpu_params)
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
            want = {n: 0 for n in counters}
            if dev.type == "cuda":
                want["flash_attention_fwd"] = cfg.num_layers
            assert launches == want, (arch, dev, launches, want)
            outs.append(torch.stack(seq).float().cpu())
        assert torch.isfinite(outs[1]).all(), "non-finite logits on the card"
        err = (outs[0] - outs[1]).abs().max().item()
        print(f"[path] {arch} smoke (D {head_dim}, H {cfg.num_heads}, K "
              f"{cfg.num_kv_heads}, pattern {cfg.pattern}, window "
              f"{cfg.window}, soft-caps {cfg.attn_logit_softcap}/"
              f"{cfg.final_logit_softcap}), prefill 300 + 4 decode steps: "
              f"card vs CPU max_abs_err={err:.3e} (rtol=atol=0.15)")
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
    one of smoke_config("mamba2-130m") (P 16, N 16, chunk 32: the SSD
    forward twice per layer with remat and its backward once), and one of
    smoke_config("musicgen-large") with head_dim 64 (the ``embed``
    frontend: fp32 (B, S, M) embeddings from the pipeline), and one each
    of smoke_config("gemma2-2b") at head_dim 256 and
    smoke_config("h2o-danube-3-4b") at head_dim 120, on
    the card (the kernels) and on the CPU (the plain versions) from the
    same fp32 state and batch, in bf16 compute. Loss and grad norm within
    rtol = atol = TOL[bf16]. The gradient, leaf by leaf, read from the
    first moment after the step ((1 - b1)·clip·g), held to the CPU's fp32
    step's by card_rules.bf16_no_worse (the plain version's own bf16
    gradient of this step lies 1e-2 to 2e-2 from the fp32 one, as
    printed, so two bf16 implementations may differ by more than
    TOL[bf16] without a fault; a missing gradient is off by 1). The
    parameters after the step within rtol TOL[fp32] and atol 2·lr +
    TOL[fp32]: Adam's first step moves each element by about lr·sign(g),
    so an element whose gradient lies within rounding of 0 can land 2·lr
    apart."""
    from repro_torch.configs import smoke_config
    from repro_torch.optim.adamw import AdamWConfig

    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    for base, per_layer in (
            (dataclasses.replace(smoke_config("llama3.2-3b"), head_dim=32),
             {"flash_attention_fwd": 2, "flash_attention_bwd": 1}),
            (smoke_config("mamba2-130m"), {"ssd_fwd": 2, "ssd_bwd": 1,
                                           "causal_conv_fwd": 2,
                                           "causal_conv_bwd": 1}),
            (dataclasses.replace(smoke_config("musicgen-large"), head_dim=64),
             {"flash_attention_fwd": 2, "flash_attention_bwd": 1}),
            (dataclasses.replace(smoke_config("gemma2-2b"), head_dim=256),
             {"flash_attention_fwd": 2, "flash_attention_bwd": 1}),
            (dataclasses.replace(smoke_config("h2o-danube-3-4b"),
                                 head_dim=120),
             {"flash_attention_fwd": 2, "flash_attention_bwd": 1})):
        train_step_check(device, base, per_layer, opt)


def train_step_check(device, base, per_layer: dict, opt) -> None:
    """train_path_check's step for one smoke config ``base``, whose card
    run launches each kernel ``per_layer`` times per layer."""
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models import lm

    counters = launch_counters()
    ftol, tol = TOL[torch.float32], TOL[torch.bfloat16]
    batch = SyntheticTokenPipeline(DataConfig(
        4, 64, base.vocab_size, seed=1,
        embed_dim=base.d_model if base.frontend == "embed" else 0)
    ).batch_at(0)

    def step(cfg, state, dev):
        new, metrics = make_train_step(cfg, opt)(
            state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        gn = float(metrics["grad_norm"])
        return (lm.tree_map(lambda x: x.cpu(), new["params"]),
                first_step_grads(new["opt"]["mu"], gn, opt),
                float(metrics["loss"]), gn)

    # the CPU's fp32 gradient, the yardstick of the bf16 runs
    cfg32 = dataclasses.replace(base, compute_dtype="float32")
    grads32 = step(cfg32, init_train_state(
        cfg32, torch.Generator().manual_seed(7), device="cpu"),
        torch.device("cpu"))[1]
    cfg = dataclasses.replace(base, compute_dtype="bfloat16")
    cpu_state = init_train_state(cfg, torch.Generator().manual_seed(7),
                                 device="cpu")
    gpu_state = lm.tree_map(
        lambda x: x.to(device, copy=True) if x.dim() else x.clone(),
        cpu_state)
    out = []
    for state, dev in ((cpu_state, torch.device("cpu")), (gpu_state, device)):
        before = {n: w.launches for n, w in counters.items()}
        out.append(step(cfg, state, dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches = {n: w.launches - before[n] for n, w in counters.items()}
        want = {n: (per_layer.get(n, 0) * cfg.num_layers
                    + ADAMW_STEP.get(n, 0) if dev.type == "cuda" else 0)
                for n in counters}
        assert launches == want, (dev, launches, want)
    (p_cpu, g_cpu, loss_cpu, gn_cpu), (p_gpu, g_gpu, loss_gpu, gn_gpu) = out
    pairs = list(zip(_leaves(p_gpu), _leaves(p_cpu)))
    p_err = max((a - b).abs().max().item() for a, b in pairs)
    g_errs = {n: bf16_no_worse(g_gpu[n], g_cpu[n], grads32[n], n)
              for n in g_cpu}
    worst = max(g_errs, key=lambda n: g_errs[n][0] / (2 * g_errs[n][1] + tol))
    card, cpu = zip(*g_errs.values())
    print(f"[train-path] smoke {cfg.name} bfloat16: loss card "
          f"{loss_gpu:.6f} cpu {loss_cpu:.6f}, grad norm card "
          f"{gn_gpu:.6f} cpu {gn_cpu:.6f} (rtol=atol={tol}); gradient leaf "
          f"by leaf, relative norm from the fp32 gradient: card "
          f"{min(card):.3e}-{max(card):.3e}, cpu {min(cpu):.3e}-"
          f"{max(cpu):.3e} over the leaves; at the tightest leaf ({worst}) "
          f"card {g_errs[worst][0]:.3e}, bound 2·cpu + {tol} = "
          f"{2 * g_errs[worst][1] + tol:.3e}; params after the step "
          f"max_abs_err={p_err:.3e} (atol 2·lr + {ftol})")
    assert math.isfinite(loss_gpu) and math.isfinite(gn_gpu)
    torch.testing.assert_close(torch.tensor([loss_gpu, gn_gpu]),
                               torch.tensor([loss_cpu, gn_cpu]),
                               rtol=tol, atol=tol)
    for a, b in pairs:
        torch.testing.assert_close(a, b, rtol=ftol, atol=2 * opt.lr + ftol)


def first_step_grads(mu, grad_norm: float, opt) -> dict:
    """The gradient of the first AdamW step, leaf by leaf, on the CPU,
    keyed by the leaf's path: the first moment is then (1 - b1)·clip·g,
    with clip = min(1, grad_clip / grad_norm)."""
    clip = min(1.0, opt.grad_clip / max(grad_norm, 1e-9))
    return {name: m.cpu() / ((1 - opt.b1) * clip)
            for name, m in _named_leaves(mu)}


def adamw_first_step(opt, p, mu, nu, lr: float) -> torch.Tensor:
    """``p`` after a first AdamW step with moments ``mu`` and ``nu`` (bias
    corrections at count 1), in ``optim.adamw.adamw_update``'s ops."""
    b1c, b2c = (float(1.0 - torch.tensor(b, dtype=torch.float32))
                for b in (opt.b1, opt.b2))
    denom = torch.div(nu, b2c).sqrt_().add_(opt.eps)
    step = torch.div(mu, b1c).div_(denom).add_(p, alpha=opt.weight_decay)
    return torch.sub(p, step, alpha=lr)


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
    call of its three, the SSD backward of its ten; each AdamW pass: one
    per call of its launches over the tree; the conv forward: one per
    layer's call for its three tensors, its backward one per call of its
    two launches)."""
    from repro_torch.kernels.adamw import kernel as adamw
    from repro_torch.kernels.conv import kernel as conv
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.ssd import kernel as ssd

    return {"flash_attention_fwd": flash.flash_attention,
            "flash_attention_bwd": flash.flash_attention_backward,
            "ssd_fwd": ssd.ssd_scan,
            "ssd_bwd": ssd.ssd_scan_backward,
            "adamw_norm": adamw.adamw_norm,
            "adamw_update": adamw.adamw_update,
            "causal_conv_fwd": conv.causal_conv_fwd,
            "causal_conv_bwd": conv.causal_conv_bwd}


# The fused AdamW's calls per training step on the card: one norm pass and
# one update pass over the whole tree.
ADAMW_STEP = {"adamw_norm": 1, "adamw_update": 1}


def ssm_layers(layers: int, train: bool = False) -> dict:
    """The SSD and conv launches of ``layers`` Mamba-2 layers: one forward
    of each a layer (a prefill), or with ``train`` two (remat's recompute)
    and one backward of each."""
    if not train:
        return {"ssd_fwd": layers, "causal_conv_fwd": layers}
    return {"ssd_fwd": 2 * layers, "ssd_bwd": layers,
            "causal_conv_fwd": 2 * layers, "causal_conv_bwd": layers}


# (arch, requests, prompt tokens, generated tokens, the launches of each
# kernel in one prefill (every other kernel launches none), the depth: None
# for the config's own, else the number of layers it is cut to). Every row
# runs at full width; qwen2-vl-72b's 71.5 B parameters (133 GiB in bf16)
# fit no one card, so it serves with 16 of its 80 layers (about 28 GiB of
# weights), which still runs M-RoPE at its published D 128 and sections
# through the flash forward; its full depth waits for multi-GPU.
SERVE = [
    ("llama3.2-3b", 8, 1024, 64, {"flash_attention_fwd": 28}, None),
    ("mamba2-130m", 8, 4096, 64, ssm_layers(24), None),
    ("zamba2-2.7b", 8, 4096, 64, {"flash_attention_fwd": 9,
                                  **ssm_layers(45)}, None),
    ("granite-moe-3b-a800m", 8, 1024, 64, {"flash_attention_fwd": 32}, None),
    ("musicgen-large", 8, 1024, 64, {"flash_attention_fwd": 48}, None),
    ("starcoder2-15b", 8, 1024, 64, {"flash_attention_fwd": 40}, None),
    ("qwen2-vl-72b", 8, 1024, 64, {"flash_attention_fwd": 16}, 16),
    # 4 x 8192, each model's published context, past its window of 4096:
    # the kernel masks keys by the window and the windowed caches wrap
    ("h2o-danube-3-4b", 4, 8192, 64, {"flash_attention_fwd": 24}, None),
    ("gemma2-2b", 4, 8192, 64, {"flash_attention_fwd": 26}, None),
    # all 78 layers (14.5 GB of bf16 weights): 13 applications of the two
    # shared blocks (flash D 224) and 78 Mamba-2 layers with two groups;
    # 4 requests, since the profile phase's second prefill runs beside the
    # first one's grown caches (8 x 4096 did not fit beside them)
    ("zamba2-7b", 4, 4096, 64, {"flash_attention_fwd": 13,
                                **ssm_layers(78)}, None),
]


def phase_config(arch: str, layers=None):
    """(the registered config of ``arch`` at full width, a note of its
    depth): with ``layers`` its depth is cut to that many layers here, and
    the note says so wherever the row is printed."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if layers is None:
        return cfg, f"{cfg.num_layers} layers"
    cut = dataclasses.replace(cfg, num_layers=layers)
    return cut, (f"{layers} of {cfg.num_layers} layers (depth cut: "
                 f"{lm_params(cut) / 1e9:.2f} B of "
                 f"{lm_params(cfg) / 1e9:.2f} B parameters on one card)")


def lm_params(cfg) -> int:
    from repro_torch.models import lm

    return lm.param_count(lm.init_params(cfg, None, device="meta"))


def serve_phase(device: torch.device, arch: str, requests: int,
                prompt_len: int, gen_len: int, expected: dict, layers,
                records: dict) -> dict:
    """Full-width serving of ``arch`` (at ``layers`` layers where that is
    not None) through the port's entry point. Returns TALP's device PE of
    the prefill and decode regions, each with the region's wall per call
    (the prefill; one decode step), and both regions' device metrics."""
    from repro_torch.core.report import render_tables
    from repro_torch.launch.serve import serve

    cfg, depth = phase_config(arch, layers)
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
    print(f"[serve] {arch} full width, {depth}, {requests} "
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
    add_path_launches(records, f"serve {arch} (one prefill"
                      f"{'' if layers is None else f', {layers} layers'})",
                      launches)
    pre = result.regions["prefill"]
    return {"prefill": (pre.device.parallel_efficiency, pre.elapsed),
            "decode": (dec.device.parallel_efficiency, dec.elapsed / gen_len),
            "device": {"prefill": pre.device.as_dict(),
                       "decode": dec.device.as_dict()}}


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
     {"flash_attention_fwd": 56, "flash_attention_bwd": 28, **ADAMW_STEP}),
    ("mamba2-130m", 6, 8, 4096, 3e-4, 2,
     {**ssm_layers(24, train=True), **ADAMW_STEP}),
    ("granite-moe-3b-a800m", 6, 2, 2048, 3e-4, 2,
     {"flash_attention_fwd": 64, "flash_attention_bwd": 32, **ADAMW_STEP}),
    ("musicgen-large", 6, 2, 2048, 3e-4, 2,
     {"flash_attention_fwd": 96, "flash_attention_bwd": 48, **ADAMW_STEP}),
    ("h2o-danube-3-4b", 6, 1, 8192, 3e-4, 2,
     {"flash_attention_fwd": 48, "flash_attention_bwd": 24, **ADAMW_STEP}),
    ("gemma2-2b", 6, 1, 8192, 3e-4, 2,
     {"flash_attention_fwd": 52, "flash_attention_bwd": 26, **ADAMW_STEP}),
    # 54 layers: 9 repeats of five SSD layers and the shared attention
    # block (one parameter set, applied once a repeat)
    ("zamba2-2.7b", 6, 2, 4096, 3e-4, 2,
     {"flash_attention_fwd": 18, "flash_attention_bwd": 9,
      **ssm_layers(45, train=True), **ADAMW_STEP}),
]
# Configs whose train state (16 bytes a parameter) no one card holds:
# ``train`` must refuse them before it allocates anything.
TRAIN_REFUSED = ("starcoder2-15b", "qwen2-vl-72b")


def train_phase(device: torch.device, arch: str, steps: int, batch: int,
                seq: int, lr: float, warmup: int, per_step: dict,
                records: dict) -> dict:
    """Full-width training of ``arch`` through the port's entry point
    (``repro_torch.launch.train.train``), random fp32 weights from a seed:
    per-step loss (all finite), step time, tokens/s and MFU (median of
    steps 2-5), peak memory, each kernel's launches (counts set to 0 just
    before, read just after: ``per_step`` times the steps), and TALP's
    train_loop hierarchies. Then one more step traced with
    ``torch.profiler``: device time by kernel and the busy share. Returns
    the median step, the traced step's kernel time (the union of its
    kernels; None where the profiler saw none), the run's peak memory and
    TALP's train_loop device metrics."""
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
        aux = f", moe_aux {h['moe_aux']:.6f}" if "moe_aux" in h else ""
        print(f"[train] step {h['step']}: loss {h['loss']:.6f}, grad norm "
              f"{h['grad_norm']:.6f}{aux}, {h['time_s'] * 1e3:.3f} ms")
    if cfg.is_moe:
        assert all(math.isfinite(h["moe_aux"]) for h in history), history
    step_s = statistics.median([h["time_s"] for h in history[1:5]])
    tokens = batch * seq
    flops = model_flops(cfg, ShapeConfig("train", seq, batch, "train"))
    note = (", the 6·N count, which leaves out the SSD scan's own "
            "operations" if "ssm" in cfg.pattern else "")
    print(f"[train] {arch} full width, {cfg.num_layers} layers, "
          f"{lm.param_count(state['params']) / 1e9:.3f} B params, global "
          f"batch {batch} x {seq}: step {step_s * 1e3:.3f} ms (median of "
          f"steps 2-5), {tokens / step_s:.1f} tokens/s, MFU "
          f"{flops / (step_s * PEAK_FLOPS):.4f} "
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
    data = SyntheticTokenPipeline(DataConfig(
        batch, seq, cfg.vocab_size,
        embed_dim=cfg.d_model if cfg.frontend == "embed" else 0))
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
    if cfg.is_moe:
        state, _ = moe_step_breakdown(lambda: step_fn(state, b), union)
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
    return {"step_s": step_s, "busy_s": union if busy > 0 else None,
            "peak": peak, "device": loop.device.as_dict()}


def train_refusal_check(device: torch.device) -> None:
    """``train`` refuses each TRAIN_REFUSED config on the card with the
    memory check's ValueError (its train state against the card's total
    memory, ``torch.cuda.mem_get_info``) before it draws a weight:
    ``torch.cuda.memory_allocated`` and every launch counter unchanged."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train

    counters = launch_counters()
    total = torch.cuda.mem_get_info(device)[1]
    for arch in TRAIN_REFUSED:
        torch.cuda.synchronize(device)
        before = torch.cuda.memory_allocated(device)
        launched = {n: w.launches for n, w in counters.items()}
        try:
            train(get_config(arch), steps=6, global_batch=2, seq_len=2048,
                  verbose=False, device=device)
        except ValueError as e:
            msg = str(e)
        else:
            raise AssertionError(f"{arch}: train did not refuse the card")
        torch.cuda.synchronize(device)
        after = torch.cuda.memory_allocated(device)
        assert "train state" in msg, msg
        assert after == before, (arch, before, after)
        assert launched == {n: w.launches for n, w in counters.items()}
        print(f"[train] {arch} refused on the card before allocating "
              f"(memory_allocated {before} -> {after} bytes; card total "
              f"{total / 2**30:.1f} GiB): {msg}")


# The MoE's parts, by the functions of repro_torch.models.moe a traced step
# wraps in profiler ranges; the rest of moe_forward (applying dispatch and
# combine, the aux loss) counts as dispatch/combine.
MOE_PARTS = (("route", "routing"), ("dispatch_tensors", "dispatch/combine"),
             ("expert_ffn", "expert products"))


def moe_step_breakdown(step, busy_s):
    """The MoE's device time in one training step: ``step`` traced by
    ``torch.profiler`` (CPU and CUDA activity) with its routing
    (``moe.route``), dispatch and combine (``moe.dispatch_tensors`` and the
    rest of ``moe.moe_forward``) and expert products (``moe.expert_ffn``)
    in ranges, and each checkpointed repeat in one more. Every kernel goes
    to the innermost range around the op that launched it (the forward,
    and remat's recompute, which runs inside the backward); a backward
    op's kernels go to the part whose forward op made its autograd node
    (the same sequence number, on the forward's thread). ``busy_s`` is the
    traced step's kernel time (seconds), for the shares. Returns the
    step's result."""
    from repro_torch.models import lm, moe

    def ranged(name, fn):
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return wrapped

    patches = [mock.patch.object(moe, fn, ranged(f"moe.{fn}",
                                                 getattr(moe, fn)))
               for fn, _ in MOE_PARTS]
    patches += [mock.patch.object(lm, "moe_forward",
                                  ranged("moe", lm.moe_forward)),
                mock.patch.object(lm, "_remat_repeat",
                                  ranged("repeat", lm._remat_repeat))]
    part = {f"moe.{fn}": label for fn, label in MOE_PARTS}
    part.update({"moe": "dispatch/combine", "repeat": None})
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for p in patches:
        p.start()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            out = step()
            torch.cuda.synchronize()
    finally:
        for p in patches:
            p.stop()
    events = prof.events()
    self_dev = lambda e: getattr(  # noqa: E731
        e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    def owner(e):
        """(part or None, "fwd" | "bwd" | None) of an op."""
        while e is not None:
            if e.name in part:
                return part[e.name], "fwd"
            if e.name.startswith("autograd::engine::evaluate_function"):
                return forward_part.get((e.fwd_thread, e.sequence_nr)), "bwd"
            e = e.cpu_parent
        return None, None

    forward_part = {}
    for e in events:
        if e.sequence_nr >= 0 and not e.name.startswith("autograd::"):
            label, kind = owner(e)
            if kind == "fwd" and label is not None:
                forward_part[(e.thread, e.sequence_nr)] = label
    ms: dict = {}
    total = 0.0
    cpu = torch.autograd.DeviceType.CPU
    for e in events:
        # an op's self device time is its kernels'; the kernels' own
        # events would count them twice
        if e.device_type != cpu:
            continue
        t = self_dev(e) * 1e-3
        if t <= 0:
            continue
        total += t
        label, kind = owner(e)
        if label is not None:
            ms[(label, kind)] = ms.get((label, kind), 0.0) + t
    moe_ms = sum(ms.values())
    if total <= 0:
        print("[moe] the traced step shows no device time by op here, so "
              "the MoE's share is not measured")
        return out
    print(f"[moe] granite train step, MoE device time {moe_ms:.3f} ms of "
          f"{total:.3f} ms of kernel time attributed to ops "
          f"({moe_ms / total:.4f}; the step's kernels were busy "
          f"{busy_s * 1e3:.3f} ms in the CUDA-only trace): " + ", ".join(
              f"{label} {ms.get((label, 'fwd'), 0.0):.3f} forward (with "
              f"remat's recompute) + {ms.get((label, 'bwd'), 0.0):.3f} "
              f"backward ms" for _, label in MOE_PARTS))
    return out


# Kernel-name patterns by group, for the train step's device time.
KERNEL_GROUPS = (
    ("adamw (this repo)", "adamw_"),
    ("flash (this repo)", "flash_"),
    ("ssd (this repo)", "ssd_"),
    ("matmul (cuBLAS)", "nvjet|gemm|gemv|cutlass|sm90_xmma"),
    ("elementwise and copies", "elementwise|copy|Memcpy|Memset|fill"),
    ("reductions", "reduce|softmax|norm"),
)


def profile_phase(device: torch.device, arch: str, batch: int,
                  prompt_len: int, gen_len: int, layers=None) -> dict:
    """Where the serving time goes on the card: the prefill and the decode
    step of full-width ``arch`` (its serve phase's shapes), each timed on
    the host clock without the profiler (median of 5), then traced by
    ``torch.profiler`` (CUDA activity only, see ``traced``; 3 prefills, 8
    decode steps) for the device time of every kernel. Returns each
    step's kernel time per call (the union of the traced calls' kernel
    intervals over the number of calls), which main() divides by the serve
    phase's wall per call of the same step for the profiler's busy share,
    and each step's peak memory (``max_memory_allocated`` over the first
    prefill, with the parameters and prompts live, and over the first
    decode step of the grown caches),
    and holds TALP's device PE of that region against it: TALP reads the
    kernel time through its markers and the engine's flattening, the
    profile from a session of its own. The decode step is then timed again
    with TALP's collection open: the difference is the collection's cost
    per step."""
    from repro_torch.core.backends import CudaRuntimeBackend
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import lm

    cfg, _ = phase_config(arch, layers)
    gen = torch.Generator(device=device).manual_seed(1)
    with torch.inference_mode():
        params = lm.init_params(cfg, gen, device=device, dtype=torch.bfloat16)
        prompts = make_prompts(cfg, batch, prompt_len, gen, device)
        # each step's peak with its own arguments live (the dry run's
        # prediction is held to them): the parameters and prompts here
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        logits, caches, pos = lm.prefill(cfg, params, prompts)
        torch.cuda.synchronize(device)
        peaks = {"prefill": torch.cuda.max_memory_allocated(device)}
        caches = lm.grow_caches(cfg, caches, prompt_len + gen_len)
        # the serve driver's decode input: the argmax token, or a zero frame
        tok = (logits.argmax(-1).to(torch.int32)[:, None]
               if cfg.frontend == "token" else
               torch.zeros((batch, 1, cfg.d_model), device=device,
                           dtype=torch.bfloat16))
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
            torch.cuda.reset_peak_memory_stats(device)
            step()
            torch.cuda.synchronize()
            if name == "decode_step":   # the caches, parameters and token
                peaks[name] = torch.cuda.max_memory_allocated(device)
            wall = median_wall(step)
            reps = 3 if name == "prefill" else 8
            # (the traced calls' last output is dropped here: the next
            # step's peak is measured with its own arguments live)
            prof, traced_wall, union = traced(step, reps)[:3]
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
    return kernel_time, peaks


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


# (arch, steps, global batch, sequence length, checkpoint every, the step
# before which the first attempt fails, the launches of each kernel per
# training step): the checkpoint and restart phase, at mamba2-130m's full
# width (a 2.0 GB train state; a granite or llama state is 43-48 GB).
CHECKPOINT_RUN = ("mamba2-130m", 6, 8, 4096, 3, 4,
                  {**ssm_layers(24, train=True), **ADAMW_STEP})


def _max_diff(got, want) -> float:
    return (got.double() - want.double()).abs().max().item()


def checkpoint_phase(device: torch.device, records: dict) -> None:
    """Checkpoint and restart through the port's trainer at full width:
    ``train`` uninterrupted (6 steps), then under ``run_with_restarts``
    with ``ckpt_every`` 3 and a failure injected before step 4: the second
    attempt restores step_2 (written by the first) and runs steps 3-5. Every
    step of both attempts (loss and grad norm, read from the step function's
    metrics) and the final state (parameters, moments, counts) are held
    against the uninterrupted run's: bit for bit where they are equal, else
    the largest difference is printed and held to TOL[fp32]. The restarted
    run's launches are counted (set to 0 just before, read just after: the
    7 steps it ran). Then one more save of the final state by a
    CheckpointManager (its synchronous part, the host snapshot, and the
    writer thread's seconds, and the bytes), restored onto the card and held
    bit for bit against a host snapshot of the state it was written from;
    and TALP's train_loop host PE of the resumed run with its MPI child (the
    save's synchronous part runs in the trainer's ``mpi()`` state). All in a
    temporary directory, removed at the end."""
    from repro_torch.checkpoint import CheckpointManager, checkpointer
    from repro_torch.checkpoint.manager import host_snapshot
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.steps import train_state_devices
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime import run_with_restarts

    arch, steps, batch, seq, every, fail, per_step = CHECKPOINT_RUN
    cfg = get_config(arch)
    kw = dict(steps=steps, global_batch=batch, seq_len=seq, seed=0,
              opt_cfg=AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=steps),
              verbose=False, device=device)
    tmp = Path(tempfile.mkdtemp(prefix="talp_ckpt_"))
    try:
        t0 = time.perf_counter()
        full, h_full, _ = train_mod.train(cfg, **kw)
        full_s = time.perf_counter() - t0

        # every step the restarted run takes: (step, metrics), in order
        taken = []
        real = train_mod.make_train_step

        def recording(cfg_, opt_):
            fn = real(cfg_, opt_)

            def step(state, batch_):
                taken.append((int(state["step"]), None))
                new, metrics = fn(state, batch_)
                taken[-1] = (taken[-1][0], metrics)
                return new, metrics
            return step

        runs, errors = [], []
        counters = launch_counters()
        for wrapper in counters.values():
            wrapper.launches = 0
        t0 = time.perf_counter()
        with mock.patch.object(train_mod, "make_train_step", recording):
            report = run_with_restarts(
                lambda i: runs.append(train_mod.train(
                    cfg, ckpt_dir=str(tmp / "run"), ckpt_every=every,
                    fail_at_step=fail if i == 0 else None, **kw)),
                max_restarts=1,
                on_restart=lambda i, e: errors.append(str(e)))
        restart_s = time.perf_counter() - t0
        launches = {name: w.launches for name, w in counters.items()}
        ran = [i for i, _ in taken]
        assert report.restarts == 1 and len(runs) == 1, report
        assert f"injected failure at step {fail}" in errors[0], errors
        assert ran == list(range(fail)) + list(range(every, steps)), ran
        want = {name: per_step.get(name, 0) * len(ran) for name in counters}
        assert launches == want, (launches, want)
        add_path_launches(records, f"train {arch} with a restart "
                                   f"({len(ran)} steps)", launches)
        state, h_res, result = runs[0]
        assert [h["step"] for h in h_res] == list(range(every, steps))

        diffs = []
        for i, metrics in taken:
            for key in ("loss", "grad_norm"):
                got, want_v = float(metrics[key]), h_full[i][key]
                assert math.isfinite(got), (i, key, got)
                diffs.append(abs(got - want_v))
        full_leaves = dict(checkpointer.flatten_with_keys(full))
        state_diff = max(_max_diff(leaf, full_leaves[key]) for key, leaf in
                         checkpointer.flatten_with_keys(state))
        print(f"[ckpt] {arch} full width, global batch {batch} x {seq}, "
              f"{steps} steps: uninterrupted {full_s:.2f} s; with a "
              f"checkpoint every {every} and a failure before step {fail}: "
              f"{report.restarts} restart, steps {ran}, {restart_s:.2f} s; "
              f"launches {launches}; loss and grad norm of every step vs the "
              f"uninterrupted run: largest difference {max(diffs):.3e}"
              f"{' (bit-identical)' if max(diffs) == 0 else ''}; final "
              f"params, moments and counts: largest difference "
              f"{state_diff:.3e}"
              f"{' (bit-identical)' if state_diff == 0 else ''} "
              f"(held to {TOL[torch.float32]} where not equal); on disk "
              f"{sorted(os.listdir(tmp / 'run'))}")
        assert max(diffs) <= TOL[torch.float32], diffs
        assert state_diff <= TOL[torch.float32], state_diff
        del full, full_leaves

        loop = result.regions["train_loop"]
        loop.host.validate(tol=1e-6)
        hs = loop.host_states[0]
        assert hs["mpi"] > 0, hs
        print(f"[talp] {arch} resumed train_loop (steps {every}-{steps - 1}, "
              f"one save in it): Host PE {loop.host.parallel_efficiency:.4f}"
              f", MPI PE {loop.host.mpi_parallel_efficiency:.4f} (useful "
              f"{hs['useful']:.6f} s, offload {hs['offload']:.6f} s, mpi "
              f"{hs['mpi']:.6f} s), Offload Eff. "
              f"{loop.host.device_offload_efficiency:.4f}")

        # one more save, timed, and its restore onto the card
        snap = host_snapshot(state)
        manager = CheckpointManager(str(tmp / "timed"))
        t0 = time.perf_counter()
        manager.save(steps - 1, state)
        sync_s = time.perf_counter() - t0
        manager.wait()
        write_s = time.perf_counter() - t0 - sync_s
        files = list((tmp / "timed" / f"step_{steps - 1}").iterdir())
        nbytes = sum(f.stat().st_size for f in files)
        t0 = time.perf_counter()
        restored = checkpointer.restore_checkpoint(
            str(tmp / "timed"), steps - 1, state,
            train_state_devices(state, device))
        torch.cuda.synchronize(device)
        restore_s = time.perf_counter() - t0
        snap_leaves = dict(checkpointer.flatten_with_keys(snap))
        for key, leaf in checkpointer.flatten_with_keys(restored):
            assert leaf.device.type == ("cuda" if leaf.is_floating_point()
                                        else "cpu"), key
            assert torch.equal(leaf.cpu(), snap_leaves[key]), key
        print(f"[ckpt] save of the {arch} train state: synchronous part (the "
              f"host snapshot) {sync_s:.3f} s, writer thread {write_s:.3f} s,"
              f" {nbytes / 1e9:.3f} GB in {len(files)} files "
              f"({nbytes / 1e9 / max(write_s, 1e-9):.2f} GB/s); restore onto "
              f"the card {restore_s:.3f} s, bit-identical to the host "
              f"snapshot it was written from")
        del state, snap, restored
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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
FLEET = ("mamba2-130m", 2, 6, 8, 4096,
         {**ssm_layers(24, train=True), **ADAMW_STEP})


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


# The mesh phase: llama3.2-3b's train steps and zamba2-2.7b's decode steps
# on a one-rank ("data", "model") mesh, sharded as the partition plan says.
MESH_TRAIN = ("llama3.2-3b", 3, 2, 2048,
              {"flash_attention_fwd": 56, "flash_attention_bwd": 28,
               **ADAMW_STEP})
MESH_DECODE = ("zamba2-2.7b", 8, 4096, 16)
# How much further from the fp32 gradient (in norm, leaf by leaf) the
# sharded bf16 step's gradient may lie than the unsharded bf16 step's:
# four bf16 roundings (2^-8 each), for the partial sums a sharded step
# rounds to bf16 before it reduces them. A fault in a gradient (a partial
# sum dropped or counted twice) moves a leaf by a large part of its norm.
MESH_BF16_EXTRA = 2.0 ** -6


def _place_in(tree, specs, mesh) -> None:
    """Replace each leaf of ``tree`` by its DTensor on ``mesh``, one leaf at
    a time (the old leaf is dropped as its DTensor is made, so the card
    never holds two copies of the state)."""
    from repro_torch.sharding.partition import distribute_tree

    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            _place_in(leaf, specs[key], mesh)
        else:
            tree[key] = distribute_tree(leaf, mesh, specs[key])


def mesh_phase(device: torch.device, records: dict) -> None:
    """The partition plan executed on DeviceMesh and DTensor: a one-rank
    NCCL process group (``tcp://localhost``, a free port) and a (1, 1)
    ("data", "model") mesh (``launch.mesh.make_mesh``); the card holds one
    rank, so this shows the sharded path on the card with its kernels under
    it, not a speed over cards.

    (a) llama3.2-3b at full width through ``make_train_step`` (its default
    AdamW), each run from the same seed, unsharded and with the state
    placed by ``state_shardings`` and each batch by ``batch_pspec``. One
    step of 2 x 2048 tokens in fp32 compute each way, its attention the
    plain version on the card (the flash kernels take bf16 only): the
    sharded first moments (the clipped gradients) within TOL[fp32] of the
    unsharded ones leaf by leaf, each relative to its own norm; the
    sharded parameters equal to p0 moved by AdamW from the run's own
    moments. Then 3 steps in
    bf16 compute each way: the loss at every step within 1e-3; step 1's
    first moments of each run against the fp32 ones leaf by leaf, the
    sharded run no further from them than the unsharded run plus
    ``MESH_BF16_EXTRA``; the parameters after the last step at TOL[fp32];
    the flash launches equal (56 and 28 a step); both step times printed
    (their gap is DTensor's host cost).

    (b) zamba2-2.7b at full width, 8 requests of 4096 prompt tokens
    (prefilled unsharded) and 16 decode steps through ``make_serve_step``,
    unsharded and with parameters placed by ``param_pspec`` and caches by
    ``cache_pspec`` on the mesh, both fed the unsharded run's tokens: each
    step's logits per row (``row_rel_err``) within TOL[bf16]."""
    import socket

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.launch.mesh import describe_mesh, make_mesh
    from repro_torch.launch.serve import make_prompts
    from repro_torch.launch.steps import (init_train_state, make_prefill_step,
                                          make_serve_step, make_train_step)
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding.partition import (
        batch_pspec, cache_pspec, distribute_tree, make_sharding_tree,
        param_pspec, state_shardings)

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device.type)
        counters = launch_counters()

        arch, steps, batch, seq, per_step = MESH_TRAIN
        cfg = get_config(arch)
        # make_train_step's default AdamW (warmup 100, so lr 3e-6 to 9e-6
        # over these steps), as tests/test_distribution.py's step
        opt = AdamWConfig()
        data = SyntheticTokenPipeline(DataConfig(batch, seq, cfg.vocab_size))

        def batch_at(i, sharded):
            b = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch_at(i).items()}
            if sharded:
                _place_in(b, {k: batch_pspec(mesh, v.shape[0], v.ndim)
                              for k, v in b.items()}, mesh)
            return b

        def fresh_state(cfg_, sharded):
            gen = torch.Generator(device=device).manual_seed(0)
            state = init_train_state(cfg_, gen, device=device)
            if sharded:
                _place_in(state, state_shardings(state, mesh, cfg_), mesh)
            return state

        def gathered(tree, sharded):
            for name, t in _named_leaves(tree):
                yield name, (t.full_tensor() if sharded else t)

        # One step in fp32 compute each way, attention by the plain version
        # in the flash kernels' place (they take bf16 only): the sharded
        # first moments (0.1 times the clipped gradient) against the
        # unsharded ones leaf by leaf, each relative to its own norm, at
        # TOL[fp32]; the sharded parameters equal p0 moved by AdamW from
        # the run's own moments (the update is 3e-6, so the parameters
        # alone would pass whatever the gradients were). The unsharded
        # moments are kept as the exact gradient for the bf16 runs.
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        exact, fp32_gap, fp32_loss = {}, (0.0, None), {}

        def plain_attention(q, k, v, causal, window, softcap, scale):
            return flash_ref.attention_reference(
                q, k, v, causal=causal, window=window, softcap=softcap,
                scale=scale)

        for sharded in (False, True):
            state = fresh_state(cfg32, sharded)
            with mock.patch.object(flash.FlashAttention, "apply",
                                   plain_attention):
                state, metrics = make_train_step(cfg32, opt)(
                    state, batch_at(0, sharded))
            loss = metrics["loss"]
            fp32_loss[sharded] = float(loss.full_tensor() if sharded
                                       else loss)
            lr = float(metrics["lr"])
            del metrics
            for name, m in gathered(state["opt"]["mu"], sharded):
                if not sharded:
                    exact[name] = m.cpu()
                    continue
                d = rel_norm(m, exact[name].to(device))
                assert d <= TOL[torch.float32], ("fp32 mu", name, d)
                fp32_gap = max(fp32_gap, (d, name))
            if sharded:
                p0 = dict(_named_leaves(lm.init_params(
                    cfg32, torch.Generator(device=device).manual_seed(0),
                    device=device)))
                mu, nu = (dict(gathered(state["opt"][k], True))
                          for k in ("mu", "nu"))
                for name, p in gathered(state["params"], True):
                    want = adamw_first_step(opt, p0.pop(name), mu.pop(name),
                                            nu.pop(name), lr)
                    torch.testing.assert_close(p, want, rtol=2.5e-7,
                                               atol=1e-9, msg=name)
                del p0, mu, nu
            del state
            torch.cuda.empty_cache()
        assert abs(fp32_loss[True] - fp32_loss[False]) < 1e-3, fp32_loss

        # Three steps in bf16 compute (the config's) each way. Step 1's
        # first moments of both runs are held to the fp32 moments leaf by
        # leaf: the unsharded run's distance from them is bf16's own, and
        # the sharded run's may exceed it by MESH_BF16_EXTRA at most.
        runs, ref = {}, {}
        worst = {"params": (0.0, None)}
        dist_un, dist_sh, gap_bf16 = {}, {}, {}

        def held(part, tree, sharded):
            """Keep each leaf of ``tree`` on the host (the unsharded run),
            or hold the sharded run's leaf to it: the parameters at
            TOL[fp32]; step 1's first moments against the fp32 ones (and
            the two runs' bf16 moments' gap from each other, printed)."""
            for name, t in gathered(tree, sharded):
                if part == "grads":
                    d = rel_norm(t.float(), exact[name].to(device))
                    if not sharded:
                        dist_un[name] = d
                        ref[part, name] = t.to("cpu", torch.bfloat16)
                        continue
                    dist_sh[name] = d
                    assert d <= dist_un[name] + MESH_BF16_EXTRA, (
                        name, d, dist_un[name])
                    gap_bf16[name] = rel_norm(
                        t.to(torch.bfloat16).float(),
                        ref.pop((part, name)).to(device).float())
                    continue
                if not sharded:
                    ref[part, name] = t.to("cpu", torch.float32)
                    continue
                want_t = ref.pop((part, name)).to(device)
                torch.testing.assert_close(t, want_t, rtol=TOL[torch.float32],
                                           atol=TOL[torch.float32])
                worst["params"] = max(worst["params"], (
                    (t - want_t).abs().max().item(), name))
                del want_t

        step_fn = make_train_step(cfg, opt)
        for sharded in (False, True):
            state = fresh_state(cfg, sharded)
            for wrapper in counters.values():
                wrapper.launches = 0
            losses, times = [], []
            for i in range(steps):
                b = batch_at(i, sharded)
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                state, metrics = step_fn(state, b)
                loss = metrics["loss"]
                loss = float(loss.full_tensor() if sharded else loss)
                times.append(time.perf_counter() - t0)
                losses.append(loss)
                del b, metrics
                if i == 0:
                    held("grads", state["opt"]["mu"], sharded)
            launches = {n: w.launches for n, w in counters.items()}
            want = {n: per_step.get(n, 0) * steps for n in counters}
            assert launches == want, (sharded, launches, want)
            runs[sharded] = (losses, times, launches)
            held("params", state["params"], sharded)
            del state
            torch.cuda.empty_cache()
        del exact
        (l0, t0s, n0), (l1, t1s, n1) = runs[False], runs[True]
        for i, (a, b) in enumerate(zip(l0, l1)):
            assert math.isfinite(a) and abs(a - b) < 1e-3, (i, a, b)
        print(f"[mesh] {describe_mesh(mesh)} NCCL mesh, {arch} full width, "
              f"{steps} AdamW steps of {batch} x {seq}: losses unsharded "
              + "/".join(f"{x:.6f}" for x in l0) + ", sharded "
              + "/".join(f"{x:.6f}" for x in l1) + f" (largest difference "
              f"{max(abs(a - b) for a, b in zip(l0, l1)):.3e}, bound 1e-3); "
              f"parameters after step {steps}: largest difference "
              f"{worst['params'][0]:.3e} ({worst['params'][1]}; tol "
              f"{TOL[torch.float32]}); launches "
              f"{n1} as unsharded ({n0})")
        print(f"[mesh] step time unsharded " + "/".join(
            f"{x * 1e3:.3f}" for x in t0s) + " ms, sharded " + "/".join(
            f"{x * 1e3:.3f}" for x in t1s) + f" ms (steps 2-{steps}: "
            f"{statistics.median(t0s[1:]) * 1e3:.3f} vs "
            f"{statistics.median(t1s[1:]) * 1e3:.3f} ms, the gap DTensor's "
            "host cost on one rank)")
        top = sorted(gap_bf16, key=gap_bf16.get, reverse=True)
        print(f"[mesh] step 1's gradients (first moments), leaf by leaf, "
              f"each relative to its own norm: fp32 compute, sharded against "
              f"unsharded, largest {fp32_gap[0]:.3e} ({fp32_gap[1]}; tol "
              f"{TOL[torch.float32]}; losses {fp32_loss[False]:.6f} and "
              f"{fp32_loss[True]:.6f}; parameters equal p0 moved by AdamW "
              f"from the sharded run's moments); bf16 compute, distance from "
              f"the fp32 gradient unsharded / sharded (bound: unsharded + "
              f"{MESH_BF16_EXTRA}), largest {max(dist_un.values()):.3e} / "
              f"{max(dist_sh.values()):.3e}, sharded further by at most "
              f"{max(dist_sh[n] - dist_un[n] for n in dist_un):.3e}; the two "
              f"bf16 runs apart, leaf by leaf: " + ", ".join(
                  f"{gap_bf16[n]:.3e} ({n}: {dist_un[n]:.3e} / "
                  f"{dist_sh[n]:.3e} from fp32)" for n in top))
        add_path_launches(records, f"mesh {arch} ({steps} sharded steps)", n1)
        del runs

        arch, requests, prompt_len, gen_len = MESH_DECODE
        cfg = get_config(arch)
        with torch.no_grad():
            gen = torch.Generator(device=device).manual_seed(0)
            params = lm.init_params(cfg, gen, device=device,
                                    dtype=torch.bfloat16)
            prompts = make_prompts(cfg, requests, prompt_len, gen, device)
            logits, caches, pos = make_prefill_step(cfg)(params, prompts)
            caches = lm.grow_caches(cfg, caches, prompt_len + gen_len)
            tok = logits[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
            sharded_caches = lm.tree_map(lambda t: t.clone(), caches)
            decode = make_serve_step(cfg)
            want, toks = [], []
            p, c = pos.clone(), caches
            t_plain = time.perf_counter()
            for _ in range(gen_len):
                toks.append(tok)
                out, c, p = decode(params, tok[:, None], p, c)
                want.append(out)
                tok = out[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
            torch.cuda.synchronize(device)
            t_plain = time.perf_counter() - t_plain
            del caches, c
            sp = lm.tree_map(lambda t: t, params)   # new dicts, same leaves
            _place_in(sp, make_sharding_tree(params, mesh, cfg, param_pspec),
                      mesh)
            _place_in(sharded_caches, make_sharding_tree(
                sharded_caches, mesh, cfg, cache_pspec), mesh)
            tok_spec, pos_spec = (batch_pspec(mesh, requests, n)
                                  for n in (2, 1))
            p = distribute_tree(pos.clone(), mesh, pos_spec)
            c = sharded_caches
            errs = []
            t_mesh = time.perf_counter()
            for i in range(gen_len):
                out, c, p = decode(sp, distribute_tree(
                    toks[i][:, None].contiguous(), mesh, tok_spec), p, c)
                errs.append(row_rel_err(out.full_tensor(), want[i]))
            torch.cuda.synchronize(device)
            t_mesh = time.perf_counter() - t_mesh
        assert max(errs) <= TOL[torch.bfloat16], errs
        print(f"[mesh] {describe_mesh(mesh)} NCCL mesh, {arch} full width, "
              f"{cfg.num_layers} layers, {requests} requests x {prompt_len} "
              f"prompt + {gen_len} decode steps: sharded logits per row "
              f"against unsharded, largest {max(errs):.3e} (tol "
              f"{TOL[torch.bfloat16]}); decode {t_plain * 1e3 / gen_len:.3f} "
              f"ms/step unsharded, {t_mesh * 1e3 / gen_len:.3f} ms/step "
              "sharded")
        del params, sp, sharded_caches, c, want
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


# The dry run's one-card cells (arch, step kind, sequence length, batch):
# the steps the phases above measured on the card, each predicted on a
# (1, 1) mesh over one fake rank at the full stack's count.
DRYRUN_ONE_CARD = [
    ("llama3.2-3b", "train", 2048, 2),
    ("llama3.2-3b", "prefill", 1024, 8),
    ("llama3.2-3b", "decode", 1088, 8),    # 1024 prompt + 64 generated
    ("zamba2-2.7b", "train", 4096, 2),
    ("granite-moe-3b-a800m", "train", 2048, 2),
]
# Calibrated production cells through the dry run's CLI (arch, shape,
# multi-pod): a training cell on 16x16, qwen3-moe-235b-a22b (438 GiB of
# bf16 weights, which no card holds) on 16x16, and a 2x16x16 cell; each
# the cheapest of its kind (decode cells run no activation sharding, whose
# strided shards DTensor plans slowly on three mesh dims).
DRYRUN_PRODUCTION = [
    ("llama3.2-3b", "train_4k", False),
    ("qwen3-moe-235b-a22b", "decode_32k", False),
    ("mamba2-130m", "decode_32k", True),
]
# The band a predicted peak must fall in, as a multiple of the measured
# max_memory_allocated of the same step.
PEAK_BAND = (0.8, 1.25)
DRYRUN_TIMEOUT = 600


def dryrun_worker(out: str) -> int:
    """The one-card cells of DRYRUN_ONE_CARD, in this process (a fake
    process group of one rank: it must not meet another group), written to
    ``out`` as JSON with each cell's seconds."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.dryrun import run_cell

    cells = []
    for arch, kind, seq, batch in DRYRUN_ONE_CARD:
        t0 = time.perf_counter()
        res = run_cell(arch, ShapeConfig(f"{kind}_{batch}x{seq}", seq, batch,
                                         kind),
                       verbose=False, calibrate=False, device="cuda",
                       mesh=((1, 1), ("data", "model")))
        cells.append({"arch": arch, "kind": kind, "seconds":
                      time.perf_counter() - t0, "result": res})
    Path(out).write_text(json.dumps(cells))
    return 0


def dryrun_phase(measured: dict) -> None:
    """The dry run (``repro_torch.launch.dryrun``) on fake process groups,
    in subprocesses of their own, run side by side: no fake group meets
    the NCCL group of ``mesh_phase`` and nothing is allocated on the card.

    (a) DRYRUN_ONE_CARD on a (1, 1) "cuda" mesh against what this run
    measured of the same steps (``measured``, by (arch, kind): the median
    step, the traced step's kernel time, max_memory_allocated and TALP's
    device metrics). Fails if a predicted kernel time (max of the compute
    and HBM terms) exceeds the measured kernel time, or a predicted peak
    (arguments and the step's live tensors) lies outside PEAK_BAND times
    the measured one.

    (b) DRYRUN_PRODUCTION through ``python -m repro_torch.launch.dryrun``
    (calibrated, each cell's JSON written under a temporary directory):
    every cell must come back ``ok``; its JSON line and seconds printed."""
    out = Path(tempfile.mkdtemp(prefix="dryrun_"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    commands = {"one-card": [sys.executable, str(Path(__file__).resolve()),
                             "--dryrun-worker", str(out / "one_card.json")]}
    for arch, shape, multi_pod in DRYRUN_PRODUCTION:
        commands[arch, shape, multi_pod] = [
            sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
            "--shape", shape, "--out", str(out)] + (
            ["--multi-pod"] if multi_pod else [])
    procs, seconds = {}, {}
    t0 = time.perf_counter()
    try:
        for key, cmd in commands.items():
            log = out / (("_".join(map(str, key)) if isinstance(key, tuple)
                          else key) + ".log")
            with open(log, "w") as f:   # DTensor warns at length: a file
                procs[key] = (subprocess.Popen(
                    cmd, env=env, stdout=f, stderr=subprocess.STDOUT), log)
        while len(seconds) < len(procs):
            assert time.perf_counter() - t0 < DRYRUN_TIMEOUT, (
                "dry-run cells still running", sorted(
                    map(str, set(procs) - set(seconds))))
            for key, (proc, log) in procs.items():
                if key not in seconds and proc.poll() is not None:
                    seconds[key] = time.perf_counter() - t0
                    assert proc.returncode == 0, (
                        key, log.read_text()[-4000:])
            time.sleep(0.5)
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0

    cells = json.loads((out / "one_card.json").read_text())
    for cell in cells:
        res, key = cell["result"], (cell["arch"], cell["kind"])
        got = measured[key]
        assert res["status"] == "ok", res
        assert got["busy_s"], f"{key}: the profiler measured no kernel time"
        kernel_s = max(res["compute_s"], res["memory_s"])
        peak = res["memory_analysis"]["peak_memory"]
        ratio = peak / got["peak"]
        print(f"[dryrun] {cell['arch']} {cell['kind']} {res['shape']} on "
              f"{res['mesh']} ({cell['seconds']:.1f} s): predicted compute "
              f"{res['compute_s'] * 1e3:.3f} ms, memory "
              f"{res['memory_s'] * 1e3:.3f} ms, kernel {kernel_s * 1e3:.3f} "
              f"ms, collective {res['collective_s'] * 1e3:.3f} ms, dominant "
              f"{res['dominant']}, peak {peak / 2**30:.3f} GiB (arguments "
              f"{res['argument_size'] / 2**30:.3f}, temp "
              f"{res['temp_size'] / 2**30:.3f}); measured step "
              f"{got['step_s'] * 1e3:.3f} ms, kernel time "
              f"{got['busy_s'] * 1e3:.3f} ms, max_memory_allocated "
              f"{got['peak'] / 2**30:.3f} GiB; predicted kernel / measured "
              f"kernel {kernel_s / got['busy_s']:.4f}, peak ratio "
              f"{ratio:.4f} (band {PEAK_BAND}); FLOPs {res['flops']:.4e} "
              f"(model {res['model_flops']:.4e}), HBM bytes "
              f"{res['hbm_bytes']:.4e}")
        print(f"[dryrun]   TALP device predicted {json.dumps(res['talp_device'])}"
              f" | measured {json.dumps(got['device'])}")
        assert kernel_s <= got["busy_s"], (
            f"{key}: a roofline above what the card did is a counting fault",
            kernel_s, got["busy_s"])
        assert PEAK_BAND[0] <= ratio <= PEAK_BAND[1], (key, peak, got["peak"])
    for key in commands:
        if key == "one-card":
            continue
        arch, shape, multi_pod = key
        [path] = [p for p in out.glob(f"{arch}__{shape}__*.json")
                  if ("2podx" in p.name) == multi_pod]
        res = json.loads(path.read_text())
        assert res["status"] == "ok", res
        assert res["collective_bytes"] > 0, res
        print(f"[dryrun] {arch} x {shape} x {res['mesh']}: process "
              f"{seconds[key]:.1f} s; " + json.dumps(res))
    print(f"[dryrun] phase wall {wall:.1f} s (one-card worker "
          f"{seconds['one-card']:.1f} s; cells "
          + ", ".join(f"{c['arch']} {c['kind']} {c['seconds']:.1f}"
                      for c in cells) + ")")
    shutil.rmtree(out)


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
                           ssd_backward_phase(device), *adamw_phase(device),
                           *conv_phase(device))}
    for name, counts in sass.items():
        records[name]["sass"] = counts
    zamba7 = zamba7_phase(device)
    for name, key in (("flash_attention_fwd", "fwd"),
                      ("flash_attention_bwd", "bwd"), ("ssd_fwd", "ssd_fwd"),
                      ("ssd_bwd", "ssd_bwd")):
        records[name]["zamba2_7b_train_shape"] = zamba7[key]
    torch.cuda.empty_cache()
    conv_cells_check(device)
    mark("kernel phases")
    path_check(device)
    mamba_path_check(device)
    zamba_path_check(device)
    granite_path_check(device)
    embed_path_check(device)
    windowed_path_check(device)
    train_path_check(device)
    mark("path checks")
    busy_by_arch = {}
    # what the dry run's one-card cells are held to, by (arch, step kind)
    measured = {}
    for arch, requests, prompt_len, gen_len, expected, layers in SERVE:
        talp = serve_phase(device, arch, requests, prompt_len, gen_len,
                           expected, layers, records)
        torch.cuda.empty_cache()
        busy, peaks = profile_phase(device, arch, requests, prompt_len,
                                    gen_len, layers)
        busy_by_arch[arch] = busy
        for region, step in (("prefill", "prefill"), ("decode", "decode_step")):
            compare_pe(f"{arch} {region}", *talp[region], busy.get(step))
            measured[arch, region] = {
                "step_s": talp[region][1], "busy_s": busy.get(step),
                "peak": peaks[step], "device": talp["device"][region]}
        torch.cuda.empty_cache()
    mark("serve and profile")
    train_refusal_check(device)
    for row in TRAIN:
        measured[row[0], "train"] = train_phase(device, *row, records)
        torch.cuda.empty_cache()
    mark("training")
    checkpoint_phase(device, records)
    torch.cuda.empty_cache()
    mark("checkpoint and restart")
    talp_flags_phase(device, busy_by_arch[TALP_FLAGS_RUN[0]].get(
        "decode_step"), records)
    mark("TALP flags")
    fleet_phase(device, records)
    mark("fleet")
    mesh_phase(device, records)
    torch.cuda.empty_cache()
    mark("mesh")
    dryrun_phase(measured)
    mark("dry run")
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
    if sys.argv[1:2] == ["--dryrun-worker"]:
        sys.exit(dryrun_worker(sys.argv[2]))
    sys.exit(main())
