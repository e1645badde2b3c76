"""GPU smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, and builds the CUDA kernels from the sources in this
   checkout (one ``nvcc`` per source, all started together), timing the
   build and printing each kernel's ``ptxas -v`` registers and spills.
   Counts the HGMMA (wgmma), UTMALDG (TMA load) and HMMA (mma.sync)
   instructions in each library's SASS (``cuobjdump -sass``) and fails
   unless the flash library has HGMMA and UTMALDG and no HMMA and the SSD
   library has HMMA.
2. Kernel phases: each hand-written kernel against its plain PyTorch
   version on the card, with the tolerance of tests/test_kernels.py::_tol
   printed per row:
   * the flash-attention forward over the shapes of the JAX package's
     kernel sweep, ragged shapes, the edges of the bf16 kernel's tiling,
     and the serving prefill shape of llama3.2-3b (B 8, S 1024, H 24, K 8,
     D 128, bf16); at that shape it times the plain version, then the
     kernel and one PyTorch library call (``scaled_dot_product_attention``,
     a yardstick only) in turns: library, kernel, kernel, library;
   * the SSD chunked scan over the JAX package's SSD sweep, ragged L,
     initial state in and final state out, the edges of the bf16 kernels'
     chunk-parallel form, and the serving prefill shape of mamba2-130m
     (B 8, L 4096, H 24, P 64, G 1, N 128, chunk 256, bf16), against the
     plain version evaluated in float64 on the same inputs (the plain
     version's own fp32 evaluation is printed beside it); at the prefill
     shape it times the plain version and the kernel in turns: plain,
     kernel, kernel, plain (no single PyTorch call computes the scan).
   Timings are CUDA events around runs of back-to-back calls (ms per
   call), medians; kernel and yardstick are timed in turns.
3. Path checks: two narrow layers of each model's block on the card
   against the same layers on the CPU (plain versions), prefill then 4
   decode steps, the same bf16 weights.
4. Serve phases: ``repro_torch.launch.serve.serve`` under the TALP monitor
   at full width, random weights from a seed: llama3.2-3b with 8 requests
   of 1024 prompt tokens and 64 generated tokens, then mamba2-130m (all
   24 layers) with 8 requests of 4096 prompt tokens and 64 generated
   tokens. Every launch counter is set to 0 just before each run and read
   just after: the prefill must go through its model's kernel once per
   layer and through no other. Checks the tokens and the TALP
   hierarchies.
5. Profile phases: one prefill and one decode step of each model at its
   serve phase's shapes, timed without the profiler and traced with
   ``torch.profiler``: the card's busy share of each step and its
   heaviest kernels.
6. Prints one JSON line with every kernel's numbers, then, as the last
   line, ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no
result line. Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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
PREFILL = (8, 1024, 1024, 24, 8, 128, None, None, torch.bfloat16)

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
SSD_PREFILL = (8, 4096, 24, 64, 1, 128, 256, torch.bfloat16, False)


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


def time_turns(first, second, reps: int = 25, inner: int = 10):
    """Medians (ms per call) of ``first`` and ``second`` timed in turns:
    first, second, second, first, ``reps`` samples each turn, so that a
    drift of the card's clock falls on both alike."""
    a = time_samples(first, reps, inner=inner)
    b = (time_samples(second, reps, inner=inner)
         + time_samples(second, reps, inner=inner))
    a += time_samples(first, reps, inner=inner)
    return statistics.median(a), statistics.median(b)


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


KERNEL_NAMES = ("flash_fwd_wgmma", "flash_fwd_f32", "ssd_chunk_state",
                "ssd_state_pass", "ssd_chunk_output", "ssd_fwd_f32")


def _kernel_label(mangled: str) -> str:
    """A readable name for a mangled kernel instantiation."""
    base = re.search("|".join(KERNEL_NAMES), mangled)
    args = re.findall(r"Li(\d+)E", mangled)
    return f"{base.group(0) if base else mangled}<{','.join(args)}>"


def ptxas_summary(log: Path):
    """One line per kernel of a ``ptxas -v`` log: registers and spills."""
    fn, spill = None, ""
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and fn:
            yield f"{_kernel_label(fn)}: {line.split(':', 1)[1].strip()}; " \
                  f"{spill}"
            fn = None


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
    kernel runs wgmma and TMA and no mma.sync, and the SSD kernels run
    mma.sync. Returns each kernel record's SASS counts."""
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.ssd import kernel as ssd

    def timed(source):
        t0 = time.perf_counter()
        lib = cuda_build.build(source)
        return lib, time.perf_counter() - t0

    t0 = time.perf_counter()
    sources = (flash.SOURCE, ssd.SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(timed, sources))
    print(f"[build] {len(sources)} sources in {time.perf_counter() - t0:.1f}"
          f" s ({cuda_build.BUILD_DIR})")
    for source, (lib, secs) in zip(sources, built):
        print(f"[build] {source.name}: {secs:.1f} s")
        for line in ptxas_summary(lib.with_suffix(".log")):
            print(f"[ptxas] {line}")
    flash.library()
    ssd.library()
    counts = {name: sass_counts(lib) for name, (lib, _) in
              zip(("flash_attention_fwd", "ssd_fwd"), built)}
    for name, c in counts.items():
        print(f"[sass] {name}: " + ", ".join(f"{op} {n}" for op, n in c.items()))
    f, s = counts["flash_attention_fwd"], counts["ssd_fwd"]
    assert f["HGMMA"] > 0 and f["UTMALDG"] > 0 and f["HMMA"] == 0, f
    assert s["HMMA"] > 0, s
    return counts


def kernel_phase(device: torch.device) -> dict:
    from repro_torch.kernels.flash_attention import kernel, ref

    def inputs(i, b, s, t, h, k, d, dtype):
        gen = torch.Generator(device=device).manual_seed(1000 + i)
        mk = lambda *shape: torch.randn(  # noqa: E731
            shape, generator=gen, device=device).to(dtype)
        return mk(b, s, h, d), mk(b, t, k, d), mk(b, t, k, d)

    prefill_err = None
    for i, row in enumerate(SWEEP + [PREFILL]):
        b, s, t, h, k, d, window, softcap, dtype = row
        q, kk, vv = inputs(i, b, s, t, h, k, d, dtype)
        out = kernel.flash_attention(q, kk, vv, causal=True, window=window,
                                     softcap=softcap)
        want = ref.attention_reference(q, kk, vv, causal=True, window=window,
                                       softcap=softcap)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        print(f"[kernel] B{b} S{s} T{t} H{h} K{k} D{d} window={window} "
              f"softcap={softcap} {str(dtype)[6:]}: max_abs_err={err:.3e} "
              f"tol={TOL[dtype]}")
        torch.testing.assert_close(out.float(), want.float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])
        if row is PREFILL:
            prefill_err = err

    b, s, t, h, k, d, window, softcap, dtype = PREFILL
    q, kk, vv = inputs(99, b, s, t, h, k, d, dtype)
    plain_ms = statistics.median(time_samples(
        lambda: ref.attention_reference(q, kk, vv), reps=10, inner=2))
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
    print(f"[kernel] prefill shape: kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms (in turns: sdpa, "
          f"kernel, kernel, sdpa), kernel/sdpa {kernel_ms / library_ms:.3f}, "
          f"bound {max(t_ops, t_bytes):.4f} ms ({flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB)")
    return {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:31",
        "replaces_fn": "_flash_kernel",
        "launches": None,
        "launches_on_path": None,
        "max_abs_err": prefill_err,
        "tol": TOL[dtype],
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
        "shape": "B8 S1024 T1024 H24 K8 D128 bf16 causal",
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

    prefill_err = None
    for i, row in enumerate(SSD_SWEEP + [SSD_PREFILL]):
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
        if row is SSD_PREFILL:
            prefill_err = max(err, s_err)
        del x, bm, cm, y, y64, y32, s_out, s64, s32, want

    b, l, h, p, g, n, chunk, dtype, with_state = SSD_PREFILL
    x, dt, a, bm, cm, d, _ = inputs(99, b, l, h, p, g, n, dtype, False)
    # plain and kernel in turns: plain, kernel, kernel, plain
    plain_ms, kernel_ms = time_turns(
        lambda: ref.ssd_reference(x, dt, a, bm, cm, chunk=chunk, d_skip=d,
                                  return_final_state=True),
        lambda: kernel.ssd_scan(x, dt, a, bm, cm, chunk=chunk, d_skip=d,
                                return_final_state=True), reps=10)
    flops, nbytes = ssd_work(b, l, h, p, g, n, chunk, dtype, with_state)
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    nc = -(-l // chunk)
    print(f"[ssd] prefill shape: kernel {kernel_ms:.4f} ms (3 launches), "
          f"plain {plain_ms:.4f} ms (in turns: plain, kernel, kernel, "
          f"plain), no library call, bound {max(t_ops, t_bytes):.4f} ms "
          f"({flops / 1e9:.2f} GFLOP is {t_ops:.4f} ms at the bf16 rate, "
          f"{nbytes / 1e6:.1f} MB is {t_bytes:.4f} ms), {b * nc * h} blocks "
          f"in the chunk passes")
    return {
        "name": "ssd_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd_fwd.cu",
        "replaces": "src/repro/kernels/ssd/kernel.py:30",
        "replaces_fn": "_ssd_kernel",
        "launches": None,
        "launches_on_path": None,
        "max_abs_err": prefill_err,
        "tol": TOL[dtype],
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
        "shape": "B8 L4096 H24 P64 G1 N128 chunk256 bf16, final state out",
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


def launch_counters() -> dict:
    """Each kernel's wrapper, by the name of its JSON record; a wrapper's
    ``launches`` grows by one where it launches its kernel."""
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.ssd import kernel as ssd

    return {"flash_attention_fwd": flash.flash_attention,
            "ssd_fwd": ssd.ssd_scan}


# (arch, requests, prompt tokens, generated tokens, the kernel its prefill
# launches once per layer)
SERVE = [
    ("llama3.2-3b", 8, 1024, 64, "flash_attention_fwd"),
    ("mamba2-130m", 8, 4096, 64, "ssd_fwd"),
]


def serve_phase(device: torch.device, arch: str, requests: int,
                prompt_len: int, gen_len: int, kernel_name: str,
                records: dict) -> None:
    """Full-width serving of ``arch`` through the port's entry point."""
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
    want = {name: cfg.num_layers if name == kernel_name else 0
            for name in counters}
    assert launches == want, (
        f"{arch}: kernel launches {launches} in one prefill, want {want} "
        "(its kernel once per layer)")
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
    records[kernel_name]["launches"] = launches[kernel_name]
    records[kernel_name]["launches_on_path"] = launches[kernel_name]


def profile_phase(device: torch.device, arch: str, batch: int,
                  prompt_len: int, gen_len: int) -> None:
    """Where the serving time goes on the card: one prefill and one
    decode step of full-width ``arch`` (its serve phase's shapes), each
    timed on the host clock without the profiler, then traced once with
    ``torch.profiler`` for the device time of every kernel. The TALP
    device records of the serve phase span each step's first and last
    CUDA event, so they count the card's gaps between kernels as busy;
    the trace shows the share of the step the card really computes."""
    from repro_torch.configs import get_config
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
        for name, step in steps.items():
            step()
            torch.cuda.synchronize()
            walls = []
            for _ in range(5):
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            wall = statistics.median(walls)
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                step()
                torch.cuda.synchronize()
            kernels = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            dev_time = lambda e: getattr(  # noqa: E731
                e, "self_device_time_total",
                getattr(e, "self_cuda_time_total", 0.0))
            busy = sum(dev_time(e) for e in kernels) * 1e-6
            n_launch = sum(e.count for e in kernels)
            if busy <= 0:
                print(f"[profile] {arch} {name}: wall {wall * 1e3:.3f} ms "
                      "(median of 5); torch.profiler shows no device time "
                      "here, so the busy share is not measured")
                continue
            print(f"[profile] {arch} {name}: wall {wall * 1e3:.3f} ms (median"
                  f" of 5, no profiler), device kernel time "
                  f"{busy * 1e3:.3f} ms in {n_launch} kernels, busy share "
                  f"{busy / wall:.4f}")
            ranked = sorted(kernels, key=dev_time, reverse=True)
            # the six heaviest, then every other kernel of this repository
            for e in ranked[:6] + [e for e in ranked[6:]
                                   if re.search("|".join(KERNEL_NAMES), e.key)]:
                print(f"[profile]   {dev_time(e) * 1e-3:9.3f} ms "
                      f"x{e.count:<5d} {e.key[:90]}")
    del params, caches


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
    sass = build_kernels()
    records = {rec["name"]: rec
               for rec in (kernel_phase(device), ssd_kernel_phase(device))}
    for name, counts in sass.items():
        records[name]["sass"] = counts
    path_check(device)
    mamba_path_check(device)
    for arch, requests, prompt_len, gen_len, kernel_name in SERVE:
        serve_phase(device, arch, requests, prompt_len, gen_len, kernel_name,
                    records)
        profile_phase(device, arch, requests, prompt_len, gen_len)
        torch.cuda.empty_cache()
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
