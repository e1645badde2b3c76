"""GPU smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, and builds the CUDA kernels from the sources in this
   checkout, timing the build.
2. Kernel phase: the hand-written flash-attention forward against its
   plain PyTorch version on the card, over the shapes of the JAX
   package's kernel sweep, ragged shapes, and the serving prefill shape
   of llama3.2-3b (B 8, S 1024, H 24, K 8, D 128, bf16). At that shape it
   times the kernel, the plain version and one PyTorch library call
   (``scaled_dot_product_attention``, a yardstick only) with CUDA events.
3. Serve phase: ``repro_torch.launch.serve.serve`` on llama3.2-3b at full
   width (random weights from a seed), 8 requests of 1024 prompt tokens
   and 64 generated tokens, under the TALP monitor. Checks the tokens,
   that the prefill went through the flash kernel once per layer, and the
   TALP hierarchies.
4. Profile phase: one prefill and one decode step at the serve phase's
   shapes, timed without the profiler and traced with ``torch.profiler``:
   the card's busy share of each step and its heaviest kernels.
5. Prints one JSON line with every kernel's numbers, then, as the last
   line, ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no
result line. Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
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
PREFILL = (8, 1024, 1024, 24, 8, 128, None, None, torch.bfloat16)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median over ``reps`` runs of one call, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def kernel_phase(device: torch.device) -> dict:
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.flash_attention import kernel, ref

    t0 = time.perf_counter()
    kernel.library()
    print(f"[build] flash_fwd.cu in {time.perf_counter() - t0:.1f} s "
          f"({cuda_build.BUILD_DIR})")
    for log in sorted(cuda_build.BUILD_DIR.glob("flash_fwd-*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"[ptxas] {line.strip()}")

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
    kernel_ms = time_ms(lambda: kernel.flash_attention(q, kk, vv))
    plain_ms = time_ms(lambda: ref.attention_reference(q, kk, vv), reps=20)
    # The library yardstick takes (B, H, S, D); the layout change is made
    # once, outside the timing.
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kk, vv))
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    flops, nbytes = attention_work(b, s, t, h, k, d, window, dtype)
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    print(f"[kernel] prefill shape: kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
          f"{max(t_ops, t_bytes):.4f} ms ({flops / 1e9:.2f} GFLOP, "
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


def path_check(device: torch.device) -> None:
    """The model path on the card against the same path on the CPU (plain
    attention), on a small input: two layers of llama3.2-3b's block
    shape cut narrow (head_dim 128 and GQA 3:1 kept, so the kernel
    runs), the same bf16 weights on both, prefill then 4 decode steps.
    rtol = atol = 0.15 on the fp32 logits, the bf16 tolerance of
    tests/test_torch_lm.py."""
    import dataclasses

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


def serve_phase(device: torch.device, record: dict) -> None:
    """Full-width llama3.2-3b serving through the port's entry point."""
    from repro_torch.configs import get_config
    from repro_torch.core.report import render_tables
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.launch.serve import serve

    cfg = get_config("llama3.2-3b")
    requests, prompt_len, gen_len = 8, 1024, 64
    # decode writes only the hot ring; past it the oldest generated
    # context is overwritten, as in the JAX serve loop
    assert gen_len <= cfg.decode_hot_len
    kernel.flash_attention.launches = 0
    t0 = time.perf_counter()
    tokens, result = serve(cfg, requests=requests, prompt_len=prompt_len,
                           gen_len=gen_len, seed=0, verbose=False,
                           device=device)
    wall = time.perf_counter() - t0
    launches = kernel.flash_attention.launches
    assert tokens.shape == (requests, gen_len), tokens.shape
    assert (tokens >= 0).all() and (tokens < cfg.vocab_size).all()
    assert launches == cfg.num_layers, (
        f"flash kernel launched {launches} times in one prefill, want "
        f"{cfg.num_layers} (one per layer)")
    glob, dec = result.regions["Global"], result.regions["decode"]
    glob.host.validate(tol=1e-6)
    dec.host.validate(tol=1e-6)
    glob.device.validate(tol=1e-6)
    assert dec.device_states[0]["kernel"] > 0
    assert result.regions["prefill"].device_states[0]["kernel"] > 0
    print(render_tables(result))
    prefill_ms = result.regions["prefill"].elapsed * 1e3
    tok_s = requests * gen_len / dec.elapsed
    print(f"[serve] llama3.2-3b full width, {requests} requests x "
          f"{prompt_len} prompt + {gen_len} generated: prefill "
          f"{prefill_ms:.3f} ms, decode {tok_s:.1f} tok/s "
          f"({dec.elapsed * 1e3 / gen_len:.3f} ms/step), wall {wall:.2f} s, "
          f"flash launches {launches}")
    for name in ("Global", "prefill", "decode"):
        r = result.regions[name]
        hs, ds = r.host_states[0], r.device_states[0]
        print(f"[talp] {name}: Host PE {r.host.parallel_efficiency:.4f} "
              f"(useful {hs['useful']:.6f} s, offload {hs['offload']:.6f} s)"
              f" | Device PE {r.device.parallel_efficiency:.4f} (kernel "
              f"{ds['kernel']:.6f} s, idle {ds['idle']:.6f} s)")
    record["launches"] = launches
    record["launches_on_path"] = launches


def profile_phase(device: torch.device) -> None:
    """Where the serving time goes on the card: one prefill and one
    decode step of full-width llama3.2-3b (the serve phase's shapes), each
    timed on the host clock without the profiler, then traced once with
    ``torch.profiler`` for the device time of every kernel. The TALP
    device records of the serve phase span each step's first and last
    CUDA event, so they count the card's gaps between kernels as busy;
    the trace shows the share of the step the card really computes."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = get_config("llama3.2-3b")
    gen = torch.Generator(device=device).manual_seed(1)
    with torch.inference_mode():
        params = lm.init_params(cfg, gen, device=device, dtype=torch.bfloat16)
        prompts = torch.randint(0, cfg.vocab_size, (8, 1024), generator=gen,
                                device=device, dtype=torch.int32)
        logits, caches, pos = lm.prefill(cfg, params, prompts)
        caches = lm.grow_caches(cfg, caches, 1024 + 64)
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        steps = {
            "prefill": lambda: lm.prefill(cfg, params, prompts),
            # rewrites the same hot-ring slot each time: same work per call
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
                print(f"[profile] {name}: wall {wall * 1e3:.3f} ms (median of "
                      "5); torch.profiler shows no device time here, so the "
                      "busy share is not measured")
                continue
            print(f"[profile] {name}: wall {wall * 1e3:.3f} ms (median of 5, "
                  f"no profiler), device kernel time {busy * 1e3:.3f} ms in "
                  f"{n_launch} kernels, busy share {busy / wall:.4f}")
            for e in sorted(kernels, key=dev_time, reverse=True)[:6]:
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
    record = kernel_phase(device)
    path_check(device)
    serve_phase(device, record)
    profile_phase(device)
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
