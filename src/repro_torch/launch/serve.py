"""Batched serving: prefill + decode loop under TALP monitoring.
Port of ``repro.launch.serve``.

Requests are prompt batches; the loop prefills the batch, grows the
caches, then decodes tokens greedily. Host and device states are
TALP-monitored as in ``repro.launch.serve``: ``backend.launch`` (in eager
PyTorch, the host enqueueing every kernel of the step) runs outside
``mon.offload()`` and counts as host Useful; ``backend.wait`` runs
inside it. On the card, device Kernel and Memory records come from CUPTI
activity, one per kernel, memcpy and memset
(:class:`repro_torch.core.backends.CudaRuntimeBackend`), so no profiler
may be open while ``serve`` runs.

TALP's runtime outputs are those of ``repro.launch.serve``: the
``--talp-*`` flags (step series and watchdog per decoded token in a
nested ``decode_step`` region, snapshots every N tokens, Chrome trace,
JSONL and Prometheus streams, the per-rank spool and the job-level merge,
fault injection) and ``--rank``/``--world-size`` for a fleet of serving
processes (:mod:`repro_torch.launch.talp_outputs`). The decode-shape FLOP
estimate over ``world_size`` feeds the measured Computational
Efficiency when a step series is on.

Runs on ``cuda`` unless ``device="cpu"`` is asked for; without a card it
raises instead of running on the CPU. On the card a config must compute in
bf16 (:func:`check_dtype_on_card`); the CPU serves fp32 and bf16 through
the plain versions.

An ``embed``-frontend model (musicgen-large, qwen2-vl-72b) is served as
``repro.launch.serve`` serves it: its prompts are random bf16 (requests,
prompt_len, d_model) embeddings from the run's generator, and each decode
step feeds a zero frame of (requests, 1, d_model), whatever the last
token was (the JAX stub's behaviour, reproduced).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
      --requests 8 --prompt-len 1024 --gen-len 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
      --smoke --device cpu --requests 2 --prompt-len 16 --gen-len 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-large \
      --requests 8 --prompt-len 1024 --gen-len 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
      --requests 8 --prompt-len 1024 --gen-len 64 --talp-step-series 64 \
      --talp-watchdog --talp-sample-every 16 --talp-spool /tmp/spool \
      --talp-trace-out serve.trace.json --talp-metrics-jsonl serve.jsonl
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..configs import ShapeConfig, get_config, list_configs, smoke_config
from ..core.backends import CudaRuntimeBackend
from ..models import lm
from .steps import make_prefill_step, make_serve_step, model_flops
from .talp_outputs import TalpOutputs, add_talp_arguments, talp_kwargs

__all__ = ["check_dtype_on_card", "resolve_device", "make_prompts", "serve",
           "main"]


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing CUDA when no card is usable."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: want cuda or cpu")
    return dev


def check_dtype_on_card(cfg) -> None:
    """Raise ``ValueError`` unless ``cfg`` computes in bf16: on the card the
    flash, SSD and conv kernels take bf16 activations only. ``serve`` and
    ``train`` call it before any weight is drawn."""
    if cfg.compute_dtype != "bfloat16":
        raise ValueError(
            f"{cfg.name}: compute_dtype {cfg.compute_dtype!r} is not one the "
            "card's kernels take (bfloat16); it runs on the CPU "
            "(device='cpu') through the plain versions")


def make_prompts(cfg, requests: int, prompt_len: int, generator,
                 device) -> torch.Tensor:
    """What ``serve`` prefills: random int32 (requests, prompt_len) tokens,
    or for the ``embed`` frontend random bf16 (requests, prompt_len,
    d_model) frame or patch embeddings, drawn from ``generator``."""
    if cfg.frontend == "token":
        return torch.randint(0, cfg.vocab_size, (requests, prompt_len),
                             generator=generator, device=device,
                             dtype=torch.int32)
    return torch.randn((requests, prompt_len, cfg.d_model),
                       generator=generator, device=device,
                       dtype=torch.bfloat16)


def serve(
    cfg,
    requests: int = 4,
    prompt_len: int = 32,
    gen_len: int = 16,
    seed: int = 0,
    talp_json: str = None,
    verbose: bool = True,
    device="cuda",
    rank: int = 0,
    world_size: int = 1,
    talp_spool: str = None,
    talp_sample_every: int = 0,
    talp_spool_format: str = "binary",
    talp_trace_out: str = None,
    talp_metrics_jsonl: str = None,
    talp_prometheus_port: int = None,
    talp_step_series: int = 0,
    talp_watchdog: bool = False,
    talp_anomaly_log: str = None,
    talp_fault_plan=None,
):
    """Serve one batch of ``requests`` random prompts of ``prompt_len``
    tokens and generate ``gen_len`` tokens each. Returns (tokens (requests,
    gen_len) int32 NumPy, TalpResult).

    The ``rank`` .. ``talp_fault_plan`` keywords are those of
    ``repro.launch.serve.serve``: a fleet of serving processes passes
    ``rank``/``world_size`` and a shared ``talp_spool`` for one job-level
    report; ``talp_sample_every=N`` snapshots every N decoded tokens; the
    step series and watchdog run per decoded token.

    Decode writes only the hot ring of ``cfg.decode_hot_len`` slots, so,
    as in ``repro.launch.serve``, generated tokens beyond that many lose the
    oldest generated context (see :func:`repro_torch.models.lm.grow_caches`).
    """
    if torch.device(device).type == "cuda":
        check_dtype_on_card(cfg)
    dev = resolve_device(device)
    backend = CudaRuntimeBackend(dev)
    shape = ShapeConfig(name="serve", seq_len=prompt_len + gen_len,
                        global_batch=requests, kind="decode")
    talp = TalpOutputs(
        "serve", backend, "decode_step", lambda: model_flops(cfg, shape),
        verbose=verbose, rank=rank, world_size=world_size,
        talp_spool=talp_spool, talp_sample_every=talp_sample_every,
        talp_spool_format=talp_spool_format, talp_trace_out=talp_trace_out,
        talp_metrics_jsonl=talp_metrics_jsonl,
        talp_prometheus_port=talp_prometheus_port,
        talp_step_series=talp_step_series, talp_watchdog=talp_watchdog,
        talp_anomaly_log=talp_anomaly_log, talp_fault_plan=talp_fault_plan)
    mon = talp.mon
    gen = torch.Generator(device=dev).manual_seed(seed)

    with torch.inference_mode():
        with mon.region("init"):
            # bf16 serving weights, drawn and cast one tensor at a time
            params = lm.init_params(cfg, gen, device=dev,
                                    dtype=torch.bfloat16)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        prefill_fn = make_prefill_step(cfg)
        decode_fn = make_serve_step(cfg)
        prompts = make_prompts(cfg, requests, prompt_len, gen, dev)
        # the embed frontend's stub decodes on zero frames
        frame = (None if cfg.frontend == "token" else
                 torch.zeros((requests, 1, cfg.d_model), device=dev,
                             dtype=torch.bfloat16))

        tokens_out = []
        with mon.region("prefill"):
            h = backend.launch(prefill_fn, params, prompts, name="prefill")
            with mon.offload():
                logits, caches, pos = backend.wait(h)
        with mon.region("grow_cache"):
            caches = lm.grow_caches(cfg, caches, prompt_len + gen_len)

        tok = logits[:, : cfg.vocab_size].argmax(-1).to(torch.int32)
        with mon.region("decode"):
            for t in range(gen_len):
                with talp.step():
                    tokens_out.append(tok.cpu().numpy())
                    inp = tok[:, None] if cfg.frontend == "token" else frame
                    h = backend.launch(decode_fn, params, inp, pos, caches,
                                       name=f"decode_{t}")
                    with mon.offload():
                        logits, caches, pos = backend.wait(h)
                    tok = logits[:, : cfg.vocab_size].argmax(-1).to(
                        torch.int32)
                talp.sample(t, f"token {t}")

    result = talp.finish(talp_json)
    return np.stack(tokens_out, axis=1), result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_configs(), required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--talp-json", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card fails")
    add_talp_arguments(ap, "decoded token")
    args = ap.parse_args(argv)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    t0 = time.time()
    tokens, _ = serve(cfg, args.requests, args.prompt_len, args.gen_len,
                      seed=args.seed, talp_json=args.talp_json,
                      device=args.device, **talp_kwargs(args))
    dt = time.time() - t0
    n = tokens.size
    print(f"generated {n} tokens in {dt:.2f}s ({n/dt:.1f} tok/s)")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
