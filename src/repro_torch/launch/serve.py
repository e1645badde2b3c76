"""Batched serving: prefill + decode loop under TALP monitoring.
Port of ``repro.launch.serve``.

Requests are prompt batches; the loop prefills the batch, grows the
caches, then decodes tokens greedily. Host and device states are
TALP-monitored as in ``repro.launch.serve``: ``backend.launch`` (in eager
PyTorch, the host enqueueing every kernel of the step) runs outside
``mon.offload()`` and counts as host Useful; ``backend.wait`` runs
inside it. On the card, device Kernel and Memory records come from CUPTI
activity, one per kernel, memcpy and memset, collected through
``torch.profiler`` (:class:`repro_torch.core.backends.CudaRuntimeBackend`),
so no other profiler may be open while ``serve`` runs.

Runs on ``cuda`` unless ``device="cpu"`` is asked for; without a card it
raises instead of running on the CPU.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
      --requests 8 --prompt-len 1024 --gen-len 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
      --smoke --device cpu --requests 2 --prompt-len 16 --gen-len 4
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..configs import get_config, list_configs, smoke_config
from ..core.backends import CudaRuntimeBackend
from ..core.report import render_tables, to_json
from ..core.talp import TalpMonitor
from ..models import lm
from .steps import make_prefill_step, make_serve_step

__all__ = ["resolve_device", "serve", "main"]


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


def serve(
    cfg,
    requests: int = 4,
    prompt_len: int = 32,
    gen_len: int = 16,
    seed: int = 0,
    talp_json: str = None,
    verbose: bool = True,
    device="cuda",
):
    """Serve one batch of ``requests`` random prompts of ``prompt_len``
    tokens and generate ``gen_len`` tokens each. Returns (tokens (requests,
    gen_len) int32 NumPy, TalpResult).

    Decode writes only the hot ring of ``cfg.decode_hot_len`` slots, so,
    as in ``repro.launch.serve``, generated tokens beyond that many lose the
    oldest generated context (see :func:`repro_torch.models.lm.grow_caches`).
    """
    dev = resolve_device(device)
    backend = CudaRuntimeBackend(dev)
    mon = TalpMonitor("serve", backend=backend, overhead_report=True)
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
        prompts = torch.randint(0, cfg.vocab_size, (requests, prompt_len),
                                generator=gen, device=dev, dtype=torch.int32)

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
                tokens_out.append(tok.cpu().numpy())
                h = backend.launch(decode_fn, params, tok[:, None], pos,
                                   caches, name=f"decode_{t}")
                with mon.offload():
                    logits, caches, pos = backend.wait(h)
                tok = logits[:, : cfg.vocab_size].argmax(-1).to(torch.int32)

    result = mon.finalize()
    if verbose:
        print(render_tables(result))
    if talp_json:
        with open(talp_json, "w") as f:
            f.write(to_json(result))
    return np.stack(tokens_out, axis=1), result


def main():
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
    args = ap.parse_args()
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    t0 = time.time()
    tokens, _ = serve(cfg, args.requests, args.prompt_len, args.gen_len,
                      seed=args.seed, talp_json=args.talp_json,
                      device=args.device)
    dt = time.time() - t0
    n = tokens.size
    print(f"generated {n} tokens in {dt:.2f}s ({n/dt:.1f} tok/s)")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
