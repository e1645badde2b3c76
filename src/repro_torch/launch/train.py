"""Trainer under TALP monitoring. Port of ``repro.launch.train``.

Every step runs under TALP regions and states, as in the JAX trainer:
  * host *Useful*  — data synthesis, moving the batch to the card, and
                     ``backend.launch`` (in eager PyTorch, the host
                     enqueueing every kernel of the step: forward,
                     backward and the AdamW update);
  * *Offload*      — ``backend.wait``, the host blocked on the card;
and the paper's text/JSON report is emitted at exit and sampled every
``--talp-interval`` steps (TALP's online mode). On the card, device Kernel
and Memory records come from CUPTI activity, one per kernel, memcpy and
memset, collected through ``torch.profiler``
(:class:`repro_torch.core.backends.CudaRuntimeBackend`), so no other
profiler may be open while ``train`` runs. Each sample closes that
collection and the next step opens a new one.

Runs on ``cuda`` unless ``device="cpu"`` is asked for; without a card it
raises instead of running on the CPU. On the card, attention trains only
at a head dim the flash backward takes (``BWD_HEAD_DIMS``: zamba2-2.7b's
80 is refused with ``ValueError`` before anything is allocated); the CPU
trains every supported config through the plain versions. SSM blocks
train through the CUDA SSD backward on the card. Checkpointing (``--ckpt-dir``),
multi-process runs (``--rank``, ``--world-size``) and the spool, trace,
telemetry, step-series and watchdog ``--talp-*`` flags are not ported
yet: the command line refuses them.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
      --steps 6 --batch 2 --seq 2048
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
      --steps 6 --batch 8 --seq 4096
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
      --smoke --device cpu --steps 4 --batch 2 --seq 64
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..configs import get_config, list_configs, smoke_config
from ..core.backends import CudaRuntimeBackend
from ..core.report import render_tables, to_json
from ..core.talp import TalpMonitor
from ..data.pipeline import DataConfig, SyntheticTokenPipeline
from ..kernels.flash_attention.kernel import BWD_HEAD_DIMS
from ..models import lm
from ..optim.adamw import AdamWConfig
from ..runtime.fault_tolerance import StragglerDetector
from .serve import resolve_device
from .steps import init_train_state, make_train_step

__all__ = ["UNPORTED_FLAGS", "check_trainable_on_card", "train", "main"]

# Flags of the JAX trainer the port refuses, with what they wait for.
UNPORTED_FLAGS = {
    "--ckpt-dir": "checkpointing",
    "--ckpt-every": "checkpointing",
    "--rank": "multi-GPU runs",
    "--world-size": "multi-GPU runs",
    "--talp-spool": "the job-level merge",
    "--talp-spool-format": "the job-level merge",
    "--talp-sample-every": "the job-level merge",
    "--talp-trace-out": "the telemetry copies",
    "--talp-metrics-jsonl": "the telemetry copies",
    "--talp-prometheus-port": "the telemetry copies",
    "--talp-step-series": "the telemetry copies",
    "--talp-watchdog": "the telemetry copies",
    "--talp-anomaly-log": "the telemetry copies",
    "--talp-fault-plan": "the fault-tolerant collection",
}


def check_trainable_on_card(cfg) -> None:
    """Raise ``ValueError`` if ``cfg`` has attention at a head dim the flash
    backward does not take; the card would fail only inside the first
    backward, after the weights and moments are allocated."""
    if any(kind != "ssm" for kind in cfg.pattern) and (
            cfg.resolved_head_dim not in BWD_HEAD_DIMS):
        raise ValueError(
            f"{cfg.name}: attention head_dim {cfg.resolved_head_dim} is not "
            f"one the flash backward takes ({BWD_HEAD_DIMS}); it trains on "
            "the CPU (device='cpu') through the plain versions")


def train(
    cfg,
    steps: int = 50,
    global_batch: int = 8,
    seq_len: int = 128,
    talp_interval: int = 0,
    talp_json: str = None,
    opt_cfg: AdamWConfig = None,
    seed: int = 0,
    verbose: bool = True,
    device="cuda",
):
    """Train ``cfg`` from random fp32 weights drawn from ``seed`` for
    ``steps`` AdamW steps of ``global_batch`` synthetic sequences of
    ``seq_len`` tokens. Returns (state, history, TalpResult); history holds
    one {"step", "loss", "grad_norm", "time_s"} per step."""
    lm.check_supported(cfg)
    if torch.device(device).type == "cuda":
        check_trainable_on_card(cfg)
    dev = resolve_device(device)
    opt_cfg = opt_cfg or AdamWConfig(warmup_steps=10, total_steps=steps)
    backend = CudaRuntimeBackend(dev)
    mon = TalpMonitor("train", backend=backend, overhead_report=True)
    data = SyntheticTokenPipeline(
        DataConfig(global_batch=global_batch, seq_len=seq_len,
                   vocab_size=cfg.vocab_size, seed=seed),
        process_index=0, process_count=1,
    )
    step_fn = make_train_step(cfg, opt_cfg)
    detector = StragglerDetector()

    with mon.region("init"):
        gen = torch.Generator(device=dev).manual_seed(seed)
        state = init_train_state(cfg, gen, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    history = []
    with mon.region("train_loop"):
        for step in range(steps):
            t0 = time.perf_counter()
            # host Useful: data synthesis and the copy to the card
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in data.batch_at(step).items()}
            # host Useful: enqueueing the step; Offload: the wait for the
            # card, which closes the step's Kernel record
            handle = backend.launch(step_fn, state, batch, name="train_step")
            with mon.offload():
                state, metrics = backend.wait(handle)
            dt = time.perf_counter() - t0
            detector.observe(step, dt)
            history.append(
                {"step": step, "loss": float(metrics["loss"]),
                 "grad_norm": float(metrics["grad_norm"]), "time_s": dt}
            )
            if talp_interval and (step + 1) % talp_interval == 0 and verbose:
                snap = mon.sample("train_loop")
                print(f"[talp online] step {step} "
                      f"PE_host={snap.host.parallel_efficiency:.3f} "
                      f"OE={snap.host.device_offload_efficiency:.3f}")
            if verbose and (step % 10 == 0 or step == steps - 1):
                print(f"step {step:5d} loss {history[-1]['loss']:.4f} "
                      f"({dt*1e3:.0f} ms)")
                sys.stdout.flush()

    data.stop()
    result = mon.finalize()
    if verbose:
        print(render_tables(result))
        if detector.events:
            print(f"straggler events at steps: {detector.events}")
    if talp_json:
        with open(talp_json, "w") as f:
            f.write(to_json(result))
    return state, history, result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_configs(), required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--talp-interval", type=int, default=0)
    ap.add_argument("--talp-json", default=None)
    ap.add_argument("--history-json", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card fails")
    for flag in UNPORTED_FLAGS:
        ap.add_argument(flag, nargs="?", const=True, default=None,
                        help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    given = [flag for flag in UNPORTED_FLAGS
             if getattr(args, flag[2:].replace("-", "_")) is not None]
    if given:
        ap.error("not ported yet: " + ", ".join(
            f"{flag} ({UNPORTED_FLAGS[flag]})" for flag in given))

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    _, history, _ = train(
        cfg,
        steps=args.steps,
        global_batch=args.batch,
        seq_len=args.seq,
        talp_interval=args.talp_interval,
        talp_json=args.talp_json,
        seed=args.seed,
        device=args.device,
    )
    if args.history_json:
        with open(args.history_json, "w") as f:
            json.dump(history, f)
    losses = [h["loss"] for h in history]
    if losses and not (np.isfinite(losses[-1]) and losses[-1] < losses[0]):
        print("WARNING: loss did not decrease")


if __name__ == "__main__":
    main()
