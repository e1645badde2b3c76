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
memset (:class:`repro_torch.core.backends.CudaRuntimeBackend`), so no
profiler may be open while ``train`` runs. Each sample drains that
collection and the next step opens a new one.

Runs on ``cuda`` unless ``device="cpu"`` is asked for; without a card it
raises instead of running on the CPU. On the card, attention trains only
at a head dim the flash backward takes (``BWD_HEAD_DIMS``: zamba2-2.7b's
80 is refused with ``ValueError`` before anything is allocated); the CPU
trains every supported config through the plain versions. SSM blocks
train through the CUDA SSD backward on the card.

TALP's runtime outputs are those of ``repro.launch.train``: the
``--talp-*`` flags (step series and watchdog in a nested ``step``
region, snapshots every N steps through the exporter when one is
attached, Chrome trace, JSONL and Prometheus streams, the per-rank spool
and the job-level merge, fault injection;
:mod:`repro_torch.launch.talp_outputs`). ``--rank``/``--world-size``
are what the JAX trainer makes of them: this process's shard of the
synthetic data and its rank in the spool, with no collective (each
process trains its own replica; sharding is not ported yet).
Checkpointing (``--ckpt-dir``, ``--ckpt-every``) is not ported yet: the
command line refuses it.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
      --steps 6 --batch 2 --seq 2048
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
      --steps 6 --batch 8 --seq 4096
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
      --smoke --device cpu --steps 4 --batch 2 --seq 64
  # two ranks of one job, each on half the global batch, one spool
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
      --steps 6 --batch 8 --seq 4096 --rank 0 --world-size 2 \
      --talp-spool /tmp/spool --talp-step-series 6 --talp-watchdog &
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
      --steps 6 --batch 8 --seq 4096 --rank 1 --world-size 2 \
      --talp-spool /tmp/spool --talp-step-series 6 --talp-watchdog
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..configs import ShapeConfig, get_config, list_configs, smoke_config
from ..core.backends import CudaRuntimeBackend
from ..data.pipeline import DataConfig, SyntheticTokenPipeline
from ..kernels import launch_counts
from ..kernels.flash_attention.kernel import BWD_HEAD_DIMS
from ..models import lm
from ..optim.adamw import AdamWConfig
from ..runtime.fault_tolerance import StragglerDetector
from .serve import resolve_device
from .steps import init_train_state, make_train_step, model_flops
from .talp_outputs import TalpOutputs, add_talp_arguments, talp_kwargs

__all__ = ["UNPORTED_FLAGS", "check_trainable_on_card", "train", "main"]

# Flags of the JAX trainer the port refuses, with what they wait for.
UNPORTED_FLAGS = {
    "--ckpt-dir": "checkpointing",
    "--ckpt-every": "checkpointing",
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
    """Train ``cfg`` from random fp32 weights drawn from ``seed`` for
    ``steps`` AdamW steps of ``global_batch`` synthetic sequences of
    ``seq_len`` tokens (this rank's ``global_batch / world_size`` of
    them). Returns (state, history, TalpResult); history holds one
    {"step", "loss", "grad_norm", "time_s"} per step.

    The ``rank`` .. ``talp_fault_plan`` keywords are those of
    ``repro.launch.train.train``: each process of a job passes its
    ``rank``/``world_size`` and a shared ``talp_spool``; whichever rank
    completes the spool merges it into ``talp_job.json``."""
    lm.check_supported(cfg)
    if torch.device(device).type == "cuda":
        check_trainable_on_card(cfg)
    dev = resolve_device(device)
    opt_cfg = opt_cfg or AdamWConfig(warmup_steps=10, total_steps=steps)
    backend = CudaRuntimeBackend(dev)
    shape = ShapeConfig(name="train", seq_len=seq_len,
                        global_batch=global_batch, kind="train")
    talp = TalpOutputs(
        "train", backend, "step", lambda: model_flops(cfg, shape),
        verbose=verbose, rank=rank, world_size=world_size,
        talp_spool=talp_spool, talp_sample_every=talp_sample_every,
        talp_spool_format=talp_spool_format, talp_trace_out=talp_trace_out,
        talp_metrics_jsonl=talp_metrics_jsonl,
        talp_prometheus_port=talp_prometheus_port,
        talp_step_series=talp_step_series, talp_watchdog=talp_watchdog,
        talp_anomaly_log=talp_anomaly_log, talp_fault_plan=talp_fault_plan)
    mon = talp.mon
    data = SyntheticTokenPipeline(
        DataConfig(global_batch=global_batch, seq_len=seq_len,
                   vocab_size=cfg.vocab_size, seed=seed),
        process_index=rank, process_count=world_size,
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
            with talp.step():
                # host Useful: data synthesis and the copy to the card
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in data.batch_at(step).items()}
                # host Useful: enqueueing the step; Offload: the wait for
                # the card
                handle = backend.launch(step_fn, state, batch,
                                        name="train_step")
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
            talp.sample(step, f"step {step}")
            if verbose and (step % 10 == 0 or step == steps - 1):
                print(f"step {step:5d} loss {history[-1]['loss']:.4f} "
                      f"({dt*1e3:.0f} ms)")
                sys.stdout.flush()

    data.stop()

    def stragglers():
        if detector.events:
            print(f"straggler events at steps: {detector.events}")

    result = talp.finish(talp_json, notes=stragglers)
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
    add_talp_arguments(ap, "step")
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
        **talp_kwargs(args),
    )
    if args.history_json:
        with open(args.history_json, "w") as f:
            json.dump(history, f)
    if torch.device(args.device).type == "cuda":
        print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
              f"GiB; kernel launches {json.dumps(launch_counts())}")
    losses = [h["loss"] for h in history]
    if losses and not (np.isfinite(losses[-1]) and losses[-1] < losses[0]):
        print("WARNING: loss did not decrease")


if __name__ == "__main__":
    main()
