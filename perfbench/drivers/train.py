"""Training cells: AdamW steps of the program's train step under TALP,
composed as ``repro_torch.launch.train.train`` composes them (the
driver's own loop body is not in the window: ``train`` draws its weights
inside the call and runs a fixed number of steps).

Set-up builds one train state from the seed (fp32 masters in the
program's tree, AdamW moments), drives it through its first three steps
by the window's own call and feed (a batch synthesised on the host and
copied to the card, ``backend.launch`` of the step, ``backend.wait``), and
keeps what the comparison needs: each step's loss, the first moment after
step one and each leaf's change after step three. With ``--trace 1`` it
then profiles ``profile_steps`` steps. Then TALP's monitor opens on the
same backend (post-mortem, or the traffic file's ``talp`` outputs), one
step warms it, and the window runs steps back to back inside the
``train_loop`` region, the wait inside ``mon.offload()``, the loss and
gradient norm read on the host after each step. Once the window has
closed and the peak memory is read, the state is freed and the plain
reference runs the same three steps."""

from __future__ import annotations

import gc
import tempfile
import time
from contextlib import nullcontext

import torch

from .. import judge
from .. import traffic as tr
from ..harness import Spans, compare, nvidia_smi
from ..devprof import profiled
from ..reference.train import reference_steps
from ..weights import leaves, make_params, named_leaves
from ..work import model_flops

__all__ = ["SETUP_STEPS", "build_step", "run"]

SETUP_STEPS = 3


def build_step(cfg, opt_cfg):
    """The program's training step."""
    from repro_torch.launch.steps import make_train_step

    return make_train_step(cfg, opt_cfg)


def talp_kwargs(traffic: dict) -> dict:
    """The traffic file's TALP outputs; ``{tmp}`` in a path is ``TMPDIR``."""
    return {k: v.replace("{tmp}", tempfile.gettempdir())
            if isinstance(v, str) else v
            for k, v in traffic.get("talp", {}).items()}


class _Loop:
    """One training step as the window runs it."""

    def __init__(self, cell, backend, step_fn, state):
        self.cell, self.backend, self.step_fn = cell, backend, step_fn
        self.state = state
        self.spans = Spans()
        self.dev = torch.device(cell.device)

    def step(self, index: int, talp=None):
        t, s = self.cell.traffic, self.cell.sizes
        mon = talp.mon if talp is not None else None
        with talp.step() if talp is not None else nullcontext():
            with self.spans("data"):
                batch = {k: torch.from_numpy(v).to(self.dev) for k, v in
                         tr.train_batch(s.vocab, t["batch"], t["seq_len"],
                                        self.cell.seed, index).items()}
            with self.spans("launch"):
                handle = self.backend.launch(self.step_fn, self.state, batch,
                                             name="train_step")
            with mon.offload() if mon is not None else nullcontext():
                with self.spans("wait"):
                    self.state, metrics = self.backend.wait(handle)
        return float(metrics["loss"]), float(metrics["grad_norm"])


def run(cell, keep_reference: bool = False) -> dict:
    """One run; ``keep_reference`` (calibration) keeps the reference's
    first gradient and change in host memory in the record's
    ``readings``."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.core.backends import CudaRuntimeBackend
    from repro_torch.launch.steps import model_flops as program_flops
    from repro_torch.launch.talp_outputs import TalpOutputs
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state

    dev = torch.device(cell.device)
    cuda = dev.type == "cuda"
    s, t = cell.sizes, cell.traffic
    opt = t["adamw"]
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    params = make_params(s, cell.seed, dev, torch.float32)
    state = {"params": params, "opt": init_opt_state(params),
             "step": torch.zeros((), dtype=torch.int32)}
    del params
    backend = CudaRuntimeBackend(dev)
    cfg = cell.model_config()
    loop = _Loop(cell, backend, build_step(cfg, AdamWConfig(**opt)), state)
    del state

    # the first steps, through the window's call and feed; the first
    # gradient (from the first moment) and the change after the last are
    # kept in host memory for the reference
    prog = {"loss": [], "grad": [], "change": [], "grad_host": [],
            "change_host": []}

    def keep(key, x):
        prog[key].append(judge.norm(x))
        prog[key + "_host"].append(x.cpu())

    for index in range(SETUP_STEPS):
        loss, gnorm = loop.step(index)
        prog["loss"].append(loss)
        if index == 0:
            scale = min(1.0, opt["grad_clip"] / max(gnorm, 1e-9))
            for _, m in named_leaves(loop.state["opt"]["mu"]):
                keep("grad", m / ((1 - opt["b1"]) * scale))
    for (_, p), (_, p0) in zip(named_leaves(loop.state["params"]),
                               leaves(s, cell.seed, dev, torch.float32)):
        keep("change", p0.neg_().add_(p))   # p - p0, in p0's memory
    index = SETUP_STEPS

    profile = None
    if cell.trace and cuda:
        def segment():
            nonlocal index
            for _ in range(t["profile_steps"]):
                loop.step(index)
                index += 1

        profile = {"train": profiled(segment, dev, loop.spans)}

    flops = model_flops.train_step(s, t["batch"], t["seq_len"])
    # TALP's flop model as ``train`` gives it: the program's own count
    shape = ShapeConfig(name="train", seq_len=t["seq_len"],
                        global_batch=t["batch"], kind="train")
    talp = TalpOutputs("train", backend, "step",
                       lambda: program_flops(cfg, shape), verbose=True,
                       **talp_kwargs(t))
    mon = talp.mon
    with mon.region("warmup"):
        loop.step(index, talp)
        index += 1
    smi = nvidia_smi() if cuda else ""
    print(f"[bench] card before the window: {smi}")

    loop.spans = Spans()
    steps, attempted = 0, 0
    overhead0 = mon.overhead.total
    window_start = last_end = time.perf_counter()
    deadline = window_start + cell.seconds
    with mon.region("train_loop"):
        while time.perf_counter() < deadline:
            attempted += 1
            loop.step(index, talp)
            end = time.perf_counter()
            talp.sample(index, f"step {index}")
            index += 1
            if end <= deadline:
                steps, last_end = steps + 1, end
    window_end = time.perf_counter()
    overhead = mon.overhead.total - overhead0
    smi_after = nvidia_smi() if cuda else ""
    result = talp.finish(None)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    spans = loop.spans.times
    loop.state = None
    del loop
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    batches = [{k: torch.from_numpy(v) for k, v in tr.train_batch(
        s.vocab, t["batch"], t["seq_len"], cell.seed, i).items()}
        for i in range(SETUP_STEPS)]
    against = {"grad": prog.pop("grad_host"),
               "change": prog.pop("change_host")}
    ref = reference_steps(s, cell.seed, batches, opt, dev, against=against,
                          keep=keep_reference)
    del against
    numbers = judge.train_numbers(prog, ref)
    numbers["talp_invalid"] = judge.talp_invalid(result)
    elapsed = last_end - window_start
    print(f"[bench] window: {steps} steps of {t['batch']} x {t['seq_len']} "
          f"finished in {elapsed:.6f} s ({attempted} started, "
          f"{window_end - window_start:.6f} s to the last end); losses "
          f"{prog['loss']} against {ref['loss']}; peak memory "
          f"{peak / 2**30:.3f} GiB")
    return {
        "end_to_end": {"train_tokens_per_s": (
            steps * t["batch"] * t["seq_len"] / elapsed if steps else None)},
        "attempted": attempted,
        "failed": 0,
        "window_start": window_start,
        "window": {"steps": steps, "elapsed_s": elapsed, "spans": spans,
                   "seconds": window_end - window_start,
                   "talp_overhead_s": overhead, "flops_per_step": flops},
        "profile": profile,
        "numbers": numbers,
        "checks": compare(cell, numbers),
        "memory_peak_bytes": peak,
        "smi_after": smi_after,
        "readings": {"program": prog, "reference": ref},
    }
