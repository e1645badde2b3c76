"""Serving cells: batches of prompts served back to back (a closed loop:
the next batch starts when the last one has its tokens), each a prefill,
the caches grown, then greedy decode steps, composed as
``repro_torch.launch.serve.serve`` composes them (the driver's own loop
body is not in the window: ``serve`` draws its weights inside the call
and serves one batch): TALP's ``prefill``, ``grow_cache`` and ``decode``
regions, the per-token ``decode_step`` region when the traffic file asks
for a step series, ``mon.offload()`` around each ``backend.wait``, the
argmax and each token copied to the host per step, and a snapshot every
``talp_sample_every`` tokens.

Set-up draws bf16 weights from the seed and serves one warm-up batch at
the cell's shapes (``warmup_decode_steps`` decode steps: every step has
the same shapes), plainly, with no monitor. With ``--trace 1`` it then
profiles one prefill and, apart, ``profile_decode_steps`` decode steps.
Then TALP's monitor opens on the same backend, one more short batch warms
it, and the window serves batches until ``--seconds`` have passed; a batch
in flight at the close stops there. Once the window has closed and the
peak memory is read, the weights and caches are freed and the plain
reference judges ``compare_batches`` batches drawn from the seed among
those the window finished: their prompts and served tokens."""

from __future__ import annotations

import gc
import random
import time
from contextlib import nullcontext

import numpy as np
import torch

from .. import judge
from .. import traffic as tr
from ..harness import Spans, compare, nvidia_smi, quantile
from ..devprof import profiled
from ..reference.lm import Model
from ..reference.serve import served_logits
from ..weights import make_params
from ..work import model_flops
from .train import talp_kwargs

__all__ = ["build_steps", "run", "judge_batches"]


def build_steps(cfg):
    """The program's prefill and decode steps."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    return make_prefill_step(cfg), make_serve_step(cfg)


class _Server:
    """One batch as ``serve`` runs it."""

    def __init__(self, cell, backend, params):
        from repro_torch.models import lm

        self.cell, self.backend, self.params = cell, backend, params
        self.cfg = cell.model_config()
        self.grow = lambda caches, n: lm.grow_caches(self.cfg, caches, n)
        self.prefill_fn, self.decode_fn = build_steps(self.cfg)
        self.dev = torch.device(cell.device)
        self.spans = Spans()
        self.prefill_s = []          # launch to wait's end, per batch

    def prompts(self, index: int) -> torch.Tensor:
        t = self.cell.traffic
        return tr.prompts(self.cell.sizes.vocab, t["requests"],
                          t["prompt_len"], self.cell.seed, index, self.dev)

    def prefill(self, prompts, mon=None):
        region = mon.region if mon is not None else (lambda _: nullcontext())
        with region("prefill"):
            t0 = time.perf_counter()
            with self.spans("prefill_launch"):
                handle = self.backend.launch(self.prefill_fn, self.params,
                                             prompts, name="prefill")
            with mon.offload() if mon is not None else nullcontext():
                with self.spans("prefill_wait"):
                    out = self.backend.wait(handle)
            self.prefill_s.append(time.perf_counter() - t0)
        return out

    def batch(self, prompts, steps: int, talp=None, deadline=None,
              prefilled=None):
        """Serve ``prompts`` for up to ``steps`` decode steps (fewer if the
        clock passes ``deadline``): (tokens (B,) int32 NumPy per served
        token, the host time each reached the host, the batch's start)."""
        t = self.cell.traffic
        vocab = self.cell.sizes.vocab
        mon = talp.mon if talp is not None else None
        region = mon.region if mon is not None else (lambda _: nullcontext())
        start = time.perf_counter()
        logits, caches, pos = (prefilled if prefilled is not None
                               else self.prefill(prompts, mon))
        with region("grow_cache"), self.spans("grow_cache"):
            caches = self.grow(caches, t["prompt_len"] + t["gen_len"])
        with self.spans("argmax"):
            tok = logits[:, :vocab].argmax(-1).to(torch.int32)
        tokens, times = [], []
        with region("decode"):
            for i in range(steps):
                if deadline is not None and time.perf_counter() >= deadline:
                    break
                with talp.step() if talp is not None else nullcontext():
                    with self.spans("token_copy"):
                        tokens.append(tok.cpu().numpy())
                    times.append(time.perf_counter())
                    with self.spans("launch"):
                        handle = self.backend.launch(
                            self.decode_fn, self.params, tok[:, None], pos,
                            caches, name=f"decode_{i}")
                    with mon.offload() if mon is not None else nullcontext():
                        with self.spans("wait"):
                            logits, caches, pos = self.backend.wait(handle)
                    with self.spans("argmax"):
                        tok = logits[:, :vocab].argmax(-1).to(torch.int32)
                if talp is not None:
                    talp.sample(i, f"token {i}")
        return tokens, times, start


def judge_batches(cell, batches, products=None, judged=None):
    """Under the reference (with ``products``: the control's), fed each of
    ``batches`` (index, served (B, G) int) as served: the gap
    (``judge.token_gaps``) of every token judged, the served ones or
    ``judged[index]``, as one 1-D tensor, and the reference's own first
    choice at each position, {index: (B, G) int}."""
    dev = torch.device(cell.device)
    s, t = cell.sizes, cell.traffic
    model = Model(s, _float_tree(make_params(s, cell.seed, dev,
                                             torch.bfloat16)), products)
    gaps, choices = [], {}
    for index, served in batches:
        prompts = tr.prompts(s.vocab, t["requests"], t["prompt_len"],
                             cell.seed, index, dev)
        served = torch.as_tensor(served, device=dev)
        picks = torch.as_tensor((judged or {}).get(index, served),
                                device=dev)
        firsts = []
        for j, logits in enumerate(served_logits(model, prompts, served)):
            gaps.append(judge.token_gaps(logits, picks[:, j]).cpu())
            firsts.append(logits.argmax(-1))
        choices[index] = torch.stack(firsts, 1).cpu().numpy()
    gaps = torch.cat(gaps) if gaps else torch.full((1,), float("nan"))
    return gaps, choices


def _float_tree(tree):
    return {k: _float_tree(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


def run(cell, min_finished: int = 0) -> dict:
    from repro_torch.configs import ShapeConfig
    from repro_torch.core.backends import CudaRuntimeBackend
    from repro_torch.launch.steps import model_flops as program_flops
    from repro_torch.launch.talp_outputs import TalpOutputs

    dev = torch.device(cell.device)
    cuda = dev.type == "cuda"
    s, t = cell.sizes, cell.traffic
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    with torch.inference_mode():
        params = make_params(s, cell.seed, dev, torch.bfloat16)
        backend = CudaRuntimeBackend(dev)
        server = _Server(cell, backend, params)
        del params
        # warm-up batches take indices below 0; the window's count from 0
        server.batch(server.prompts(-1), t["warmup_decode_steps"])

        profile = None
        if cell.trace and cuda:
            prompts = server.prompts(-2)
            kept = {}
            profile = {"prefill": profiled(
                lambda: kept.setdefault("out", server.prefill(prompts)), dev,
                server.spans)}
            profile["decode"] = profiled(
                lambda: server.batch(prompts, t["profile_decode_steps"],
                                     prefilled=kept.pop("out")), dev,
                server.spans)

        prefill_flops = model_flops.prefill(s, t["requests"], t["prompt_len"])
        # TALP's flop model as ``serve`` gives it: the program's own count
        shape = ShapeConfig(name="serve", seq_len=t["prompt_len"]
                            + t["gen_len"], global_batch=t["requests"],
                            kind="decode")
        talp = TalpOutputs("serve", backend, "decode_step",
                           lambda: program_flops(server.cfg, shape),
                           verbose=True, **talp_kwargs(t))
        mon = talp.mon
        with mon.region("warmup"):
            server.batch(server.prompts(-3), t["warmup_decode_steps"], talp)
        smi = nvidia_smi() if cuda else ""
        print(f"[bench] card before the window: {smi}")

        server.spans, server.prefill_s = Spans(), []
        served, ttft, gaps, finished = {}, [], [], []
        n_tokens = attempted = 0
        overhead0 = mon.overhead.total
        window_start = time.perf_counter()
        deadline = window_start + cell.seconds
        index = 0
        while (time.perf_counter() < deadline
               or len(finished) < min_finished):
            attempted += t["requests"]
            late = time.perf_counter() >= deadline
            tokens, times, start = server.batch(
                server.prompts(index), t["gen_len"], talp,
                None if late else deadline)
            in_window = [x for x in times if x <= deadline]
            if in_window:
                ttft.append(in_window[0] - start)
                gaps += list(np.diff(in_window))
                n_tokens += len(in_window) * t["requests"]
            if len(tokens) == t["gen_len"]:
                finished.append(index)
                served[index] = np.stack(tokens, axis=1)
            index += 1
        window_end = time.perf_counter()
        overhead = mon.overhead.total - overhead0
        smi_after = nvidia_smi() if cuda else ""
        result = talp.finish(None)
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        spans, prefill_s = server.spans.times, server.prefill_s
        server.params = None
        del server
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    rng = random.Random(cell.seed)
    chosen = sorted(rng.sample(finished, min(t["compare_batches"],
                                             len(finished))))
    judged, _ = judge_batches(cell, [(i, served[i]) for i in chosen])
    numbers = {**judge.gap_numbers(judged),
               "talp_invalid": judge.talp_invalid(result)}
    p95 = quantile([g * 1e3 for g in gaps], 0.95)
    print(f"[bench] window: {index} batches started, {len(finished)} "
          f"finished, {n_tokens} tokens, {len(ttft)} first tokens, "
          f"{len(gaps)} decode gaps (median "
          f"{quantile([g * 1e3 for g in gaps], 0.5)} ms, p95 {p95} ms); "
          f"compared batches {chosen}; peak memory {peak / 2**30:.3f} GiB")
    return {
        "end_to_end": {
            "ttft_ms": 1e3 * sum(ttft) / len(ttft) if ttft else None,
            "serve_tokens_per_s": n_tokens / cell.seconds,
            "decode_gap_ms_p95": p95,
        },
        "attempted": attempted,
        "failed": 0,
        "window_start": window_start,
        "window": {"batches": index, "finished": finished,
                   "seconds": window_end - window_start, "spans": spans,
                   "prefill_s": prefill_s, "prefill_flops": prefill_flops,
                   "talp_overhead_s": overhead, "gaps": len(gaps)},
        "profile": profile,
        "numbers": numbers,
        "checks": compare(cell, numbers),
        "memory_peak_bytes": peak,
        "smi_after": smi_after,
        "served": {i: served[i] for i in chosen},
    }
