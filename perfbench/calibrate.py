"""The readings each correctness limit is set from, on the card, at the
cell's own size: the numbers ``judge.py`` compares, for

  * sound runs of the program on ``--seeds`` seeds (the lower readings);
  * the control on the first ``--control`` of them: the reference itself
    in the program's place with its weight products in float8 e4m3 (the
    precision below the configuration's bf16). For training, its first
    steps against the float32 reference's; for serving, along the
    program's served tokens, the float32 reference's gap of the token the
    float8 reference puts first at each position;
  * faults planted in the program on the first ``--faults`` seeds: for
    training, half of each batch left out (the step's mean taken over the
    rest); for serving, a served token altered where it is produced (the
    first request's logits rolled by one word at every decode step). A
    training step that returns its state unchanged reads 1 in
    ``grad_rel`` and ``change_rel`` by their definition and needs no run.

Serving runs use a short window at the cell's load that goes on until it
has finished the batches a run compares. Each control and each fault is
also judged as a run is, under the cell's ``limits/<cell>.json``, on the
numbers it produced: the script exits 1 if any of them comes out
correct. Run on the card, for a cell of ``BENCHMARK.json`` or for a
candidate (configuration and traffic by name, before it is listed):

    python3 perfbench/calibrate.py --workload <cell> --seeds 12 \
        --control 3 --faults 3 --base 5000 --out readings.json
    python3 perfbench/calibrate.py --config <config> --traffic <mix> ...

``--port KEY=VALUE`` and ``--set KEY=VALUE`` (JSON values) replace keys of
the configuration's ``port`` section and of the traffic: the program's
float32 path, say, as a witness beside the reference. The benchmark's own
runs never run this."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def half_batch_step(build):
    """A train step builder whose step sees only the first half of the
    batch's rows."""
    def builder(cfg, opt):
        step = build(cfg, opt)

        def half(state, batch):
            rows = batch["labels"].shape[0] // 2
            return step(state, {k: v[:max(rows, 1)] for k, v in
                                batch.items()})

        return half
    return builder


def altered_steps(build):
    """Serve step builders whose decode step shifts the first request's
    logits by one word, so the token served for it is another."""
    def builder(cfg):
        prefill, decode = build(cfg)

        def shifted(*args):
            logits, caches, pos = decode(*args)
            logits = logits.clone()
            logits[0] = logits[0].roll(1, -1)
            return logits, caches, pos

        return prefill, shifted
    return builder


def judged_correct(cell, numbers):
    """Whether ``numbers`` pass the cell's limits, over the limited numbers
    they hold (a control produces no TALP report, and is not failed for
    lacking one); None where the cell has no limits yet."""
    from perfbench import harness

    if not cell.limits:
        return None
    checks = harness.compare(cell, numbers)
    return all(c["ok"] for name, c in checks.items() if name in numbers)


def readings(workload, seeds, control: int, faults: int,
             device="cuda", overrides=None, window: float = 1.0,
             make=None) -> dict:
    """The readings of ``workload``, a cell's name in ``BENCHMARK.json`` or
    a workload entry (``name``, ``config``, ``traffic``); ``device`` and
    ``overrides`` (``harness.load_cell``'s), or ``make(seed, seconds)``
    giving the cell outright, let the tests take them at a smoke size on
    the CPU. ``correct`` holds, for each control and fault, whether the
    cell's limits pass it."""
    import torch

    from perfbench import harness, judge
    from perfbench.drivers import serve as serve_driver
    from perfbench.drivers import train as train_driver
    from perfbench.reference.lm import Products
    from perfbench.reference.train import reference_steps
    from perfbench import traffic as tr

    work = workload if isinstance(workload, dict) else {
        w["name"]: w for w in harness.benchmark()["workloads"]}[workload]
    out = {"workload": work["name"], "sound": {}, "control": {},
           "fault": {}, "correct": {"control": {}, "fault": {}}}

    def cell_for(seed, seconds=0.0):
        if make is not None:
            return make(seed, seconds)
        return harness.make_cell(work, seed, seconds, False, device,
                                 overrides)

    first = cell_for(seeds[0])
    training = first.traffic["driver"] == "train"
    for n, seed in enumerate(seeds):
        t0 = time.perf_counter()
        if training:
            cell = cell_for(seed)
            rec = train_driver.run(cell, keep_reference=n < control)
            out["sound"][seed] = rec["numbers"]
            prog, ref = rec["readings"]["program"], rec["readings"]["reference"]
            out.setdefault("worst", {})[seed] = {
                key: sorted(((abs(p - r), name, p, r) for name, p, r in zip(
                    ref["names"], prog[key], ref[key])), reverse=True)[:3]
                for key in ("grad", "change")}
            if n < control:
                t = cell.traffic
                batches = [{k: torch.from_numpy(v) for k, v in
                            tr.train_batch(cell.sizes.vocab, t["batch"],
                                           t["seq_len"], seed, i).items()}
                           for i in range(train_driver.SETUP_STEPS)]
                ref = rec["readings"]["reference"]
                low = reference_steps(
                    cell.sizes, seed, batches, t["adamw"], cell.device,
                    Products(fp8=True), against={
                        "grad": ref.pop("grad_host"),
                        "change": ref.pop("change_host")})
                # judged as the program is: the float8 run in its place
                out["control"][seed] = judge.train_numbers(
                    low, {**ref, "grad_diff": low["grad_diff"],
                          "change_diff": low["change_diff"]})
                out["correct"]["control"][seed] = judged_correct(
                    cell, out["control"][seed])
        else:
            cell = cell_for(seed, window)
            rec = serve_driver.run(cell, min_finished=cell.traffic[
                "compare_batches"])
            out["sound"][seed] = rec["numbers"]
            if n < control:
                batches = list(rec["served"].items())
                _, low = serve_driver.judge_batches(
                    cell, batches, Products(fp8=True))
                gaps, _ = serve_driver.judge_batches(cell, batches,
                                                     judged=low)
                out["control"][seed] = judge.gap_numbers(gaps)
                out["correct"]["control"][seed] = judged_correct(
                    cell, out["control"][seed])
        print(f"[calibrate] {work['name']} seed {seed}: sound "
              f"{out['sound'][seed]} control {out['control'].get(seed)} "
              f"judged correct {out['correct']['control'].get(seed)} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    for seed in seeds[:faults]:
        if training:
            build = train_driver.build_step
            train_driver.build_step = half_batch_step(build)
            try:
                rec = train_driver.run(cell_for(seed))
            finally:
                train_driver.build_step = build
        else:
            build = serve_driver.build_steps
            serve_driver.build_steps = altered_steps(build)
            try:
                cell = cell_for(seed, window)
                rec = serve_driver.run(cell, min_finished=cell.traffic[
                    "compare_batches"])
            finally:
                serve_driver.build_steps = build
        out["fault"][seed] = rec["numbers"]
        out["correct"]["fault"][seed] = (
            all(c["ok"] for c in rec["checks"].values())
            if rec["checks"] else None)
        print(f"[calibrate] {work['name']} seed {seed}: fault "
              f"{out['fault'][seed]}", flush=True)
    return out


def _assignments(pairs) -> dict:
    out = {}
    for pair in pairs:
        key, _, value = pair.partition("=")
        out[key] = json.loads(value)
    return out


def main() -> int:
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(REPO), str(REPO / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != here]
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload")
    ap.add_argument("--config")
    ap.add_argument("--traffic")
    ap.add_argument("--port", action="append", default=[])
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--base", type=int, default=5000)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    work = args.workload or {"name": f"{args.config}.{args.traffic}",
                             "config": args.config, "traffic": args.traffic}
    overrides = {"port": _assignments(args.port),
                 "traffic": _assignments(args.set)}
    seeds = [args.base * 1_000_003 + i for i in range(args.seeds)]
    out = readings(work, seeds, args.control, args.faults,
                   overrides=overrides)
    Path(args.out).write_text(json.dumps(out, indent=1))
    for kind in ("sound", "control", "fault"):
        rows = list(out[kind].values())
        if rows:
            names = rows[0].keys()
            print(f"[calibrate] {kind}: " + ", ".join(
                f"{k} max {max(r[k] for r in rows):.6g} min "
                f"{min(r[k] for r in rows):.6g}" for k in names))
    passed = [f"{kind} {seed}" for kind, rows in out["correct"].items()
              for seed, ok in rows.items() if ok is True]
    print(f"[calibrate] judged correct under the limits: {passed or 'none'}")
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
