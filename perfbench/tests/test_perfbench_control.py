"""The correctness check's control and planted faults, at a smoke size on
the CPU (their readings at the cells' own size come from
``perfbench/calibrate.py`` on the card and are in ``PERF.md``).

The control, the reference with float8 products in the program's place,
reads at least three times what a sound run of the program reads on the
same seed, and the cell's limits judge it not correct. Each fault a cell
can have, planted under a run that skips the look for a card, makes
``correct`` come out false under the cell's limits: a training step that
returns its state unchanged, half of each batch left out (the mean over
the rest), a served token altered where it is produced. (No cell runs on
more than one chip, so none can leave out an exchange between chips.)
The serving driver, which no cell of ``BENCHMARK.json`` uses yet, is
held to the same on a serving cell built by the harness's tests."""

import pytest

from perfbench import calibrate, harness
from perfbench.drivers import serve as serve_driver
from perfbench.drivers import train as train_driver

from .test_perfbench_harness import (BENCH, SERVE_LIMITS, SMOKE,
                                     SMOKE_TRAFFIC, serve_smoke_cell,
                                     smoke_cell)

TRAIN = [w["name"] for w in BENCH["workloads"]
         if w["traffic"].startswith("train")]
# the serving driver's rehearsal cell (``serve_smoke_cell``)
SERVE = [w["name"] for w in BENCH["workloads"]
         if w["name"] not in TRAIN] + ["serve-smoke"]
SEED = 987654321987
# training cells are judged on their first steps, before any window
WINDOW = {name: 0.0 for name in TRAIN}


def cell_limits(name):
    """The limits the cell's runs are held to, from its limits file."""
    if name == "serve-smoke":
        return SERVE_LIMITS
    return harness.load_cell(name, SEED, 1.0, False, "cpu").limits


def cell_at(name, seed=SEED, seconds=None):
    if name == "serve-smoke":
        return serve_smoke_cell(seed=seed, seconds=seconds,
                                limits=cell_limits(name))
    return smoke_cell(name, seed=seed, seconds=seconds,
                      limits=cell_limits(name))


def readings(name):
    if name == "serve-smoke":
        cell = serve_smoke_cell(limits=SERVE_LIMITS)
        return calibrate.readings(
            cell.workload, [SEED], control=1, faults=0, device="cpu",
            make=lambda seed, seconds: serve_smoke_cell(
                seed=seed, seconds=seconds, limits=SERVE_LIMITS))
    work = {w["name"]: w for w in BENCH["workloads"]}[name]
    return calibrate.readings(work, [SEED], control=1, faults=0,
                              device="cpu", overrides={
                                  "port": SMOKE[work["config"]],
                                  "traffic": SMOKE_TRAFFIC["train"]})


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_control_reads_three_times_a_sound_run(name):
    out = readings(name)
    sound, control = out["sound"][SEED], out["control"][SEED]
    assert any(control[k] >= 3 * sound[k] for k in control), (sound, control)
    # judged as a run is, under the cell's limits
    assert out["correct"]["control"][SEED] is False, control


def _correct(name, monkeypatch, target, builder):
    monkeypatch.setattr(target, builder.__name__.split(".")[-1], builder)
    cell = cell_at(name, seconds=WINDOW.get(name))
    rec = harness.run_cell(cell)
    return harness.result_line(cell, rec, 1.0)["correct"]


@pytest.mark.parametrize("name", TRAIN)
def test_a_step_returning_its_state_unchanged_fails(name, monkeypatch):
    def build_step(cfg, opt):
        import torch
        from repro_torch.models import lm

        def unchanged(state, batch):
            with torch.no_grad():
                loss, _ = lm.train_loss(cfg, lm.tree_map(
                    lambda x: x.to(torch.bfloat16), state["params"]), batch)
            return state, {"loss": loss, "grad_norm": torch.ones(())}

        return unchanged

    assert not _correct(name, monkeypatch, train_driver, build_step)


@pytest.mark.parametrize("name", TRAIN)
def test_half_the_batch_left_out_fails(name, monkeypatch):
    assert not _correct(name, monkeypatch, train_driver,
                        _named(calibrate.half_batch_step(
                            train_driver.build_step), "build_step"))


@pytest.mark.parametrize("name", SERVE)
def test_an_altered_token_fails(name, monkeypatch):
    assert not _correct(name, monkeypatch, serve_driver,
                        _named(calibrate.altered_steps(
                            serve_driver.build_steps), "build_steps"))


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_a_sound_run_passes(name):
    cell = cell_at(name, seconds=WINDOW.get(name))
    rec = harness.run_cell(cell)
    assert harness.result_line(cell, rec, 1.0)["correct"], rec["checks"]


def _named(fn, name):
    fn.__name__ = name
    return fn
