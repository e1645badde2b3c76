"""Training cells whose configuration names a plain reference of its own
(``"reference": "<module>"``, a module of ``perfbench/reference/``): the
training driver ``drivers/train.py`` runs unchanged, with the four names
it draws on (``make_params``, ``leaves``, ``reference_steps``,
``model_flops``) taken for the call from that module's ``bind(port)``,
which binds in the sizes of the configuration's ``port`` section that
``Sizes`` does not hold; and the cell's program config built as the
program's ``HybridConfig`` where the section holds such sizes. A
configuration whose model the plain reference of ``reference/lm.py``
cannot express (Zamba-2's hybrid layer) comes in so as new files alone.

The same binding runs ``perfbench/calibrate.py`` for such a cell, with
``reference/train.py``'s ``reference_steps`` (the float8 control's) bound
too:

    python3 -m perfbench.drivers.train_by_reference calibrate \\
        --workload <cell> --seeds 12 --control 3 --faults 3 \\
        --base 5000 --out readings.json
"""

from __future__ import annotations

import importlib
import sys
from contextlib import contextmanager

from .. import harness
from . import train

__all__ = ["NAMES", "bound", "main", "program_config", "run"]

NAMES = ("make_params", "leaves", "reference_steps", "model_flops")


def program_config(cell):
    """The program's config of ``cell``'s ``port`` section: its
    ``HybridConfig`` where the section holds the hybrid kind's own sizes
    (``shared_blocks``), else its ``ModelConfig``."""
    from repro_torch.configs.base import HybridConfig, ModelConfig

    port = dict(cell.config["port"])
    port["pattern"] = tuple(port["pattern"])
    cls = HybridConfig if "shared_blocks" in port else ModelConfig
    return cls(**port)


@contextmanager
def bound(config: dict, control: bool = False):
    """``drivers/train.py``'s four names bound to the configuration's own
    reference for the ``with`` block, ``Cell.model_config`` to
    :func:`program_config`, and with ``control`` also
    ``reference/train.py``'s ``reference_steps`` (which calibration's
    float8 control calls)."""
    ref = importlib.import_module(
        f"perfbench.reference.{config['reference']}")
    names = {**ref.bind(config["port"]), "model_config": program_config}
    targets = [(train, n) for n in NAMES] + [(harness.Cell, "model_config")]
    if control:
        from ..reference import train as ref_train

        targets.append((ref_train, "reference_steps"))
    saved = [(mod, n, getattr(mod, n)) for mod, n in targets]
    try:
        for mod, n in targets:
            setattr(mod, n, names[n])
        yield names
    finally:
        for mod, n, value in saved:
            setattr(mod, n, value)


def run(cell, keep_reference: bool = False) -> dict:
    with bound(cell.config):
        return train.run(cell, keep_reference)


def main(argv=None) -> int:
    """``calibrate <calibrate.py's arguments>``: calibration under the
    binding of the cell's configuration (its traffic's driver read as the
    training driver's, which the binding makes it)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] != "calibrate" or "--workload" not in argv:
        print(__doc__, file=sys.stderr)
        return 2
    from .. import calibrate, harness

    name = argv[argv.index("--workload") + 1]
    work = {w["name"]: w for w in harness.benchmark()["workloads"]}[name]
    config = harness.load_config(work["config"])
    # the sizes bound in are those of the cells calibrate.py makes, its
    # --port KEY=VALUE replacements included
    ports = [argv[i + 1] for i, a in enumerate(argv) if a == "--port"]
    config["port"].update(calibrate._assignments(ports))
    sys.argv = ["calibrate.py"] + argv[1:] + ["--set", 'driver="train"']
    with bound(config, control=True):
        return calibrate.main()


if __name__ == "__main__":
    sys.exit(main())
