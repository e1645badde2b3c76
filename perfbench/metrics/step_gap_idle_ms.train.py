"""step_gap_idle_ms.train: the card's idle time ``outside`` the phase
spans, from one step's ``adamw`` device end to the next step's
``forward`` device start (the driver loop's wait, the loss read-back,
TALP's sample, the next batch and its launch), per gap between two steps
of the window, in ms."""

from perfbench.metrics import _phases


def read(rec, cell):
    return _phases.mean_ms(rec, "outside", "idle")
