"""forward_idle_ms.train: the card's idle time inside the device window of
the program's ``forward`` span, the forward (``cast_params`` and
``lm.train_loss``), per training step of the window, in ms: the window
less the union of TALP's Kernel and Memory rows in it."""

from perfbench.metrics import _phases


def read(rec, cell):
    return _phases.mean_ms(rec, "forward", "idle")
