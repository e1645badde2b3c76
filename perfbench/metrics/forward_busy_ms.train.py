"""forward_busy_ms.train: the card's busy time (the union of TALP's Kernel
and Memory rows) inside the device window of the program's ``forward``
span, the forward (``cast_params`` and ``lm.train_loss``), per training
step of the window, in ms. The window's ends are two CUDA events on the
step's stream, placed on TALP's clock through the runtime backend's
anchor."""

from perfbench.metrics import _phases


def read(rec, cell):
    return _phases.mean_ms(rec, "forward", "busy")
