"""backward_host_ms.train: the host's time inside the program's ``backward``
span, the backward (``loss.backward()``, remat's second forward included),
per training step of the window, in ms; the span's ends are two reads of
TALP's clock."""

from perfbench.metrics import _phases


def read(rec, cell):
    return _phases.mean_ms(rec, "backward", "host")
