"""forward_host_ms.train: the host's time inside the program's ``forward``
span, the forward (``cast_params`` and ``lm.train_loss``), per training
step of the window, in ms; the span's ends are two reads of TALP's clock."""

from perfbench.metrics import _phases


def read(rec, cell):
    return _phases.mean_ms(rec, "forward", "host")
