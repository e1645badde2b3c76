"""shared_block_busy_ms.train: the card's busy time (the union of TALP's
Kernel and Memory rows) inside the device windows of the program's
``shared_block`` spans, each application of a shared block of a
``zamba_hybrid`` layer (its attention, feed-forward, adapter and L_r; in
the forward and again in remat's recompute in the backward), summed per
training step of the window, in ms: the spans' busy seconds over the
window's ``forward`` spans. A program without such spans gives None."""

from perfbench.metrics import _phases


def read(rec, cell):
    busy = [s.busy for s in _phases.spans(rec, "shared_block")
            if s.busy is not None]
    steps = len(_phases.spans(rec, "forward"))
    if not busy or not steps:
        return None
    return float(1e3 * sum(busy) / steps)
