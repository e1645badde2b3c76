"""mfu.train: the model's operations per step (``work/model_flops.py``)
times the steps the window finished, over the window's time to the end of
the last of them, as a percent of the card's bf16 peak."""

from perfbench.work.peaks import BF16_FLOPS


def read(rec, cell):
    w = rec["window"]
    if not w["steps"]:
        return None
    return 100.0 * w["flops_per_step"] * w["steps"] / (w["elapsed_s"]
                                                       * BF16_FLOPS)
