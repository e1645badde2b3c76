"""mfu.prefill: the model's operations per prefill (``work/model_flops.py``)
times the window's prefills, over their time on the host clock (each from
its launch to the end of its wait), as a percent of the card's bf16
peak."""

from perfbench.work.peaks import BF16_FLOPS


def read(rec, cell):
    w = rec["window"]
    if not w["prefill_s"]:
        return None
    return 100.0 * w["prefill_flops"] * len(w["prefill_s"]) / (
        sum(w["prefill_s"]) * BF16_FLOPS)
