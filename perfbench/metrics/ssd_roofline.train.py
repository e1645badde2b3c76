"""ssd_roofline.train: the SSD scan's launches of the profiled training
steps (forward, remat's second forward and backward) against their
roofline, in percent; operations named ``ssd_`` are the scan's."""

import torch

from perfbench.metrics import _roofline
from perfbench.work.ssd import ssd_backward_work, ssd_work


def read(rec, cell):
    s, t = cell.sizes, cell.traffic
    args = (t["batch"], t["seq_len"], s.ssm_heads, s.ssm_head_dim,
            s.ssm_groups, s.ssm_state, s.ssm_chunk, torch.bfloat16, False)
    return _roofline.share(
        (rec.get("profile") or {}).get("train"), "ssd_",
        [("ssd_fwd", ssd_work(*args)), ("ssd_bwd", ssd_backward_work(*args))])
