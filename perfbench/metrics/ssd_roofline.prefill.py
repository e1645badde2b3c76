"""ssd_roofline.prefill: the SSD scan's launches of one profiled prefill
(each returning its final state for the decode caches) against their
roofline, in percent; operations named ``ssd_`` are the scan's."""

import torch

from perfbench.metrics import _roofline
from perfbench.work.ssd import ssd_work


def read(rec, cell):
    s, t = cell.sizes, cell.traffic
    args = (t["requests"], t["prompt_len"], s.ssm_heads, s.ssm_head_dim,
            s.ssm_groups, s.ssm_state, s.ssm_chunk, torch.bfloat16, True)
    return _roofline.share((rec.get("profile") or {}).get("prefill"), "ssd_",
                           [("ssd_fwd", ssd_work(*args))])
