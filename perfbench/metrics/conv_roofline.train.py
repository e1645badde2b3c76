"""conv_roofline.train: the Mamba-2 mixer's causal conv + SiLU launches of
the profiled training steps (forward, remat's second forward and
backward) against their roofline, in percent; operations named
``causal_conv_`` are the conv's. Each layer's call takes its x, B and C
(widths d_inner, G·N and G·N) at once. A program without the conv's
kernels counts no launch and names no such operation: nothing is read."""

import torch

from perfbench.metrics import _roofline
from perfbench.work.conv import conv_backward_work, conv_work


def read(rec, cell):
    s, t = cell.sizes, cell.traffic
    gn = s.ssm_groups * s.ssm_state
    args = (t["batch"], t["seq_len"], (s.ssm_d_inner, gn, gn), s.ssm_conv,
            torch.bfloat16)
    return _roofline.share(
        (rec.get("profile") or {}).get("train"), "causal_conv_",
        [("causal_conv_fwd", conv_work(*args)),
         ("causal_conv_bwd", conv_backward_work(*args))])
