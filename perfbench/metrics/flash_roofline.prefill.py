"""flash_roofline.prefill: the attention launches of one profiled prefill
against their roofline, in percent (kernel names as for
flash_roofline.train)."""

import torch

from perfbench.metrics import _roofline
from perfbench.work.flash import attention_work

PATTERN = "flash_|fmha|sdpa"


def read(rec, cell):
    s, t = cell.sizes, cell.traffic
    args = (t["requests"], t["prompt_len"], t["prompt_len"], s.num_heads,
            s.num_kv_heads, s.head_dim, s.window, torch.bfloat16)
    return _roofline.share((rec.get("profile") or {}).get("prefill"),
                           PATTERN, [("flash_attention_fwd",
                                      attention_work(*args))])
