"""flash_roofline.train: the attention launches of the profiled training
steps (forward, remat's second forward and backward) against their
roofline, in percent. Operations named like the program's flash kernels,
PyTorch's own flash and memory-efficient kernels or cuDNN's SDPA kernels
are attention's."""

import torch

from perfbench.metrics import _roofline
from perfbench.work.flash import attention_backward_work, attention_work

PATTERN = "flash_|fmha|sdpa"


def read(rec, cell):
    s, t = cell.sizes, cell.traffic
    args = (t["batch"], t["seq_len"], t["seq_len"], s.num_heads,
            s.num_kv_heads, s.head_dim, s.window, torch.bfloat16)
    return _roofline.share(
        (rec.get("profile") or {}).get("train"), PATTERN,
        [("flash_attention_fwd", attention_work(*args)),
         ("flash_attention_bwd", attention_backward_work(*args))])
