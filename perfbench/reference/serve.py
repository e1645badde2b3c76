"""The reference's logits along served requests: prefill of the prompts,
then one token at a time, each fed the program's served token, so that
every served token is judged by the logits the reference gives at the
position that produced it."""

from __future__ import annotations

from typing import Iterator

import torch

from ..sizes import Sizes
from .lm import Model, exact_fp32

__all__ = ["served_logits"]


@torch.no_grad()
def served_logits(model: Model, prompts: torch.Tensor,
                  served: torch.Tensor) -> Iterator[torch.Tensor]:
    """For each position j of ``served`` (B, G), the reference's logits
    (B, vocab) that predict ``served[:, j]``."""
    s: Sizes = model.s
    with exact_fp32():
        caches = {}
        h, _ = model.hidden(prompts, 0, caches)
        yield model.logits(h[:, -1])[:, :s.vocab]
        pos = prompts.shape[1]
        for j in range(1, served.shape[1]):
            h, _ = model.hidden(served[:, j - 1:j], pos, caches)
            pos += 1
            yield model.logits(h[:, -1])[:, :s.vocab]
