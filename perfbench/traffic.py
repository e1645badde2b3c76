"""The benchmark's inputs, drawn from ``--seed``: one general generator
for every traffic mix under ``perfbench/traffic/``, whose data file gives
its sizes.

``prompts`` is a copy of the program's ``repro_torch.launch.serve.
make_prompts`` (token frontend), drawn per batch; ``train_batch`` is a copy
of ``repro_torch.data.pipeline.SyntheticTokenPipeline.batch_at`` for one
process: random labels, the inputs the labels shifted right by one with a
0 in front. Every batch of a run gets its own draw, so no two rows
repeat."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np
import torch

__all__ = ["load_traffic", "prompts", "train_batch", "batch_seed"]

ROOT = Path(__file__).resolve().parent


def load_traffic(name: str) -> dict:
    return json.loads((ROOT / "traffic" / f"{name}.json").read_text())


def batch_seed(seed: int, index: int) -> int:
    """A generator seed for batch ``index`` of the run seeded ``seed``."""
    return (seed * 1_000_003 + index) % (1 << 63)


def prompts(vocab: int, requests: int, prompt_len: int, seed: int,
            index: int, device) -> torch.Tensor:
    """Batch ``index``'s prompts: int32 (requests, prompt_len) tokens in
    [0, vocab), drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(batch_seed(seed, index))
    return torch.randint(0, vocab, (requests, prompt_len), generator=gen,
                         device=device, dtype=torch.int32)


def train_batch(vocab: int, batch: int, seq_len: int, seed: int,
                step: int) -> Dict[str, np.ndarray]:
    """Training batch ``step`` as NumPy int32 arrays ``inputs`` and
    ``labels`` (batch, seq_len)."""
    rng = np.random.default_rng((seed * 1_000_003 + step) * 65_537)
    labels = rng.integers(0, vocab, (batch, seq_len), dtype=np.int32)
    inputs = np.roll(labels, 1, axis=1)
    inputs[:, 0] = 0
    return {"inputs": inputs, "labels": labels}
