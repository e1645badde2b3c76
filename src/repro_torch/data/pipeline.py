"""Synthetic sharded data pipeline with background prefetch. Port of
``repro.data.pipeline``: the same batches, bit for bit, as NumPy arrays.

Each process generates only its shard of the global batch
(``process_index``-keyed), a background thread keeps a bounded prefetch
queue full, and batches are deterministic functions of (seed, step) so a
restart reproduces the same stream. The process index and count come from
the arguments, else from ``torch.distributed`` when it is initialised,
else 0 and 1.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch

__all__ = ["DataConfig", "SyntheticTokenPipeline"]


@dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    embed_dim: int = 0        # >0 → embedding frontend (VLM/audio stub)
    prefetch: int = 2


def _process_index_count():
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class SyntheticTokenPipeline:
    """Deterministic synthetic LM stream, sharded across processes."""

    def __init__(self, cfg: DataConfig,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.cfg = cfg
        rank, world = _process_index_count()
        self.pidx = rank if process_index is None else process_index
        self.pcount = world if process_count is None else process_count
        if cfg.global_batch % self.pcount:
            raise ValueError("global batch must divide process count")
        self.local_batch = cfg.global_batch // self.pcount
        self._q: "queue.Queue" = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._step = 0
        self._thread: Optional[threading.Thread] = None

    # -- deterministic batch synthesis -----------------------------------
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.cfg.seed * 1_000_003 + step) * 65_537 + self.pidx
        )
        c = self.cfg
        labels = rng.integers(
            0, c.vocab_size, (self.local_batch, c.seq_len), dtype=np.int32
        )
        if c.embed_dim:
            # (B, S, M) fp32 frame or patch embeddings, drawn after the labels
            inputs = rng.standard_normal(
                (self.local_batch, c.seq_len, c.embed_dim), dtype=np.float32
            )
        else:
            inputs = np.roll(labels, 1, axis=1)   # next-token structure
            inputs[:, 0] = 0
        return {"inputs": inputs, "labels": labels}

    # -- prefetch loop -----------------------------------------------------
    def _worker(self, start_step: int):
        step = start_step
        while not self._stop.is_set():
            batch = self.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def start(self, start_step: int = 0) -> None:
        self._stop.clear()
        self._step = start_step
        self._thread = threading.Thread(
            target=self._worker, args=(start_step,), daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            # drain so the worker can observe the stop flag
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=2.0)
            self._thread = None

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self._thread is None:
            self.start(self._step)
        while True:
            step, batch = self._q.get()
            self._step = step + 1
            yield batch
