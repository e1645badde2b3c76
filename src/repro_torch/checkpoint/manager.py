"""CheckpointManager: rotation, async (background-thread) saves, resume.
Port of ``repro.checkpoint.manager``.

Async saves snapshot the state to host memory synchronously and write
the files in a worker thread, so the train loop blocks only for the
snapshot: the TALP host timeline shows a short window in the trainer's
``mpi()`` state instead of a long Useful gap (checkpointing is one of
the classic Orchestration-Efficiency sinks the paper's metrics expose).

The snapshot is a copy, made before :meth:`CheckpointManager.save`
returns: the port's AdamW updates parameters and moments in place, and
``Tensor.cpu()`` of a CPU tensor is the tensor itself, so a writer given
the live tensors (or views of them) would write a later step's values.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Optional, Tuple

from .checkpointer import (
    latest_step,
    list_steps,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["CheckpointManager", "host_snapshot"]


def host_snapshot(state: Any) -> Any:
    """A copy of ``state`` (a nested dict of tensors) in host memory, owned
    by no one else, whatever device the leaves are on."""
    if isinstance(state, dict):
        return {k: host_snapshot(v) for k, v in state.items()}
    return state.detach().to("cpu", copy=True)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def wait(self) -> None:
        """Block until any in-flight save completes (and re-raise errors)."""
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, host_state: Any) -> None:
        try:
            save_checkpoint(self.directory, step, host_state)
            self._rotate()
        except BaseException as e:  # surfaced on next wait()/save()
            self._error = e

    def _rotate(self) -> None:
        steps = list_steps(self.directory)
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def save(self, step: int, state: Any) -> None:
        self.wait()  # one in-flight save at a time
        host_state = host_snapshot(state)
        if self.async_save:
            self._worker = threading.Thread(
                target=self._write, args=(step, host_state), daemon=True
            )
            self._worker.start()
        else:
            self._write(step, host_state)
            if self._error is not None:
                err, self._error = self._error, None
                raise err

    def restore_latest(
        self, target: Any, devices: Any = None
    ) -> Tuple[Optional[Any], int]:
        """(state, next_step); (None, 0) when no checkpoint exists.
        ``devices``: as in :func:`restore_checkpoint`."""
        self.wait()
        step = latest_step(self.directory)
        if step is None:
            return None, 0
        state = restore_checkpoint(self.directory, step, target, devices)
        return state, step + 1

