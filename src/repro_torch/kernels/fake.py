"""Fake tensors at the kernels.

A fake tensor (``torch._subclasses.fake_tensor.FakeTensor``: a shape, a
dtype and a device, no memory) that reaches a kernel wrapper takes the
kernel's place, whatever its device: the wrapper checks it as it checks a
real one, allocates the same outputs and scratch as fakes, launches
nothing and calls no plain version, and hands the kernel's work (its
``work`` module's operations and bytes) to the fake mode that made the
tensor, where that mode counts work: one with a ``record_kernel(name,
flops, nbytes)`` method, as the dry run's counter
(``repro_torch.launch.dryrun``). Launch counters do not move."""

from __future__ import annotations

import sys

__all__ = ["is_fake", "record_work"]


def is_fake(x) -> bool:
    """Whether ``x`` is a fake tensor. Imports nothing (it runs on every
    kernel call): a fake tensor exists only once its module is loaded."""
    module = sys.modules.get("torch._subclasses.fake_tensor")
    return module is not None and isinstance(x, module.FakeTensor)


def record_work(x, name: str, flops: float, nbytes: int) -> None:
    """Give a kernel's work to the fake mode of the fake tensor ``x``, if
    that mode counts work."""
    record = getattr(x.fake_mode, "record_kernel", None)
    if record is not None:
        record(name, flops, nbytes)
