"""The rule that holds a model's bf16 run on the card to the CPU, shared by
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` (neither imports JAX, and
neither does this module).

The card's kernels take bf16 activations only. They sum in fp32 and round
once, where the plain versions the CPU runs round after every op, so two
bf16 runs of one model may differ by more than an elementwise bf16
tolerance without a fault: some models' random weights carry one ulp to
several percent of their logits or gradient norm. So a bf16 result of the
card is held to the CPU's fp32 run of the same weights and inputs: in
relative norm, no further from it than twice the CPU's bf16 run is, plus
``TOL_BF16``. A missing gradient is off by 1.
"""

import torch

TOL_BF16 = 2e-2   # tests/test_kernels.py::_tol at bf16


def rel_norm(got: torch.Tensor, want: torch.Tensor) -> float:
    """``|got - want| / |want|`` in the 2-norm."""
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def bf16_no_worse(card: torch.Tensor, cpu: torch.Tensor, fp32: torch.Tensor,
                  what: str = "") -> tuple:
    """Return (the card's error, the CPU's error): ``card`` (the card's
    bf16 run) and ``cpu`` (the CPU's bf16 run) in relative norm from
    ``fp32`` (the CPU's fp32 run). Raise ``AssertionError``, naming
    ``what``, if the card's error is past twice the CPU's plus
    ``TOL_BF16``."""
    card_err, cpu_err = rel_norm(card, fp32), rel_norm(cpu, fp32)
    bound = 2 * cpu_err + TOL_BF16
    assert card_err <= bound, (what, card_err, cpu_err, bound)
    return card_err, cpu_err
