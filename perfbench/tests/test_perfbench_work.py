"""The frozen work formulas equal the program's today at the launch shapes
of the benchmark's cell and of the configuration kept for later cells,
and the model count gives the figures PERF.md cites."""

import pytest
import torch

from perfbench.sizes import Sizes, load_config
from perfbench.work import flash, model_flops, ssd

MAMBA = Sizes.of(load_config("mamba2-2.7b")["port"])
GRANITE = Sizes.of(load_config("granite-moe-3b-a800m")["port"])
# (b, s, t, h, k, d) of attention launches: granite's training and
# prefill shapes, and MHA at D 80 (the program's zamba2 layout)
FLASH_SHAPES = [(2, 4096, 4096, 32, 32, 80), (8, 4096, 4096, 32, 32, 80),
                (2, 2048, 2048, 24, 8, 64), (64, 256, 256, 24, 8, 64)]
# (b, l, h, p, g, n, chunk, with_state) of SSD launches: the training
# cell's, and a prefill's (final state out)
SSD_SHAPES = [(4, 2048, 80, 64, 1, 128, 256, False),
              (8, 4096, 80, 64, 1, 128, 256, True)]


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_work_is_the_programs(shape):
    from repro_torch.kernels.flash_attention import work

    args = shape + (None, torch.bfloat16)
    assert flash.attention_work(*args) == work.attention_work(*args)
    assert flash.attention_backward_work(*args) == \
        work.attention_backward_work(*args)


@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_work_is_the_programs(shape):
    from repro_torch.kernels.ssd import work

    args = shape[:7] + (torch.bfloat16, shape[7])
    assert ssd.ssd_work(*args) == work.ssd_work(*args)
    assert ssd.ssd_backward_work(*args) == work.ssd_backward_work(*args)


def test_mamba2_training_step_count():
    """145.15 TFLOP a step at 4 x 2048: 132.75 of six times the products
    (2.572 B in the 64 blocks, 0.129 B in the output projection) per
    token, and 12.40 of the scan's forward and backward."""
    total = model_flops.train_step(MAMBA, 4, 2048)
    assert total / 1e12 == pytest.approx(145.15, abs=0.01)
    products = 6.0 * (model_flops.body_params(MAMBA)
                      + MAMBA.d_model * MAMBA.padded_vocab) * 8192
    assert products / 1e12 == pytest.approx(132.75, abs=0.01)
    assert model_flops.body_params(MAMBA) / 1e9 == pytest.approx(
        2.5716, abs=1e-4)


def test_granite_counts():
    """24.59 TFLOP a training step; 26.88 a prefill, 29.36 counting the
    output projection at every prompt position."""
    assert model_flops.train_step(GRANITE, 2, 2048) / 1e12 == \
        pytest.approx(24.59, abs=0.01)
    total = model_flops.prefill(GRANITE, 64, 256)
    assert total / 1e12 == pytest.approx(26.88, abs=0.01)
    every = total + 2.0 * GRANITE.d_model * GRANITE.padded_vocab * 64 * 255
    assert every / 1e12 == pytest.approx(29.36, abs=0.02)


def test_moe_counts_top_k_experts_and_the_router():
    m, f = GRANITE.d_model, GRANITE.moe_d_ff
    attn = 2 * m * 24 * 64 + 2 * m * 8 * 64
    assert model_flops.block_params(GRANITE, "attn") == \
        attn + 8 * 3 * m * f + m * 40
