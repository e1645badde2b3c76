"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W limit): the denominators of
every ``mfu.*`` and ``*_roofline.*`` metric. A card set to a lower power
limit reads lower against them; the harness prints the card's limit beside
every run."""

BF16_FLOPS = 989e12
HBM_BYTES = 3.35e12
