"""zamba2-2.7b — Mamba-2 trunk with shared attention blocks.

[hybrid] 54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000,
ssm_state=64 — Mamba2 + shared attn blocks [arXiv:2411.15242; hf].

Pattern: every 6th layer is an attention+MLP block whose *weights are
shared* across all applications (one parameter set, 9 distinct KV
caches), the rest are Mamba-2 SSD blocks — the Zamba-2 design.
"""

from .base import ModelConfig, register_config


@register_config("zamba2-2.7b")
def zamba2_2_7b() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        source="arXiv:2411.15242",
        num_layers=54,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,       # MHA in the shared block
        d_ff=10240,
        vocab_size=32000,
        pattern=("ssm", "ssm", "ssm", "ssm", "ssm", "shared_attn"),
        ssm_state=64,
        ssm_head_dim=64,
        ssm_expand=2,          # d_inner = 5120, 80 SSD heads
        rope_theta=10000.0,
        long_context_ok=True,  # SSM + a few attn blocks → long_500k runs
    )
