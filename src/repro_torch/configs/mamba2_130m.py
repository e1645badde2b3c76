"""mamba2-130m — pure SSM (attention-free), SSD core.

[ssm] 24L d_model=768 (attn-free) d_ff=0 vocab=50280, ssm_state=128 —
SSD (state-space duality) [arXiv:2405.21060; unverified].
"""

from .base import ModelConfig, register_config


@register_config("mamba2-130m")
def mamba2_130m() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        source="arXiv:2405.21060",
        num_layers=24,
        d_model=768,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        pattern=("ssm",),
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,          # d_inner = 1536, 24 SSD heads
        ssm_chunk=256,
        long_context_ok=True,  # constant-size state: long_500k runs
    )
