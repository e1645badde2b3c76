"""starcoder2-15b — dense code model, GQA + RoPE.

[dense] 40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152
[arXiv:2402.19173; hf].
"""

from .base import ModelConfig, register_config


@register_config("starcoder2-15b")
def starcoder2_15b() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b",
        family="dense",
        source="arXiv:2402.19173",
        num_layers=40,
        d_model=6144,
        num_heads=48,
        num_kv_heads=4,
        d_ff=24576,
        vocab_size=49152,
        pattern=("attn",),
        rope_theta=100000.0,
        long_context_ok=False,  # pure full attention → long_500k skipped
    )
