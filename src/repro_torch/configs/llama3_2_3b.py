"""llama3.2-3b — small dense llama3.

[dense] 28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256
[hf:meta-llama/Llama-3.2-1B; unverified].
"""

from .base import ModelConfig, register_config


@register_config("llama3.2-3b")
def llama3_2_3b() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b",
        family="dense",
        source="hf:meta-llama/Llama-3.2-1B",
        num_layers=28,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=128256,
        pattern=("attn",),
        rope_theta=500000.0,
        # pure full attention at every layer → long_500k skipped
        long_context_ok=False,
    )
