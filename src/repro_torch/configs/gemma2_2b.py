"""gemma2-2b — alternating local/global attention with logit soft-capping.

[dense] 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000 —
local+global alternating, logit softcap [arXiv:2408.00118; hf].
"""

from .base import ModelConfig, register_config


@register_config("gemma2-2b")
def gemma2_2b() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        family="dense",
        source="arXiv:2408.00118",
        num_layers=26,
        d_model=2304,
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab_size=256000,
        pattern=("attn_local", "attn_global"),  # period-2 alternation
        window=4096,                            # local layers
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        rope_theta=10000.0,
        # local layers bounded; global layers sequence-sharded KV →
        # long_500k runs (alternating, not pure full attention)
        long_context_ok=True,
    )
