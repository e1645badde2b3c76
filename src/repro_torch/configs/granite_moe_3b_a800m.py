"""granite-moe-3b-a800m — fine-grained MoE.

[moe] 32L d_model=1536 24H (GQA kv=8) d_ff=512 (per expert) vocab=49155,
MoE 40e top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].
"""

from .base import ModelConfig, register_config


@register_config("granite-moe-3b-a800m")
def granite_moe_3b_a800m() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
        num_layers=32,
        d_model=1536,
        num_heads=24,
        num_kv_heads=8,
        d_ff=0,
        vocab_size=49155,      # padded to 49408
        pattern=("attn",),
        num_experts=40,
        num_experts_per_token=8,
        moe_d_ff=512,
        # small E ⇒ capacity C = gs·k/E·cf explodes with group size;
        # 256-token groups keep C at 64 (§Perf iter A1)
        moe_group_size=256,
        # 40 ∤ 16: pad to 48 dead-expert slots so the expert dim shards
        # over the 16-way model axis (EP) — §Perf iter A6
        moe_pad_experts_to=48,
        rope_theta=10000.0,
    )
