"""qwen3-moe-235b-a22b — large sparse MoE.

[moe] 94L d_model=4096 64H (GQA kv=4) d_ff=1536 (per expert)
vocab=151936, MoE 128e top-8 [hf:Qwen/Qwen3-30B-A3B; hf].
"""

from .base import ModelConfig, register_config


@register_config("qwen3-moe-235b-a22b")
def qwen3_moe_235b_a22b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        source="hf:Qwen/Qwen3-30B-A3B",
        num_layers=94,
        d_model=4096,
        num_heads=64,
        num_kv_heads=4,
        head_dim=128,
        d_ff=0,
        vocab_size=151936,     # padded to 152064
        pattern=("attn",),
        num_experts=128,
        num_experts_per_token=8,
        moe_d_ff=1536,
        # dispatch groups must not cross sequence-parallel shard
        # boundaries (4096-token rows / 16-way SP = 256-token shards):
        # shard-local grouping keeps the (g,gs,m) reshape collective-free
        # (§Perf iter C3)
        moe_group_size=256,
        rope_theta=1000000.0,
    )
