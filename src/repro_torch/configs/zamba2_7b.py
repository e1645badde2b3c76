"""zamba2-7b — Mamba-2 trunk with two alternating shared transformer blocks.

[hybrid] 81L d_model=3584 32H (MHA) head_dim=224 ffn=14336 vocab=32000,
mamba_ngroups=2, state 64 [arXiv:2411.15242;
huggingface.co/Zyphra/Zamba2-7B-Instruct config.json].

A ``zamba_hybrid`` layer is a Mamba-2 layer whose input first takes the
output of a shared transformer block: the block (attention over the
7168-wide concatenation of the residual stream and the token embedding,
32 heads of 224, RoPE, softmax scale (224 / 2)^-1/2; an RMSNorm; a gated
exact-GELU feed-forward of 14336 with a rank-128 adapter of the
application's own on its gate-and-up product) is one of
``shared_blocks`` = 2 parameter sets, applied in turn, and its output goes
through the application's own 3584 x 3584 projection into the Mamba
layer's normed input (no residual of its own).

Departure from the published order: its 81 layers put hybrids at 6 and
11, then at every 6th layer to 77, and three Mamba layers after the last.
The port's pattern x repeats cannot express that, so this registers the
periodic body, (5 x ``ssm``, ``zamba_hybrid``) x 13 = 78 layers: the same
13 hybrid applications and blocks alternating by application, three
Mamba layers fewer.
"""

from .base import HybridConfig, register_config


@register_config("zamba2-7b")
def zamba2_7b() -> HybridConfig:
    return HybridConfig(
        name="zamba2-7b",
        family="hybrid",
        source="https://huggingface.co/Zyphra/Zamba2-7B-Instruct",
        num_layers=78,
        d_model=3584,
        num_heads=32,
        num_kv_heads=32,       # MHA in the shared blocks
        head_dim=224,          # attention_head_dim = 2 x 3584 / 32
        d_ff=14336,
        vocab_size=32000,
        pattern=("ssm", "ssm", "ssm", "ssm", "ssm", "zamba_hybrid"),
        rope_theta=10000.0,
        shared_blocks=2,       # num_mem_blocks
        adapter_rank=128,      # use_shared_mlp_adapter
        ssm_state=64,
        ssm_head_dim=64,
        ssm_expand=2,          # d_inner = 7168, 112 SSD heads
        ssm_groups=2,          # mamba_ngroups
        ssm_chunk=256,
        long_context_ok=True,  # SSM + a few attn blocks → long_500k runs
    )
