"""qwen2-vl-72b — VLM backbone with M-RoPE (modality frontend stubbed).

[vlm] 80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064 — M-RoPE,
dynamic resolution [arXiv:2409.12191; hf]. Per the assignment, this
entry is the transformer BACKBONE only: ``input_specs()`` provides
precomputed patch embeddings (``frontend="embed"``).
"""

from .base import ModelConfig, register_config


@register_config("qwen2-vl-72b")
def qwen2_vl_72b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b",
        family="vlm",
        source="arXiv:2409.12191",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152064,
        pattern=("attn",),
        mrope_sections=(16, 24, 24),   # temporal/height/width, half-dim 64
        rope_theta=1000000.0,
        frontend="embed",
        long_context_ok=False,  # pure full attention → long_500k skipped
    )
