"""musicgen-large — decoder-only over EnCodec tokens (audio frontend stubbed).

[audio] 48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048 —
decoder-only over EnCodec tokens [arXiv:2306.05284; hf]. Backbone only:
``input_specs()`` provides precomputed frame embeddings
(``frontend="embed"``); the EnCodec quantizer stack is out of scope per
the assignment.
"""

from .base import ModelConfig, register_config


@register_config("musicgen-large")
def musicgen_large() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        family="audio",
        source="arXiv:2306.05284",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,       # MHA
        d_ff=8192,
        vocab_size=2048,
        pattern=("attn",),
        rope_theta=10000.0,
        frontend="embed",
        long_context_ok=False,  # pure full attention → long_500k skipped
    )
