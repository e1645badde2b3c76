"""h2o-danube-3-4b — dense llama/mistral mix with sliding-window attention.

[dense] 24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000 —
llama+mistral mix, SWA [arXiv:2401.16818; unverified].
"""

from .base import ModelConfig, register_config


@register_config("h2o-danube-3-4b")
def h2o_danube_3_4b() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b",
        family="dense",
        source="arXiv:2401.16818",
        num_layers=24,
        d_model=3840,
        num_heads=32,
        num_kv_heads=8,
        d_ff=10240,
        vocab_size=32000,
        pattern=("attn",),
        window=4096,           # mistral-style SWA at every layer
        rope_theta=10000.0,
        # windowed cache is bounded → long_500k runs (sub-quadratic)
        long_context_ok=True,
    )
