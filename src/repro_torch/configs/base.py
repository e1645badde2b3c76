"""Configuration system: model configs, input-shape configs, registry.

Every assigned architecture is a frozen ``ModelConfig``; shapes are the
four assigned input-shape sets. ``--arch <id>`` resolves through
:func:`get_config`; reduced smoke variants via :func:`smoke_config`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Optional, Tuple

__all__ = [
    "ModelConfig",
    "ShapeConfig",
    "SHAPES",
    "register_config",
    "get_config",
    "list_configs",
    "smoke_config",
]


def _round_up(x: int, mult: int) -> int:
    return (x + mult - 1) // mult * mult


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""                  # citation from the assignment table
    # trunk
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0                 # 0 → d_model // num_heads
    d_ff: int = 0                     # dense FFN width (0 → no FFN)
    vocab_size: int = 0
    # layer pattern: tuple of block kinds forming one scan "super-layer";
    # repeated num_layers // len(pattern) times.
    pattern: Tuple[str, ...] = ("attn",)   # attn | attn_local | attn_global | ssm | shared_attn
    # attention features
    window: Optional[int] = None       # sliding-window size (SWA / local layers)
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, ...]] = None   # M-RoPE (qwen2-vl)
    # MoE
    num_experts: int = 0
    num_experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 1024         # tokens per dispatch group
    moe_pad_experts_to: int = 0        # pad expert dim (dead experts) so
    #                                    it divides the model axis → EP
    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv: int = 4
    ssm_groups: int = 1
    # frontend: "token" (embedding table) or "embed" (precomputed
    # patch/frame embeddings — VLM/audio stub per assignment)
    frontend: str = "token"
    # numerics / execution
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    attn_kv_chunk: int = 1024          # chunked-attention KV block
    loss_chunk: int = 16384            # chunked cross-entropy block
    remat: str = "full"                # full | none
    scan_layers: bool = True           # lax.scan stack (False: unrolled)
    decode_hot_len: int = 128          # mutable hot-ring slots per cache
    embed_onehot: bool = False         # one-hot matmul embedding — §Perf
    #                                    iter C5: refuted (one-hot traffic
    #                                    outweighs the fp32-gather psum)
    # notes (e.g. long_500k applicability)
    long_context_ok: bool = False

    # ---- derived ----
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(1, self.num_heads)

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 256)

    @property
    def repeats(self) -> int:
        if self.num_layers % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: num_layers {self.num_layers} not divisible by "
                f"pattern period {len(self.pattern)}"
            )
        return self.num_layers // len(self.pattern)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def moe_experts_physical(self) -> int:
        return max(self.num_experts, self.moe_pad_experts_to)

    def n_params(self) -> int:
        """Approximate parameter count (for 6ND model-FLOPs accounting)."""
        m, v = self.d_model, self.padded_vocab
        total = 0
        if self.frontend == "token":
            total += v * m
        total += v * m  # unembed
        hd = self.resolved_head_dim
        per_kind: Dict[str, int] = {}
        attn = m * (self.num_heads * hd) + 2 * m * (self.num_kv_heads * hd) \
            + (self.num_heads * hd) * m
        dense_ffn = 3 * m * self.d_ff if self.d_ff else 0
        moe_ffn = (
            self.moe_experts_physical * 3 * m * self.moe_d_ff
            + m * self.num_experts
            if self.is_moe
            else 0
        )
        ffn = moe_ffn if self.is_moe else dense_ffn
        per_kind["attn"] = attn + ffn + 2 * m
        per_kind["attn_local"] = per_kind["attn"]
        per_kind["attn_global"] = per_kind["attn"]
        per_kind["shared_attn"] = per_kind["attn"]  # counted once below
        d_in = self.ssm_d_inner
        n, h = self.ssm_state, self.ssm_heads
        per_kind["ssm"] = (
            m * d_in * 2                      # Wz, Wx
            + 2 * m * (self.ssm_groups * n)   # WB, WC
            + m * h                           # Wdt
            + d_in * m                        # out
            + 2 * m                           # norms
        )
        shared_seen = False
        for r in range(self.repeats):
            for kind in self.pattern:
                if kind == "shared_attn":
                    if not shared_seen:
                        total += per_kind["shared_attn"]
                        shared_seen = True
                else:
                    total += per_kind[kind]
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if not self.is_moe:
            return self.n_params()
        m = self.d_model
        inactive = (
            (self.moe_experts_physical - self.num_experts_per_token)
            * 3 * m * self.moe_d_ff
        ) * self.num_layers
        return self.n_params() - inactive

    def n_flops_params(self) -> int:
        """Params that contribute matmul FLOPs per token: active params
        minus the input-embedding table (a gather, not a matmul). This is
        the 6·N·D / 2·N·D numerator."""
        n = self.n_active_params()
        if self.frontend == "token":
            n -= self.padded_vocab * self.d_model
        return n


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode
    # decode shapes: one new token against a cache of seq_len


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


_CONFIGS: Dict[str, Callable[[], ModelConfig]] = {}


def register_config(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _CONFIGS[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _CONFIGS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_CONFIGS)}")
    return _CONFIGS[name]()


def list_configs():
    return sorted(_CONFIGS)


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: few layers, small
    width, few experts, tiny vocab — structure preserved."""
    cfg = get_config(name)
    period = len(cfg.pattern)
    updates = dict(
        num_layers=2 * period,
        d_model=64,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
        num_heads=max(2, min(4, cfg.num_heads)) if cfg.num_heads else 0,
        num_kv_heads=0,
        head_dim=16 if cfg.num_heads else 0,
        window=min(cfg.window, 64) if cfg.window else None,
        moe_group_size=64,
        loss_chunk=256,
        attn_kv_chunk=64,
        decode_hot_len=16,
        ssm_chunk=32,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
    )
    if cfg.num_heads:
        nh = updates["num_heads"]
        # preserve GQA grouping where possible
        ratio = max(1, cfg.num_heads // max(1, cfg.num_kv_heads))
        updates["num_kv_heads"] = max(1, nh // min(ratio, nh))
    if cfg.is_moe:
        # capacity_factor 8 ⇒ no token drops at smoke scale, making
        # outputs batch-context-invariant (prefill/decode comparable)
        updates.update(num_experts=4, num_experts_per_token=2, moe_d_ff=64,
                       capacity_factor=8.0)
    if cfg.mrope_sections:
        updates["mrope_sections"] = (2, 3, 3)  # sums to head_dim/2 = 8
    return replace(cfg, **updates)
