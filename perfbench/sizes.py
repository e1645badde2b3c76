"""The sizes of one model configuration, read from the ``port`` section of
its file under ``perfbench/configs/``: the numbers the weights, the plain
reference and the work counts are built from. Nothing here imports the
program; the file's ``port`` section is the keyword set of the program's
``ModelConfig`` as it runs, and every key read below must be in it."""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

__all__ = ["Sizes", "load_config"]

ROOT = Path(__file__).resolve().parent


def load_config(name: str) -> dict:
    """The configuration file ``configs/<name>.json``."""
    return json.loads((ROOT / "configs" / f"{name}.json").read_text())


@dataclass(frozen=True)
class Sizes:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    padded_vocab: int
    pattern: Tuple[str, ...]
    repeats: int
    rope_theta: float
    num_experts: int
    experts_physical: int
    top_k: int
    moe_d_ff: int
    capacity_factor: float
    moe_group_size: int
    ssm_state: int
    ssm_head_dim: int
    ssm_d_inner: int
    ssm_heads: int
    ssm_groups: int
    ssm_chunk: int
    ssm_conv: int
    window: Optional[int]
    decode_hot_len: int

    @property
    def num_layers(self) -> int:
        return self.repeats * len(self.pattern)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @classmethod
    def of(cls, port: dict) -> "Sizes":
        m = port["d_model"]
        pattern = tuple(port["pattern"])
        if port["num_layers"] % len(pattern):
            raise ValueError("num_layers is not a whole number of periods")
        d_in = port["ssm_expand"] * m
        return cls(
            d_model=m,
            num_heads=port["num_heads"],
            num_kv_heads=port["num_kv_heads"],
            head_dim=port["head_dim"] or m // max(1, port["num_heads"]),
            d_ff=port["d_ff"],
            vocab=port["vocab_size"],
            padded_vocab=-(-port["vocab_size"] // 256) * 256,
            pattern=pattern,
            repeats=port["num_layers"] // len(pattern),
            rope_theta=float(port["rope_theta"]),
            num_experts=port["num_experts"],
            experts_physical=max(port["num_experts"],
                                 port["moe_pad_experts_to"]),
            top_k=port["num_experts_per_token"],
            moe_d_ff=port["moe_d_ff"],
            capacity_factor=float(port["capacity_factor"]),
            moe_group_size=port["moe_group_size"],
            ssm_state=port["ssm_state"],
            ssm_head_dim=port["ssm_head_dim"],
            ssm_d_inner=d_in,
            ssm_heads=d_in // port["ssm_head_dim"],
            ssm_groups=port["ssm_groups"],
            ssm_chunk=port["ssm_chunk"],
            ssm_conv=port["ssm_conv"],
            window=port["window"],
            decode_hot_len=port["decode_hot_len"],
        )
