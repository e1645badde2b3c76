"""The model's operations per training step and per prefill, counted from
the configuration's sizes: the products of the weights a token passes
through (the embedding is a gather and counts nothing; an MoE layer counts
its top-k experts and its router, not the dense dispatch's capacity
slots; the shared attention block of a Zamba-2 pattern counts once per
application), attention over the visible (query, key) pairs and the SSD
scan's own operations, each by the frozen formulas beside this file.

A training step counts three times the forward's products (the backward
twice) and, for attention and the scan, the forward and the backward by
their formulas; remat's recomputed forward is not counted. A prefill
counts the output projection for the last position of each request only,
the one the program computes."""

from __future__ import annotations

import torch

from ..sizes import Sizes
from .flash import attention_backward_work, attention_work
from .ssd import ssd_backward_work, ssd_work

__all__ = ["block_params", "body_params", "train_step", "prefill"]


def block_params(s: Sizes, kind: str) -> int:
    """Matmul parameters one token passes through in one block."""
    m = s.d_model
    if kind == "ssm":
        gn = s.ssm_groups * s.ssm_state
        return 2 * m * s.ssm_d_inner + 2 * m * gn + m * s.ssm_heads \
            + s.ssm_d_inner * m
    hd = s.head_dim
    attn = 2 * m * s.num_heads * hd + 2 * m * s.num_kv_heads * hd
    if s.is_moe:
        return attn + s.top_k * 3 * m * s.moe_d_ff + m * s.num_experts
    return attn + 3 * m * s.d_ff


def body_params(s: Sizes) -> int:
    """Matmul parameters one token passes through in all the layers."""
    return s.repeats * sum(block_params(s, k) for k in s.pattern)


def _layers(s: Sizes, attention: bool) -> int:
    return s.repeats * sum((k != "ssm") == attention for k in s.pattern)


def _attention(s: Sizes, b: int, t: int, backward: bool) -> float:
    args = (b, t, t, s.num_heads, s.num_kv_heads, s.head_dim, s.window,
            torch.bfloat16)
    flops = attention_work(*args)[0]
    if backward:
        flops += attention_backward_work(*args)[0]
    return _layers(s, True) * flops


def _scan(s: Sizes, b: int, t: int, backward: bool) -> float:
    args = (b, t, s.ssm_heads, s.ssm_head_dim, s.ssm_groups, s.ssm_state,
            s.ssm_chunk, torch.bfloat16, False)
    flops = ssd_work(*args)[0]
    if backward:
        flops += ssd_backward_work(*args)[0]
    return _layers(s, False) * flops


def train_step(s: Sizes, batch: int, seq: int) -> float:
    tokens = batch * seq
    dense = 6.0 * (body_params(s) + s.d_model * s.padded_vocab) * tokens
    return dense + _attention(s, batch, seq, True) + _scan(s, batch, seq,
                                                           True)


def prefill(s: Sizes, requests: int, prompt_len: int) -> float:
    dense = (2.0 * body_params(s) * requests * prompt_len
             + 2.0 * s.d_model * s.padded_vocab * requests)
    return dense + _attention(s, requests, prompt_len, False) + _scan(
        s, requests, prompt_len, False)
