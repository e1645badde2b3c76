"""Step-function factories for serving. Port of the serve half of
``repro.launch.steps`` (``make_prefill_step``, ``make_serve_step``);
the training step comes with the training slice."""

from __future__ import annotations

from ..configs.base import ModelConfig
from ..models import lm

__all__ = ["make_prefill_step", "make_serve_step"]


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, inputs):
        return lm.prefill(cfg, params, inputs)

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, token, pos, caches):
        return lm.decode_step(cfg, params, token, pos, caches)

    return serve_step
