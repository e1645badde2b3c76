"""Step-function factories: training and serving, and the abstract inputs of
every (architecture × shape) cell. Port of ``repro.launch.steps``.

``input_specs(cfg, shape)`` and ``serve_params_shapes(cfg)`` return trees
of tensors on the meta device (shapes and dtypes, no memory), the port's
``jax.ShapeDtypeStruct``: the dry run (``repro_torch.launch.dryrun``)
places fakes of them on its mesh. Train cells run ``train_step`` (forward,
backward and the AdamW update); prefill cells ``prefill_step``; decode
cells ``serve_step`` (one new token against a ``seq_len`` cache)."""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..core.telemetry import phases
from ..models import lm
from ..optim.adamw import AdamWConfig, adamw_update, init_opt_state

__all__ = [
    "init_train_state",
    "train_state_shapes",
    "train_state_devices",
    "make_train_step",
    "make_prefill_step",
    "make_serve_step",
    "input_specs",
    "serve_params_shapes",
    "model_flops",
]


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------
def init_train_state(cfg: ModelConfig, generator, device=None) -> Dict[str, Any]:
    """fp32 master parameters (``cfg.param_dtype``) drawn on ``device``,
    zero AdamW moments and a step count (an int32 scalar on the CPU)."""
    params = lm.init_params(cfg, generator, device=device)
    return {
        "params": params,
        "opt": init_opt_state(params),
        "step": torch.zeros((), dtype=torch.int32),
    }


def train_state_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The train state's tree with no memory: its float leaves on the meta
    device (shapes and dtypes only), as ``lm.param_shapes`` builds the
    parameters; a restore target for ``repro_torch.checkpoint``."""
    return init_train_state(cfg, None, device="meta")


def train_state_devices(state: Dict[str, Any], device) -> Dict[str, Any]:
    """Where each leaf of a train state lives, as ``init_train_state``
    places it: ``device`` for the float leaves (parameters and moments),
    the CPU for the int32 step counts."""
    return lm.tree_map(
        lambda x: torch.device(device) if x.is_floating_point()
        else torch.device("cpu"), state)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig = AdamWConfig()):
    cdt = getattr(torch, cfg.compute_dtype)

    def cast_params(p):
        # One cast of the fp32 masters per step, outside the layer loop, as
        # in the JAX step. The cast tensors are the leaves autograd
        # differentiates: the gradient of the cast is the cast of theirs,
        # which the optimizer takes leaf by leaf, so no fp32 copy of the
        # whole gradient is ever held.
        return lm.tree_map(lambda x: x.detach().to(cdt).requires_grad_(), p)

    def train_step(state, batch):
        # three phase spans (core/telemetry/phases.py), recorded only while
        # a runtime backend has installed a recorder
        with phases.section("forward"):
            leaves = cast_params(state["params"])
            loss, metrics = lm.train_loss(cfg, leaves, batch)
        with phases.section("backward"):
            loss.backward()     # the recompute too, under remat "full"
        with phases.section("adamw"):
            grads = lm.tree_map(lambda x: x.grad, leaves)
            del leaves, loss
            new_params, new_opt, opt_metrics = adamw_update(
                opt_cfg, state["params"], grads, state["opt"]
            )
        new_state = {
            "params": new_params,
            "opt": new_opt,
            "step": state["step"] + 1,
        }
        return new_state, {**metrics, **opt_metrics}

    return train_step


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------
def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, inputs):
        return lm.prefill(cfg, params, inputs)

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, token, pos, caches):
        return lm.decode_step(cfg, params, token, pos, caches)

    return serve_step


# ---------------------------------------------------------------------------
# abstract inputs (meta tensors)
# ---------------------------------------------------------------------------
def serve_params_shapes(cfg: ModelConfig):
    """Serving weights: the parameter tree on the meta device, its float
    leaves bf16 (fp32 masters live in the train state)."""
    return lm.init_params(cfg, None, device="meta", dtype=torch.bfloat16)


def _token_spec(cfg: ModelConfig, batch: int, seq: int) -> torch.Tensor:
    if cfg.frontend == "token":
        return torch.empty((batch, seq), dtype=torch.int32, device="meta")
    # VLM/audio stub: precomputed frame/patch embeddings
    return torch.empty((batch, seq, cfg.d_model),
                       dtype=getattr(torch, cfg.compute_dtype), device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[Any, ...]:
    """Abstract inputs for the step the shape runs (params/state apart), as
    meta tensors: a train batch ``{"inputs", "labels"}``; prefill inputs;
    or a decode token, positions and filled caches of ``seq_len`` slots."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        batch = {
            "inputs": _token_spec(cfg, b, s),
            "labels": torch.empty((b, s), dtype=torch.int32, device="meta"),
        }
        return (batch,)
    if shape.kind == "prefill":
        return (_token_spec(cfg, b, s),)
    if shape.kind == "decode":
        token = _token_spec(cfg, b, 1)
        pos = torch.empty((b,), dtype=torch.int32, device="meta")
        caches = lm.init_decode_caches(cfg, b, s, filled=True, device="meta")
        return (token, pos, caches)
    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# model FLOPs accounting
# ---------------------------------------------------------------------------
def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N·tokens for training (fwd+bwd), 2·N·tokens for inference
    forward passes (decode: one token per sequence). N = active params
    contributing matmul FLOPs (embedding-gather excluded)."""
    n = cfg.n_flops_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: 1 new token
