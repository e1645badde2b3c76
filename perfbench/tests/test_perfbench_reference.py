"""The plain reference against the program at smoke sizes on the CPU, both
in float32: the loss, every leaf's gradient, the prefill's logits and each
decode step's logits through the program's grown caches (the program's
CPU path: the kernels' plain versions). The reference imports nothing of
the program; these tests do, to hold it to the program."""

import dataclasses

import pytest
import torch

from perfbench.reference.lm import Model, Products
from perfbench.reference.serve import served_logits
from perfbench.sizes import Sizes
from perfbench.weights import make_params, named_leaves

SMOKE = {
    "zamba2-2.7b": dict(num_layers=12, d_model=64, d_ff=128, vocab_size=512,
                        num_heads=4, num_kv_heads=4, head_dim=16,
                        ssm_head_dim=16, ssm_state=16, ssm_chunk=32,
                        decode_hot_len=16),
    "mamba2-130m": dict(num_layers=4, d_model=64, vocab_size=512,
                        ssm_head_dim=16, ssm_state=16, ssm_chunk=32,
                        decode_hot_len=16),
    "granite-moe-3b-a800m": dict(num_layers=2, d_model=64, vocab_size=512,
                                 num_heads=4, num_kv_heads=2, head_dim=16,
                                 num_experts=4, num_experts_per_token=2,
                                 moe_d_ff=64, moe_pad_experts_to=6,
                                 moe_group_size=16, decode_hot_len=16),
}
FP32 = 2e-5


def smoke(arch):
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch), **SMOKE[arch],
                              compute_dtype="float32")
    port = dataclasses.asdict(cfg)
    return cfg, Sizes.of(port)


def rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.parametrize("arch", sorted(SMOKE))
def test_loss_and_gradients_match_the_program(arch):
    from repro_torch.models import lm

    cfg, sizes = smoke(arch)
    params = make_params(sizes, 7, "cpu", torch.float32)
    gen = torch.Generator().manual_seed(3)
    labels = torch.randint(0, sizes.vocab, (2, 48), generator=gen)
    inputs = torch.roll(labels, 1, 1)
    inputs[:, 0] = 0
    prog = {k: v.clone().requires_grad_() for k, v in named_leaves(params)}
    tree = {}
    for path, x in prog.items():
        node = tree
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = x
    loss, metrics = lm.train_loss(cfg, tree, {"inputs": inputs.int(),
                                              "labels": labels.int()})
    loss.backward()

    ref = {k: v.clone().requires_grad_() for k, v in named_leaves(params)}
    rtree = {}
    for path, x in ref.items():
        node = rtree
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = x
    ce, aux = Model(sizes, rtree).loss(inputs, labels)
    total = ce + 0.01 * aux if sizes.is_moe else ce
    total.backward()
    assert abs(float(metrics["loss"]) - float(ce.detach())) < FP32 * float(
        ce.detach())
    if sizes.is_moe:
        aux = float(aux.detach())
        assert abs(float(metrics["moe_aux"]) - aux) < FP32 * aux
    for name in prog:
        assert rel(prog[name].grad, ref[name].grad) < 1e-4, name


@pytest.mark.parametrize("arch", sorted(SMOKE))
def test_served_logits_match_the_program(arch):
    from repro_torch.models import lm

    cfg, sizes = smoke(arch)
    params = make_params(sizes, 11, "cpu", torch.float32)
    gen = torch.Generator().manual_seed(5)
    prompts = torch.randint(0, sizes.vocab, (4, 40), generator=gen,
                            dtype=torch.int32)
    gen_len = 6
    with torch.no_grad():
        logits, caches, pos = lm.prefill(cfg, params, prompts)
        caches = lm.grow_caches(cfg, caches, 40 + gen_len)
        prog_logits, served = [], []
        for _ in range(gen_len):
            prog_logits.append(logits[:, :sizes.vocab])
            tok = logits[:, :sizes.vocab].argmax(-1).to(torch.int32)
            served.append(tok)
            logits, caches, pos = lm.decode_step(cfg, params, tok[:, None],
                                                 pos, caches)
    served = torch.stack(served, 1)
    ref = list(served_logits(Model(sizes, params), prompts, served))
    assert len(ref) == gen_len
    for got, want in zip(prog_logits, ref):
        assert rel(got, want) < 1e-4


def test_fp8_products_move_the_logits():
    """The control's float8 products are a different computation."""
    _, sizes = smoke("zamba2-2.7b")
    params = make_params(sizes, 1, "cpu", torch.float32)
    prompts = torch.randint(0, sizes.vocab, (2, 24), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(2))
    served = torch.zeros((2, 1), dtype=torch.int32)
    exact = next(served_logits(Model(sizes, params), prompts, served))
    low = next(served_logits(Model(sizes, params, Products(fp8=True)),
                             prompts, served))
    assert rel(low, exact) > 1e-3
