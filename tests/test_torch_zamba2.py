"""zamba2-7b and the ``zamba_hybrid`` kind on the CPU, in float32.

The program against the benchmark's plain reference
(``perfbench/reference/zamba2.py``, which imports nothing of the
program) at a smoke size with two groups, two shared blocks and four
applications, non-zero adapters and projections: the loss, every leaf's
gradient (both shared blocks included), the prefill's logits and each
decode step's logits through the grown caches. The reference against the
published modelling code (``transformers``' ``Zamba2ForCausalLM``, where
it imports). Beside them: the flash plain path at head dim 224 with a
softmax scale, the grouped gated norm (at G 1 the old norm exactly), the
flop model against a hand count, the registered config, both drivers,
the ``shared_block`` phase spans, and the sharded plan and the dry run
refusing the kind."""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from perfbench.reference import zamba2 as ref  # noqa: E402
from perfbench.sizes import Sizes  # noqa: E402
from perfbench.weights import named_leaves  # noqa: E402
from repro_torch.configs import (HybridConfig, ShapeConfig,  # noqa: E402
                                 get_config, smoke_config)
from repro_torch.core.telemetry import phases  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

ARCH = "zamba2-7b"
# float32 on both sides: the program's plain kernels (the SSD's chunked
# scan, attention by full softmax) and the reference's own chunked forms
# differ only in the order of their float32 sums, a few ulp each, which
# 24 layers and the backward grow to some 1e-5 of a leaf's gradient
FP32 = 1e-4


def smoke(**over):
    """The smoke config at 24 layers (four applications of two blocks),
    float32, and its benchmark sizes."""
    over = {"num_layers": 24, **over}
    cfg = dataclasses.replace(smoke_config(ARCH), compute_dtype="float32",
                              **over)
    port = dataclasses.asdict(cfg)
    return cfg, Sizes.of(port), ref.Hybrid.of(port)


def rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def tokens(cfg, n, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (2, n), generator=gen)


def test_smoke_config_has_what_the_comparison_needs():
    cfg, s, z = smoke()
    assert cfg.hybrid_applications == 4 and cfg.shared_blocks == 2
    assert cfg.ssm_groups == 2 and cfg.ssm_heads % 2 == 0
    assert z.adapter_rank > 0


def test_loss_and_every_gradient_match_the_reference():
    cfg, s, z = smoke()
    tree = ref.make_params(s, z, 20260, "cpu", torch.float32)
    assert float(tree["slots"]["slot5"]["proj"].norm()) > 0
    assert float(tree["slots"]["slot5"]["adapter_b"].norm()) > 0
    prog = lm.tree_map(lambda x: x.clone().requires_grad_(), tree)
    mine = lm.tree_map(lambda x: x.clone().requires_grad_(), tree)
    inputs, labels = tokens(cfg, 40), tokens(cfg, 40, seed=2)
    loss, _ = lm.train_loss(cfg, prog, {"inputs": inputs, "labels": labels})
    loss.backward()
    with ref.exact_fp32():
        want = ref.Model(s, z, mine).loss(inputs, labels)
    want.backward()
    assert abs(float(loss.detach()) - float(want.detach())) <= \
        FP32 * abs(float(want.detach()))
    names = []
    for (name, a), (_, b) in zip(named_leaves(prog), named_leaves(mine)):
        names.append(name)
        assert float(b.grad.norm()) > 0, name
        assert rel(a.grad, b.grad) <= FP32, name
    # both shared blocks' leaves are among them, each applied twice
    assert "shared_blocks/attn/wq" in names
    assert tree["shared_blocks"]["attn"]["wq"].shape[0] == 2
    for b in range(2):
        g = prog["shared_blocks"]["mlp"]["w_down"].grad[b]
        assert float(g.norm()) > 0


def test_prefill_and_decode_logits_match_the_reference():
    """The prefill's last logits and each decode step's, the caches grown
    past the prompt and the hot ring's 16 slots filled (the ring then
    overwrites its oldest entries, as the JAX package's does), against
    the reference's full forward at every position."""
    cfg, s, z = smoke()
    tree = ref.make_params(s, z, 4242, "cpu", torch.float32)
    toks = tokens(cfg, 30 + cfg.decode_hot_len)
    prompt = 30
    with torch.no_grad(), ref.exact_fp32():
        want = ref.Model(s, z, tree).logits(toks)[..., :cfg.vocab_size]
        logits, caches, pos = lm.prefill(cfg, tree, toks[:, :prompt])
        assert rel(logits[:, :cfg.vocab_size], want[:, prompt - 1]) <= FP32
        caches = lm.grow_caches(cfg, caches, toks.shape[1])
        slot = caches["slot5"]
        assert slot["k"].shape[2] == toks.shape[1]
        assert {"state", "conv_x", "k", "hk"} <= set(slot)
        for i in range(prompt, toks.shape[1]):
            logits, caches, pos = lm.decode_step(cfg, tree, toks[:, i:i + 1],
                                                 pos, caches)
            assert rel(logits[:, :cfg.vocab_size], want[:, i]) <= FP32, i


def _hf_model(cfg, s, z, tree):
    """A ``Zamba2ForCausalLM`` of the smoke sizes holding ``tree``'s
    weights: norms 1 + w at eps 1e-6 (the mixer's gated norm too), no conv
    bias, an untied head, and dt's clamp below at ``time_step_min`` made
    inert."""
    transformers = pytest.importorskip("transformers")
    blocks = ["mamba"] * 5 + ["hybrid"]
    hf_cfg = transformers.Zamba2Config(
        vocab_size=cfg.vocab_size, hidden_size=cfg.d_model,
        num_hidden_layers=cfg.num_layers,
        layers_block_type=blocks * cfg.repeats,
        mamba_d_state=cfg.ssm_state, mamba_d_conv=cfg.ssm_conv,
        mamba_expand=cfg.ssm_expand, mamba_ngroups=cfg.ssm_groups,
        n_mamba_heads=cfg.ssm_heads, chunk_size=cfg.ssm_chunk,
        intermediate_size=cfg.d_ff, hidden_act="gelu",
        num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_kv_heads,
        num_mem_blocks=cfg.shared_blocks, use_shared_attention_adapter=False,
        adapter_rank=cfg.adapter_rank, use_mem_rope=True,
        rope_theta=cfg.rope_theta, rms_norm_eps=1e-6, time_step_min=1e-30,
        max_position_embeddings=256, tie_word_embeddings=False,
        pad_token_id=0, attn_implementation="eager")
    model = transformers.Zamba2ForCausalLM(hf_cfg).float().eval()
    one = lambda w: 1.0 + w  # noqa: E731

    def mamba(layer, bp):
        sp = bp["ssm"]
        layer.input_layernorm.weight.copy_(one(bp["ln"]))
        mx = layer.mamba
        mx.in_proj.weight.copy_(torch.cat(
            [sp["wz"], sp["wx"], sp["wb"], sp["wc"], sp["wdt"]], 1).T)
        mx.conv1d.weight.copy_(torch.cat(
            [sp["conv_x"], sp["conv_b"], sp["conv_c"]], 1).T[:, None, :])
        mx.conv1d.bias.zero_()
        mx.dt_bias.copy_(sp["dt_bias"])
        mx.A_log.copy_(sp["a_log"])
        mx.D.copy_(sp["d_skip"])
        mx.norm.weight.copy_(one(sp["norm"]))
        mx.norm.variance_epsilon = 1e-6
        mx.out_proj.weight.copy_(sp["wo"].T)

    def row(t, r):
        return {k: row(v, r) if isinstance(v, dict) else v[r]
                for k, v in t.items()}

    with torch.no_grad():
        model.model.embed_tokens.weight.copy_(tree["embed"][:cfg.vocab_size])
        model.model.final_layernorm.weight.copy_(one(tree["final_norm"]))
        model.lm_head.weight.copy_(tree["unembed"][:, :cfg.vocab_size].T)
        app = 0
        for n, layer in enumerate(model.model.layers):
            r, i = divmod(n, len(cfg.pattern))
            bp = row(tree["slots"][f"slot{i}"], r)
            if cfg.pattern[i] == "ssm":
                mamba(layer, bp)
                continue
            mamba(layer.mamba_decoder, bp)
            layer.linear.weight.copy_(bp["proj"].T)
            blk = layer.shared_transformer
            sb = row(tree["shared_blocks"], blk.block_id)
            assert blk.block_id == app % cfg.shared_blocks
            blk.input_layernorm.weight.copy_(one(sb["ln_in"]))
            blk.pre_ff_layernorm.weight.copy_(one(sb["ln_ff"]))
            at = blk.self_attn
            for name in ("wq", "wk", "wv", "wo"):
                getattr(at, f"{name[1]}_proj").weight.copy_(
                    sb["attn"][name].T)
            ff = blk.feed_forward
            ff.gate_up_proj.weight.copy_(torch.cat(
                [sb["mlp"]["w_gate"], sb["mlp"]["w_up"]], 1).T)
            ff.down_proj.weight.copy_(sb["mlp"]["w_down"].T)
            adapter = ff.gate_up_proj_adapter_list[app]
            adapter[0].weight.copy_(bp["adapter_a"].T)
            adapter[1].weight.copy_(bp["adapter_b"].T)
            app += 1
    return model


def test_reference_matches_the_published_modelling_code():
    """The reference's logits against ``transformers``' plain
    ``torch_forward`` path on the same weights, both float32: G 2, two
    blocks applied alternately, per-application adapters, head dim
    2M / H (the published rule), RoPE on every dim, scale (D/2)^-1/2.
    The sequence is two whole chunks of the scan: on a ragged last chunk
    the published plain path, which pads it, departs from the step-by-step
    recurrence by some 1e-3 of the logits, where the reference (and the
    program) keep to it."""
    cfg, s, z = smoke(head_dim=32)   # 2 x 64 / 4 heads
    tree = ref.make_params(s, z, 777, "cpu", torch.float32)
    model = _hf_model(cfg, s, z, tree)
    toks = tokens(cfg, 2 * cfg.ssm_chunk)
    with torch.no_grad(), ref.exact_fp32():
        want = model(input_ids=toks.long(), use_cache=False).logits
        got = ref.Model(s, z, tree).logits(toks)[..., :cfg.vocab_size]
    assert rel(got, want) <= FP32


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_path_at_head_dim_224_with_a_scale(causal):
    """ops.attention's CPU path (the kernels' plain version) at D 224 with
    Zamba-2's scale (D/2)^-1/2, and its backward algebra, against an
    explicit softmax and autograd through it."""
    gen = torch.Generator().manual_seed(3)
    b, s, h, d = 2, 24, 4, 224
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen)
                   for _ in range(4))
    scale = (d / 2) ** -0.5
    qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
    sc = torch.einsum("bshd,bthd->bhst", qs, ks) * scale
    if causal:
        sc = sc.masked_fill(torch.ones(s, s, dtype=torch.bool).triu(1),
                            float("-inf"))
    want = torch.einsum("bhst,bthd->bshd", sc.softmax(-1), vs)
    want.backward(do)
    got = flash_ops.attention(q, k, v, causal=causal, scale=scale)
    assert rel(got, want.detach()) <= 1e-5
    default = flash_ops.attention(q, k, v, causal=causal)
    assert rel(default, got) > 1e-2      # the scale reached the softmax
    o, lse = flash_ref.attention_reference_lse(q, k, v, causal=causal,
                                               scale=scale)
    grads = flash_ref.attention_backward_reference(q, k, v, o, lse, do,
                                                   causal=causal, scale=scale)
    for g, x in zip(grads, (qs, ks, vs)):
        assert rel(g, x.grad) <= 1e-5
    from repro_torch.kernels.flash_attention.kernel import (
        BWD_HEAD_DIMS, FWD_HEAD_DIMS, check_inputs)
    assert 224 in FWD_HEAD_DIMS and 224 in BWD_HEAD_DIMS
    with pytest.raises(ValueError, match="scale"):   # bf16: the kernels'
        check_inputs(*(x.bfloat16() for x in (q, k, v)), causal, None, None,
                     scale=0.0)


def test_grouped_gated_norm():
    """At G 1 the gated norm is the old one, bit for bit (the same ops);
    at G 2 each half of d_inner is normalised on its own."""
    cfg1 = smoke_config("mamba2-130m")
    gen = torch.Generator().manual_seed(5)
    d = cfg1.ssm_d_inner
    y, z, w = (torch.randn((2, 7, d), generator=gen) for _ in range(3))
    w = w[0, 0]
    for dtype in (torch.float32, torch.bfloat16):
        yd, zd = y.to(dtype), z.to(dtype)
        old = tssm.rms_norm(yd * tssm._silu(zd), w)
        assert torch.equal(tssm.gated_norm(cfg1, yd, zd, w), old)
    cfg2 = dataclasses.replace(cfg1, ssm_groups=2)
    got = tssm.gated_norm(cfg2, y, z, w)
    x = y * torch.sigmoid(z) * z
    half = d // 2
    parts = [x[..., :half], x[..., half:]]
    want = torch.cat([p * torch.rsqrt(p.square().mean(-1, keepdim=True)
                                      + 1e-6) for p in parts], -1) * (1 + w)
    assert rel(got, want) <= 1e-6
    assert rel(got, tssm.gated_norm(cfg1, y, z, w)) > 1e-3


def test_flop_model_and_parameter_count_by_hand():
    """n_params, the flop model TALP reads (6 N tokens) and the
    benchmark's count at the smoke size, each against a count by hand."""
    cfg, s, z = smoke()
    m, v, f, r, a = cfg.d_model, cfg.padded_vocab, cfg.d_ff, 8, 128
    hd = cfg.num_heads * cfg.resolved_head_dim
    d_in, gn, nh = 128, 2 * 16, 8
    mamba = 2 * m * d_in + 2 * m * gn + m * nh + d_in * m + 2 * m
    shared = a * hd * 3 + hd * m + 3 * m * f + a + m
    own = m * m + r * m + r * 2 * f
    assert cfg.shared_block_params() == shared
    assert cfg.n_params() == 2 * v * m + 24 * mamba + 4 * own + 2 * shared
    n_flops = v * m + 24 * mamba + 4 * own + 4 * shared
    assert cfg.n_flops_params() == n_flops
    shape = ShapeConfig("t", 64, 2, "train")
    assert tsteps.model_flops(cfg, shape) == 6.0 * n_flops * 2 * 64
    # the benchmark's count: weight products, attention and the scan
    mf = ref.ModelFlops(z)
    products = 24 * (mamba - 2 * m) + 4 * (own + shared - a - m) + m * v
    assert mf.body_params(s) + m * v == products
    step = mf.train_step(s, 2, 64)
    assert step > 6.0 * products * 128
    # the full model: published widths, 13 applications of 334.0 M
    full = get_config(ARCH)
    assert full.hybrid_applications == 13
    assert round(full.shared_block_params() / 1e6, 1) == 334.0
    assert round(dataclasses.replace(full, num_layers=24).n_params() / 1e9,
                 2) == 2.85


def test_registered_config_is_at_the_published_widths():
    cfg = get_config(ARCH)
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff) == (3584, 32, 32, 224, 14336)
    assert isinstance(cfg, HybridConfig)
    assert (cfg.shared_blocks, cfg.adapter_rank) == (2, 128)
    # the attention reads the 7168-wide concatenation [x ; e]
    shapes = lm.param_shapes(cfg)["shared_blocks"]
    assert shapes["ln_in"] == (2, 7168)
    assert shapes["attn"]["wq"] == (2, 7168, 32 * 224)
    assert (cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_chunk,
            cfg.ssm_conv) == (112, 2, 64, 256, 4)
    assert cfg.pattern == ("ssm",) * 5 + ("zamba_hybrid",)
    assert cfg.num_layers == 78 and cfg.vocab_size == 32000
    from repro_torch.launch.train import check_trainable_on_card
    check_trainable_on_card(cfg)        # D 224 trains on the card


def test_both_drivers_run_it_with_shared_block_spans():
    """launch.train's step (make_train_step) and launch.serve's prefill and
    decode at the smoke size on the CPU; one train step under a recorder
    holds a shared_block span per application in the forward and again
    in the backward (remat's recompute), nested under each."""
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import train
    from repro_torch.optim.adamw import AdamWConfig

    cfg = smoke_config(ARCH)
    state, history, _ = train(cfg, steps=2, global_batch=2, seq_len=32,
                              device="cpu", verbose=False)
    assert len(history) == 2 and all(h["loss"] > 0 for h in history)
    out, _ = serve(cfg, requests=2, prompt_len=16, gen_len=4, device="cpu",
                   verbose=False)
    assert out.shape == (2, 4)

    saved = phases.current()
    rec = phases.PhaseRecorder()
    phases.install(rec)
    try:
        st = tsteps.init_train_state(cfg, torch.Generator().manual_seed(0))
        step = tsteps.make_train_step(cfg, AdamWConfig())
        toks = tokens(cfg, 32)
        step(st, {"inputs": toks, "labels": toks})
    finally:
        phases.install(saved)
    spans = rec.spans()
    by_seq = {sp.seq: sp for sp in spans}
    shared = [sp for sp in spans if sp.name == "shared_block"]
    assert len(shared) == 2 * cfg.hybrid_applications
    parents = [by_seq[sp.parent].name for sp in shared]
    assert parents.count("forward") == parents.count("backward") \
        == cfg.hybrid_applications


def test_sharded_plan_and_dry_run_refuse_the_kind():
    from repro_torch.launch import dryrun
    from repro_torch.sharding import partition

    cfg = smoke_config(ARCH)
    mesh = partition.AbstractMesh((2, 2), ("data", "model"))
    params = lm.init_params(cfg, None, device="meta")
    with pytest.raises(NotImplementedError, match="zamba_hybrid"):
        partition.make_sharding_tree(params, mesh, cfg,
                                     partition.param_pspec)
    with pytest.raises(NotImplementedError, match="zamba_hybrid"):
        partition.state_shardings(tsteps.train_state_shapes(cfg), mesh, cfg)
    with pytest.raises(NotImplementedError, match="zamba_hybrid"):
        dryrun.run_cell(ARCH, "train_4k", device="cpu", verbose=False)
