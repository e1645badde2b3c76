"""The port's sharded steps on DeviceMesh and DTensor, in ``gloo`` CPU
processes, one rank a process: the counterparts of
tests/test_distribution.py's sharded train step (2x4 mesh), elastic
restore (saved on 8 ranks, restored on 4) and sharded zamba2 decode step
(2x2 mesh), each held to the unsharded step on the same values, and the
kernel ops' local maps. Each rank is a subprocess with a timeout; a rank
that fails or hangs fails the test with every rank's output."""

import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

from mp_harness import REPO_ROOT, fleet_env, free_port  # noqa: E402

# What every rank runs first: one CPU thread (the ranks share the
# machine), the process group, and the helpers the checks use.
_PRELUDE = """
import copy, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD, PORT = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{PORT}",
                        world_size=WORLD, rank=RANK)
from repro_torch.configs import smoke_config
from repro_torch.launch.mesh import describe_mesh, make_mesh
from repro_torch.models import lm
from repro_torch.sharding.partition import (
    batch_pspec, cache_pspec, distribute_tree, make_sharding_tree,
    param_pspec, placements, state_shardings)


def full(tree):
    return lm.tree_map(
        lambda x: x.full_tensor() if hasattr(x, "full_tensor") else x, tree)


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def rel_errs(got, want):
    # each leaf's ||got - want|| over its own ||want||
    got = dict(leaves(got))
    return {name: ((got[name].float() - w.float()).norm()
                   / w.float().norm().clamp_min(1e-30)).item()
            for name, w in leaves(want)}


def hold_leaves(got, want, tol, what):
    # every leaf of `got` within `tol` of `want`'s relative to its own
    # norm, so a small leaf (a_log, d_skip, a norm's scale) is held as
    # closely as a large one
    errs = rel_errs(got, want)
    bad = {n: e for n, e in errs.items() if not e <= tol}
    assert not bad, (what, tol, bad)
    return max(errs.values())


def hold_adamw_step(p0, params, mu, nu, lr):
    # the parameters after a first AdamW step are p0 moved by the run's
    # own moments (AdamWConfig's defaults, bias corrections at count 1, in
    # adamw_update's ops): every shard updated, the update 3e-6 against
    # a tolerance of 2 ulps
    from repro_torch.optim.adamw import AdamWConfig
    c = AdamWConfig()
    b1c, b2c = (float(1.0 - torch.tensor(b, dtype=torch.float32))
                for b in (c.b1, c.b2))
    mu, nu, params = (dict(leaves(t)) for t in (mu, nu, params))
    for name, p in leaves(p0):
        denom = torch.div(nu[name], b2c).sqrt_().add_(c.eps)
        step = torch.div(mu[name], b1c).div_(denom).add_(
            p, alpha=c.weight_decay)
        torch.testing.assert_close(params[name],
                                   torch.sub(p, step, alpha=lr),
                                   rtol=2.5e-7, atol=1e-9, msg=name)
"""


def _run_ranks(body: str, n: int, *extra, timeout: float = 180.0) -> list:
    """Run ``_PRELUDE + body`` as ranks 0..n-1 of one ``gloo`` group, one
    subprocess each; all must exit 0 within ``timeout`` seconds (every rank
    still running then is killed). Returns their stdouts."""
    code = _PRELUDE + textwrap.dedent(body)
    port = free_port()
    env = fleet_env()
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(n), str(port), *extra],
        env=env, cwd=REPO_ROOT, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for r in range(n)]
    outs, failed = [], False
    for r, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, err = p.communicate()
            err = f"killed at the {timeout} s timeout\n{err}"
            failed = True
        failed |= p.returncode != 0
        outs.append((r, p.returncode, out, err))
    assert not failed, "\n".join(
        f"--- rank {r} exit {rc} ---\n{out}\n{err[-4000:]}"
        for r, rc, out, err in outs)
    return [out for _, _, out, _ in outs]


def test_sharded_train_step_matches_the_unsharded_step():
    """llama3.2-3b's smoke config, one AdamW step of 8 x 64 random tokens
    on a 2x4 ("data", "model") mesh: the state placed by state_shardings,
    the batch by batch_pspec, then make_train_step's own step. Against
    the unsharded step from the same state and batch: the loss within 1e-3,
    every parameter after the step at the fp32 _tol, and the parameters
    equal to p0 moved by AdamW from the run's own moments (the first step's
    learning rate is 3e-6, so the parameters alone would pass whatever the
    gradients were). The gradients are held leaf by leaf, each relative to
    its own norm, through the first moments (0.1 times the clipped
    gradient): in fp32 compute under activation_sharding (the residual
    stream's sequence over "model", K and V gathered before attention)
    against the unsharded step's at the fp32 _tol (the gradient norm too);
    in bf16 compute (the config's), where the two steps round in other
    places and differ by about 2% of a leaf, each against the fp32 step's:
    the unsharded one at the bf16 _tol, the sharded one within the
    unsharded one's distance plus 2^-6."""
    out = _run_ranks("""
        import dataclasses
        from repro_torch.launch.steps import init_train_state, make_train_step
        from repro_torch.sharding.act_sharding import activation_sharding

        mesh = make_mesh((2, 4), ("data", "model"), "cpu")
        gen = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, 512, (2, 8, 64), generator=gen)
        batch = {"inputs": tokens[0].to(torch.int32),
                 "labels": tokens[1].to(torch.int32)}
        bspec = {k: batch_pspec(mesh, v.shape[0], v.ndim)
                 for k, v in batch.items()}
        for compute, sp in (("float32", (("data",), "model", None)),
                            ("bfloat16", None)):
            cfg = dataclasses.replace(smoke_config("llama3.2-3b"),
                                      compute_dtype=compute)
            state = init_train_state(cfg, torch.Generator().manual_seed(0))
            step = make_train_step(cfg)
            p0 = copy.deepcopy(state["params"])
            if RANK == 0:   # the unsharded step, on the rank that compares
                ref_state, ref_metrics = step(copy.deepcopy(state), batch)
            specs = state_shardings(state, mesh, cfg)
            sharded = distribute_tree(state, mesh, specs)
            wq = sharded["params"]["slots"]["slot0"]["attn"]["wq"]
            assert tuple(wq.placements) == placements(
                specs["params"]["slots"]["slot0"]["attn"]["wq"], mesh)
            with activation_sharding(sp):
                new, metrics = step(sharded,
                                    distribute_tree(batch, mesh, bspec))
            loss = float(metrics["loss"].full_tensor())
            got_p, got_mu, got_nu = (full(t) for t in (
                new["params"], new["opt"]["mu"], new["opt"]["nu"]))
            if RANK != 0:
                continue
            ref_loss = float(ref_metrics["loss"])
            assert abs(loss - ref_loss) < 1e-3, (compute, sp, loss, ref_loss)
            got = dict(leaves(got_p))
            for name, want in leaves(ref_state["params"]):
                torch.testing.assert_close(got[name], want, rtol=2e-4,
                                           atol=2e-4, msg=name)
            hold_adamw_step(p0, got_p, got_mu, got_nu,
                            float(ref_metrics["lr"]))
            gn, ref_gn = (float(m["grad_norm"]) for m in (metrics,
                                                          ref_metrics))
            ref_mu = ref_state["opt"]["mu"]
            if compute == "float32":
                assert abs(gn - ref_gn) <= 2e-4 * ref_gn, (gn, ref_gn)
                gap = hold_leaves(got_mu, ref_mu, 2e-4, "fp32 mu")
                exact_mu = ref_mu
            else:
                # the two bf16 steps round in other places (the sharded
                # one rounds each rank's partial sums to bf16 before they
                # are reduced over an axis), about 2% of a leaf apart: each
                # is held to the fp32 step's gradient, the unsharded one at
                # the bf16 _tol and the sharded one within its distance
                # plus 2^-6 (four bf16 roundings of 2^-8), leaf by leaf
                d_un = rel_errs(ref_mu, exact_mu)
                d_sh = rel_errs(got_mu, exact_mu)
                assert max(d_un.values()) <= 2e-2, d_un
                bad = {n: (d_sh[n], d_un[n]) for n in d_un
                       if not d_sh[n] <= d_un[n] + 2.0 ** -6}
                assert not bad, bad
                gap = max(d_sh[n] - d_un[n] for n in d_un)
            print("OK", describe_mesh(mesh), compute, sp, loss, ref_loss,
                  gn, ref_gn, gap)
    """, 8)
    assert out[0].count("OK 2datax4model") == 2, out[0]


def test_elastic_restore_onto_a_smaller_mesh(tmp_path):
    """gemma2-2b's smoke train state, placed on a 2x4 mesh by
    state_shardings and saved by every rank (the files equal an unsharded
    save of the same state byte for byte), then restored by a job of 4
    ranks onto a 2x2 mesh from train_state_shapes: every leaf's values
    identical, and each on the placements state_shardings gives the new
    mesh."""
    d, plain = str(tmp_path / "sharded"), str(tmp_path / "plain")
    _run_ranks("""
        from repro_torch.checkpoint.checkpointer import save_checkpoint
        from repro_torch.launch.steps import init_train_state

        cfg = smoke_config("gemma2-2b")
        state = init_train_state(cfg, torch.Generator().manual_seed(0))
        mesh = make_mesh((2, 4), ("data", "model"), "cpu")
        sharded = distribute_tree(state, mesh,
                                  state_shardings(state, mesh, cfg))
        save_checkpoint(sys.argv[4], 0, sharded)
        if RANK == 0:
            save_checkpoint(sys.argv[5], 0, state)
    """, 8, d, plain)
    files = sorted(os.listdir(os.path.join(plain, "step_0")))
    assert files == sorted(os.listdir(os.path.join(d, "step_0")))
    for name in files:
        with open(os.path.join(plain, "step_0", name), "rb") as f, \
                open(os.path.join(d, "step_0", name), "rb") as g:
            assert f.read() == g.read(), name
    out = _run_ranks("""
        from repro_torch.checkpoint.checkpointer import restore_checkpoint
        from repro_torch.launch.steps import (init_train_state,
                                              train_state_shapes)

        cfg = smoke_config("gemma2-2b")
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        shapes = train_state_shapes(cfg)
        specs = state_shardings(shapes, mesh, cfg)
        layouts = lm.tree_map(
            lambda s: placements(s, mesh) if len(s) else None, specs)
        restored = restore_checkpoint(sys.argv[4], 0, shapes, mesh=mesh,
                                      placements=layouts)
        ref = init_train_state(cfg, torch.Generator().manual_seed(0))
        got = dict(leaves(restored))
        n = 0
        for name, want in leaves(ref):
            leaf = got[name]
            if want.dim():
                assert leaf.device_mesh is mesh, name
                spec = specs
                for key in name.strip("/").split("/"):
                    spec = spec[key]
                assert tuple(leaf.placements) == placements(spec, mesh)
                n += any(p.is_shard() for p in leaf.placements)
                leaf = leaf.full_tensor()
            assert leaf.dtype == want.dtype and torch.equal(leaf, want), name
        if RANK == 0:
            print("OK", describe_mesh(mesh), n, "sharded leaves")
    """, 4, d)
    assert "OK 2datax2model" in out[0], out[0]


def test_sharded_zamba2_decode_and_train_steps():
    """zamba2-2.7b's smoke config (SSD layers and the shared attention
    block, 4 KV heads split over "model") on a 2x2 mesh. The serve step
    (make_serve_step) with parameters placed by param_pspec and caches from
    init_decode_caches(4, 64, filled=True) placed by cache_pspec: logits
    within tests/test_distribution.py's 8e-2 of the unsharded step's, and
    the token written into each hot ring in place. Then one train step of
    4 x 64 random tokens in fp32 compute (the SSD scan's local map, with
    the gradients of a and D, which every batch row shares, and of the one
    group's B and C, which every head shares): the loss within 1e-3 of the
    unsharded step's, the gradient norm and the parameters at the fp32
    _tol, the first moments (the clipped gradients) leaf by leaf, each
    relative to its own norm, at the fp32 _tol, and the parameters equal to
    p0 moved by AdamW from the run's own moments.
    (In this smoke model's bf16 compute the two summation orders alone
    move the loss by about 1e-3.)"""
    out = _run_ranks("""
        import dataclasses
        from repro_torch.launch.steps import (init_train_state,
                                              make_serve_step,
                                              make_train_step)

        cfg = smoke_config("zamba2-2.7b")
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        params = lm.init_params(cfg, torch.Generator().manual_seed(0))
        caches = lm.init_decode_caches(cfg, 4, 64, filled=True)
        tok = torch.zeros((4, 1), dtype=torch.int32)
        pos = torch.full((4,), 64, dtype=torch.int32)
        step = make_serve_step(cfg)
        with torch.no_grad():
            if RANK == 0:
                ref_logits, ref_caches, _ = step(params, tok, pos,
                                                 copy.deepcopy(caches))
            sp = distribute_tree(
                params, mesh, make_sharding_tree(params, mesh, cfg,
                                                 param_pspec))
            sc = distribute_tree(
                caches, mesh, make_sharding_tree(caches, mesh, cfg,
                                                 cache_pspec))
            logits, new_caches, new_pos = step(
                sp, distribute_tree(tok, mesh, batch_pspec(mesh, 4, 2)),
                distribute_tree(pos, mesh, batch_pspec(mesh, 4, 1)), sc)
        logits, got = logits.full_tensor(), dict(leaves(full(new_caches)))
        if RANK == 0:
            torch.testing.assert_close(logits, ref_logits, rtol=8e-2,
                                       atol=8e-2)
        for name, want in leaves(ref_caches if RANK == 0 else {}):
            if name.endswith("h_pos"):
                assert torch.equal(got[name], want), name
                assert (want[:, :, 64 % cfg.decode_hot_len] == 64).all()
            elif not name.endswith(("/k", "/v", "kv_pos")):
                torch.testing.assert_close(got[name].float(), want.float(),
                                           rtol=8e-2, atol=8e-2, msg=name)

        cfg = dataclasses.replace(cfg, compute_dtype="float32")
        state = init_train_state(cfg, torch.Generator().manual_seed(0))
        tokens = torch.randint(0, cfg.vocab_size, (2, 4, 64),
                               generator=torch.Generator().manual_seed(1))
        batch = {"inputs": tokens[0].to(torch.int32),
                 "labels": tokens[1].to(torch.int32)}
        train = make_train_step(cfg)
        p0 = copy.deepcopy(state["params"])
        if RANK == 0:
            ref_state, ref_m = train(copy.deepcopy(state), batch)
        new, m = train(
            distribute_tree(state, mesh, state_shardings(state, mesh, cfg)),
            distribute_tree(batch, mesh, {k: batch_pspec(mesh, 4, 2)
                                          for k in batch}))
        loss = float(m["loss"].full_tensor())
        got_p, got_mu, got_nu = (full(t) for t in (
            new["params"], new["opt"]["mu"], new["opt"]["nu"]))
        got = dict(leaves(got_p))
        if RANK == 0:
            assert abs(loss - float(ref_m["loss"])) < 1e-3
            gn, ref_gn = float(m["grad_norm"]), float(ref_m["grad_norm"])
            assert abs(gn - ref_gn) <= 2e-4 * ref_gn, (gn, ref_gn)
            for name, want in leaves(ref_state["params"]):
                torch.testing.assert_close(got[name], want, rtol=2e-4,
                                           atol=2e-4, msg=name)
            hold_leaves(got_mu, ref_state["opt"]["mu"], 2e-4, "mu")
            hold_adamw_step(p0, got_p, got_mu, got_nu, float(ref_m["lr"]))
            print("OK", describe_mesh(mesh), loss)
    """, 4)
    assert "OK 2datax2model" in out[0], out[0]


def test_kernel_ops_take_dtensors_only_through_their_local_maps():
    """On a 2x2 mesh: every kernel entry point (the flash forward and
    backward, FlashAttention, the SSD scan and its backward, SSDScan)
    refuses a DTensor with TypeError; ops.attention and ops.ssd run the
    plain version on each rank's shards only (batch over "data", heads over
    "model": the shapes it sees are recorded), equal to the unsharded
    result. The activation hooks are the identity without a spec or on a
    plain tensor and redistribute a DTensor to the spec's placements, the
    MoE's gathered expert weight included."""
    out = _run_ranks("""
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor
        from repro_torch.kernels.flash_attention import kernel as fk
        from repro_torch.kernels.flash_attention import ops as fops
        from repro_torch.kernels.flash_attention import ref as fref
        from repro_torch.kernels.ssd import kernel as sk
        from repro_torch.kernels.ssd import ops as sops
        from repro_torch.kernels.ssd import ref as sref
        from repro_torch.models import moe
        from repro_torch.sharding import act_sharding as act

        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        gen = torch.Generator().manual_seed(0)
        rnd = lambda *s: torch.randn(s, generator=gen)
        rep = lambda t: distribute_tensor(t, mesh, [Replicate(), Replicate()])
        q, k, v = rnd(2, 32, 4, 16), rnd(2, 32, 2, 16), rnd(2, 32, 2, 16)
        dq, dk, dv = map(rep, (q, k, v))
        for call in (lambda: fk.flash_attention(dq, dk, dv),
                     lambda: fk.flash_attention_backward(
                         dq, dk, dv, dq, rep(torch.zeros(2, 4, 32)), dq),
                     lambda: fk.FlashAttention.apply(dq, dk, dv, True, None,
                                                     None)):
            try:
                call()
            except TypeError as e:
                assert "DTensor" in str(e), e
            else:
                raise AssertionError("a flash kernel took a DTensor")
        x, dt = rnd(2, 64, 4, 16), torch.rand(2, 64, 4)
        a, bm, cm, d = -torch.rand(4), rnd(2, 64, 1, 16), rnd(2, 64, 1, 16), rnd(4)
        ds = [rep(t) for t in (x, dt, a, bm, cm, d)]
        for call in (lambda: sk.ssd_scan(*ds[:5], chunk=32, d_skip=ds[5]),
                     lambda: sk.ssd_scan_backward(*ds[:5], ds[0], 32, ds[5]),
                     lambda: sk.SSDScan.apply(*ds[:5], 32, ds[5], None,
                                              False)):
            try:
                call()
            except TypeError as e:
                assert "DTensor" in str(e), e
            else:
                raise AssertionError("an SSD kernel took a DTensor")

        seen = []
        plain_attn, plain_ssd = fref.attention_reference, sref.ssd_reference
        def attn_spy(q_, *args, **kw):
            seen.append(("attn", tuple(q_.shape)))
            return plain_attn(q_, *args, **kw)
        def ssd_spy(x_, *args, **kw):
            seen.append(("ssd", tuple(x_.shape)))
            return plain_ssd(x_, *args, **kw)
        fops._ref.attention_reference = attn_spy
        sops._ref.ssd_reference = ssd_spy
        got = fops.attention(dq, dk, dv, window=8, softcap=30.0)
        assert tuple(got.placements) == (Shard(0), Shard(2))
        torch.testing.assert_close(got.full_tensor(), plain_attn(
            q, k, v, window=8, softcap=30.0))
        y, s = sops.ssd(*ds[:5], chunk=32, d_skip=ds[5],
                        return_final_state=True)
        want_y, want_s = plain_ssd(x, dt, a, bm, cm, chunk=32, d_skip=d,
                                   return_final_state=True)
        torch.testing.assert_close(y.full_tensor(), want_y)
        torch.testing.assert_close(s.full_tensor(), want_s)
        assert seen == [("attn", (1, 32, 2, 16)), ("ssd", (1, 64, 2, 16))]

        h = rep(rnd(2, 32, 8))
        assert act.constrain(h) is h and act.constrain(q) is q
        with act.activation_sharding((("data",), "model", None)):
            assert tuple(act.constrain(h).placements) == (Shard(0), Shard(1))
            assert tuple(act.constrain_seq_gathered(h).placements) == (
                Shard(0), Replicate())
            assert act.constrain(q) is q
        w = rep(rnd(4, 8, 16))
        assert tuple(moe._gathered_weight(w, torch.bfloat16, "gate")
                     .placements) == (Replicate(), Replicate())
        with act.moe_weight_sharding(("model", None, None), (None, "model",
                                                             None)):
            assert tuple(moe._gathered_weight(w, torch.bfloat16, "up")
                         .placements) == (Replicate(), Shard(0))
            assert tuple(moe._gathered_weight(w, torch.bfloat16, "down")
                         .placements) == (Replicate(), Shard(1))
        if RANK == 0:
            print("OK", seen)
    """, 4)
    assert "OK" in out[0], out[0]


def test_sharded_moe_train_step_matches_the_unsharded_step():
    """granite-moe-3b-a800m's smoke config (top-2 of 4 experts, the expert
    weights expert-parallel over "model" by param_pspec) on a 2x2 mesh, one
    train step of 4 x 64 random tokens in fp32 compute, under
    moe_weight_sharding (the experts' d_model gathered, the expert dim kept
    over "model"): the loss within 1e-3 of the unsharded step's, the MoE's
    aux loss, the gradient norm and every parameter at the fp32 _tol, the
    first moments (the clipped gradients: the router's and each expert
    weight's) leaf by leaf, each relative to its own norm, at the fp32
    _tol, and the parameters equal to p0 moved by AdamW from the run's own
    moments."""
    out = _run_ranks("""
        import dataclasses
        from repro_torch.launch.steps import init_train_state, make_train_step
        from repro_torch.sharding.act_sharding import moe_weight_sharding

        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        cfg = dataclasses.replace(smoke_config("granite-moe-3b-a800m"),
                                  compute_dtype="float32")
        state = init_train_state(cfg, torch.Generator().manual_seed(0))
        specs = state_shardings(state, mesh, cfg)
        w_up = specs["params"]["slots"]["slot0"]["moe"]["w_up"]
        assert w_up == (None, "model", ("data",), None), w_up
        tokens = torch.randint(0, cfg.vocab_size, (2, 4, 64),
                               generator=torch.Generator().manual_seed(1))
        batch = {"inputs": tokens[0].to(torch.int32),
                 "labels": tokens[1].to(torch.int32)}
        train = make_train_step(cfg)
        p0 = copy.deepcopy(state["params"])
        if RANK == 0:
            ref_state, ref_m = train(copy.deepcopy(state), batch)
        with moe_weight_sharding(("model", None, None),
                                 ("model", None, None)):
            new, m = train(distribute_tree(state, mesh, specs),
                           distribute_tree(batch, mesh,
                                           {k: batch_pspec(mesh, 4, 2)
                                            for k in batch}))
        loss = float(m["loss"].full_tensor())
        aux = float(m["moe_aux"].full_tensor())
        got_p, got_mu, got_nu = (full(t) for t in (
            new["params"], new["opt"]["mu"], new["opt"]["nu"]))
        got = dict(leaves(got_p))
        if RANK == 0:
            assert abs(loss - float(ref_m["loss"])) < 1e-3
            assert abs(aux - float(ref_m["moe_aux"])) <= 2e-4 * abs(aux)
            gn, ref_gn = float(m["grad_norm"]), float(ref_m["grad_norm"])
            assert abs(gn - ref_gn) <= 2e-4 * ref_gn, (gn, ref_gn)
            for name, want in leaves(ref_state["params"]):
                torch.testing.assert_close(got[name], want, rtol=2e-4,
                                           atol=2e-4, msg=name)
            hold_leaves(got_mu, ref_state["opt"]["mu"], 2e-4, "mu")
            hold_adamw_step(p0, got_p, got_mu, got_nu, float(ref_m["lr"]))
            print("OK", describe_mesh(mesh), loss, aux)
    """, 4)
    assert "OK 2datax2model" in out[0], out[0]

