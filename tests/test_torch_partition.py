"""The port's partition plan against the JAX package's, with no devices
and no memory: for the ten registered configs, the specs of every
parameter, train-state, decode-cache and batch leaf that
repro_torch.sharding.partition gives on abstract meshes equal those of
repro.sharding.partition on JAX abstract meshes of the same shapes (the
port's trees on the meta device, the JAX ones from jax.eval_shape). Also
``placements`` on every mesh shape, the mesh helpers and
``lm.init_decode_caches`` against the JAX one."""

import functools

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import torch  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec as P  # noqa: E402

import repro.sharding.partition as jpart  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import ALL_ARCHS, get_config, smoke_config  # noqa: E402
from repro.configs import list_configs as jax_list_configs  # noqa: E402

# the archs both packages register: the JAX specs are the yardstick
# (zamba2-7b, the port's alone, is refused by the plan: test_torch_zamba2.py)
JAX_ARCHS = [a for a in ALL_ARCHS if a in jax_list_configs()]
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.steps import train_state_shapes  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.sharding import partition as tpart  # noqa: E402

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model")),
          ((2, 2), ("data", "model")),
          ((1, 1), ("data", "model"))]
# (batch, cache length): a batch the FSDP axes divide and one they do not
# (the caches' sequence-sharding fallbacks)
CACHES = [(32, 4096), (1, 4096)]
BATCHES = [1, 8, 32, 512]


def _jax_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {"/".join(str(getattr(k, "key", k)) for k in path): spec
            for path, spec in flat}


def _port_flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


@functools.lru_cache(maxsize=None)
def _jax_trees(arch):
    cfg = jax_get_config(arch)
    key = jax.random.PRNGKey(0)
    params = jax.eval_shape(lambda: jlm.init_params(cfg, key))
    state = jsteps.train_state_shapes(cfg)
    caches = {c: jax.eval_shape(
        lambda c=c: jlm.init_decode_caches(cfg, *c, filled=True))
        for c in CACHES}
    return cfg, params, state, caches


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_specs_equal_jax_on_every_mesh(arch, monkeypatch):
    """Parameters (param_pspec), the train state (state_shardings), the
    decode caches of two batch sizes (cache_pspec) and batches
    (batch_pspec) on the five meshes: the same specs leaf for leaf, the
    same leaves, and each spec's placements a valid layout of its mesh."""
    # the JAX trees' NamedShardings, read back as their specs
    monkeypatch.setattr(jpart, "NamedSharding", lambda mesh, spec: spec)
    jcfg, jparams, jstate, jcaches = _jax_trees(arch)
    cfg = get_config(arch)
    params = tlm.init_params(cfg, None, device="meta")
    state = train_state_shapes(cfg)
    caches = {c: tlm.init_decode_caches(cfg, *c, filled=True, device="meta")
              for c in CACHES}
    n_sharded = 0
    for shape, axes in MESHES:
        jm, tm = AbstractMesh(shape, axes), tpart.AbstractMesh(shape, axes)
        pairs = [
            (jpart.make_sharding_tree(jparams, jm, jcfg, jpart.param_pspec),
             tpart.make_sharding_tree(params, tm, cfg, tpart.param_pspec)),
            (jpart.state_shardings(jstate, jm, jcfg),
             tpart.state_shardings(state, tm, cfg)),
        ] + [
            (jpart.make_sharding_tree(jcaches[c], jm, jcfg,
                                      jpart.cache_pspec),
             tpart.make_sharding_tree(caches[c], tm, cfg, tpart.cache_pspec))
            for c in CACHES]
        for jtree, ttree in pairs:
            want, got = _jax_flat(jtree), _port_flat(ttree)
            assert sorted(want) == sorted(got), (shape, arch)
            for name, spec in got.items():
                assert P(*spec) == want[name], (shape, name, spec, want[name])
                pl = tpart.placements(spec, tm)
                assert len(pl) == len(shape)
                n_sharded += any(p.is_shard() for p in pl)
        for b in BATCHES:
            for ndim in (2, 3):
                got = tpart.batch_pspec(tm, b, ndim)
                assert P(*got) == jpart.batch_pspec(jm, b, ndim), (shape, b)
    assert n_sharded > 0


@pytest.mark.parametrize("shape,axes", MESHES,
                         ids=[tmesh.describe_mesh(tpart.AbstractMesh(*m))
                              for m in MESHES])
def test_placements_on_each_mesh(shape, axes):
    """A dim named by one axis is Shard(dim) on that mesh dim; a dim over
    the FSDP super-axis is Shard(dim) on each of its axes; every other mesh
    dim is Replicate(). An unknown axis, an axis named twice or a tuple
    against the mesh's order raises. describe_mesh writes the mesh as the
    JAX package does."""
    from torch.distributed.tensor import Replicate, Shard

    m = tpart.AbstractMesh(shape, axes)
    assert tmesh.describe_mesh(m) == jmesh.describe_mesh(
        AbstractMesh(shape, axes))
    fsdp = tpart.fsdp_axes(m)
    assert fsdp == tuple(a for a in axes if a != "model")
    want = tuple(Shard(0) if a in fsdp else Shard(1) for a in axes)
    assert tpart.placements((fsdp, "model"), m) == want
    assert tpart.placements((None, None, "model"), m) == tuple(
        Shard(2) if a == "model" else Replicate() for a in axes)
    assert tpart.placements((None,), m) == (Replicate(),) * len(axes)
    for bad in ((("model", "data"),), ("data", "data"), ("expert",)):
        with pytest.raises(ValueError):
            tpart.placements(bad, m)


def test_production_mesh_needs_its_ranks():
    """make_production_mesh raises without the 256 (512) ranks it needs,
    as the JAX one does without the devices; its shape and axes are the
    JAX package's, and make_mesh raises likewise for a mesh of another
    size than the process group."""
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"need {n} devices"):
            tmesh.make_production_mesh(multi_pod=multi_pod)
        shape, axes = tmesh.production_shape(multi_pod)
        assert (np.prod(shape), len(axes)) == (n, len(shape))
    with pytest.raises(RuntimeError, match="need 8 devices"):
        tmesh.make_mesh((2, 4), ("data", "model"), "cpu")


@pytest.mark.parametrize("arch", JAX_ARCHS)
@pytest.mark.parametrize("filled", [False, True])
def test_init_decode_caches_equals_jax(arch, filled):
    """The smoke config's stacked decode caches: the JAX tree's keys,
    shapes, dtypes and values (zeros, -1 or the filled positions)."""
    jcfg, cfg = jax_smoke_config(arch), smoke_config(arch)
    want = _port_flat(jax.tree.map(np.asarray, jlm.init_decode_caches(
        jcfg, 2, 24, filled=filled)))
    got = _port_flat(tlm.init_decode_caches(cfg, 2, 24, filled=filled))
    assert sorted(want) == sorted(got)
    for name, w in want.items():
        g = got[name]
        assert str(g.dtype).split(".")[-1] == str(w.dtype), name
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32), err_msg=name)
