"""The port's sharding rules (``repro_torch.parallel.sharding``) against
the JAX package's (``repro.parallel.sharding``): equal specs, with no
ranks and no devices.

* Every leaf of every registry arch (reduced; ``luna-mlp`` too) on the
  meshes (4, 2), (2, 2), (1, 4), (16, 16) and (2, 16, 16), with
  ``serve_tp`` off and on: the port's spec of a layer's leaf is JAX's spec
  of the stacked leaf with its leading None dropped; an unstacked leaf
  (``embed``, ``dense_blocks/0/...``, the hybrid's ``shared`` block) has
  JAX's spec as it is.
* ``batch_spec`` of every input of every arch, and the cache specs of
  every arch's ``init_cache`` layer by layer against JAX's
  ``cache_shardings`` of the same node stacked on a leading axis.
* Every case of ``tests/test_sharding.py``'s rule tests.

JAX's ``param_shardings`` / ``batch_shardings`` / ``cache_shardings``
wrap each spec in a ``NamedSharding``, which needs a mesh of live
devices; the tests call them with that wrapper replaced by one that
returns the spec, so JAX's own tree walk and rules give the specs.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro.models import registry as jreg
from repro.models.attention import KVCache as JKV
from repro.models.ssm import SSMCache as JSSM
from repro.parallel import sharding as jshd
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import registry as treg
from repro_torch.models.attention import KVCache
from repro_torch.models.ssm import SSMCache
from repro_torch.parallel import sharding as tshd
from repro_torch.tree import leaves_with_path, path_key

ARCHS = list(jreg.ARCH_IDS) + ["luna-mlp"]
MESHES = [((4, 2), ("data", "model")), ((2, 2), ("data", "model")),
          ((1, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
#: the JAX trees' layer stacks (the bridge's ``_STACKS``)
STACKS = ("blocks", "mamba", "enc_blocks", "dec_blocks")


class FakeMesh:
    """What JAX's rules read of a mesh: axis names and a device array's
    shape (``tests/test_sharding.py``'s stand-in)."""

    def __init__(self, shape, names):
        self.axis_names = names

        class _D:
            pass
        self.devices = _D()
        self.devices.shape = shape
        self.devices.size = int(np.prod(shape))


def _meshes(shape, names):
    return FakeMesh(shape, names), AbstractMesh(shape, names)


@pytest.fixture
def spec_only(monkeypatch):
    """JAX's sharding functions, returning bare ``PartitionSpec`` s."""
    monkeypatch.setattr(jshd, "NamedSharding", lambda mesh, spec: spec)
    return jshd


def _cfgs(arch):
    if arch == "luna-mlp":
        return jreg.get_config(arch), treg.get_config(arch)
    return jreg.get_config(arch).reduced(), treg.get_config(arch).reduced()


@functools.lru_cache(maxsize=None)
def _jax_params_shape(arch):
    jcfg, _ = _cfgs(arch)
    model = jreg.get_model(jcfg)
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _port_model(arch):
    _, tcfg = _cfgs(arch)
    return treg.get_model(tcfg, device="cpu")


def _jax_key(path: tuple) -> tuple[str, bool]:
    """The JAX tree's path of a port leaf, and whether JAX stacks it (a
    layer index under one of :data:`STACKS` is dropped)."""
    parts = [str(p) for p in path]
    if parts[0] in STACKS and parts[1].isdigit():
        return "/".join([parts[0]] + parts[2:]), True
    return "/".join(parts), False


def _expected(jspec, stacked: bool) -> tuple:
    spec = tuple(jspec)
    if stacked and spec:
        assert spec[0] is None, spec     # JAX never shards the layer axis
        spec = spec[1:]
    return spec


@pytest.mark.parametrize("mesh_shape,names", MESHES,
                         ids=["x".join(map(str, s)) for s, _ in MESHES])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(arch, mesh_shape, names, spec_only):
    fake, mesh = _meshes(mesh_shape, names)
    jtree = _jax_params_shape(arch)
    port_tree = _port_model(arch).params_tree()
    sharded = 0
    for serve_tp in (False, True):
        jspecs = {jshd._path_str(p): s for p, s in
                  jax.tree_util.tree_flatten_with_path(
                      spec_only.param_shardings(jtree, fake,
                                                serve_tp=serve_tp),
                      is_leaf=lambda x: isinstance(x, P))[0]}
        tspecs = tshd.param_specs(port_tree, mesh, serve_tp=serve_tp)
        seen = set()
        for (path, leaf), (_, spec) in zip(
                leaves_with_path(port_tree),
                _spec_items(tspecs)):
            key, stacked = _jax_key(path)
            seen.add(key)
            assert spec == _expected(jspecs[key], stacked), (
                path_key(path), serve_tp, spec, jspecs[key])
            assert len(spec) in (0, leaf.ndim)
            sharded += any(ax is not None for ax in spec)
        assert seen == set(jspecs), set(jspecs) ^ seen
    assert sharded > 0


def _spec_items(tree, prefix=()):
    """(path, spec) pairs of a spec tree (a spec is a tuple: a leaf)."""
    if isinstance(tree, dict):
        return [i for k, v in tree.items() for i in _spec_items(v, prefix
                                                                + (k,))]
    if isinstance(tree, list):
        return [i for k, v in enumerate(tree)
                for i in _spec_items(v, prefix + (k,))]
    return [(prefix, tree)]


@pytest.mark.parametrize("mesh_shape,names", MESHES,
                         ids=["x".join(map(str, s)) for s, _ in MESHES])
def test_batch_specs_equal_jax(mesh_shape, names, spec_only):
    fake, mesh = _meshes(mesh_shape, names)
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        for b in (1, 2, 8, 32, 64):
            shape = ShapeConfig("t", 64, b, "train")
            tin = treg.input_specs(tcfg, shape)
            jin = jreg.input_specs(jcfg, shape)
            jb = spec_only.batch_shardings(jin, fake)
            tb = tshd.batch_specs({k: s for k, (s, _) in tin.items()}, mesh)
            assert set(tb) == set(jb)
            for k in tb:
                assert tb[k] == tuple(jb[k]), (arch, b, k)
    assert tshd.batch_spec("index", (), mesh) == tuple(
        jshd.batch_spec("index", (), fake)) == ()


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_jax(arch, spec_only):
    """Each layer's cache node (the port's per-layer list) against JAX's
    ``cache_shardings`` of that node stacked on a leading axis of 3."""
    cache = _port_model(arch).init_cache(8, 64)
    for mesh_shape, names in MESHES:
        fake, mesh = _meshes(mesh_shape, names)
        tspecs = tshd.cache_specs(cache, mesh)
        assert len(tspecs) == len(cache)
        for node, spec in zip(cache, tspecs):
            if isinstance(node, KVCache):
                stacked = JKV(*(jax.ShapeDtypeStruct(
                    (3,) + tuple(t.shape), jnp.float32) for t in node))
            else:
                assert isinstance(node, SSMCache)
                stacked = JSSM(*(jax.ShapeDtypeStruct(
                    (3,) + tuple(t.shape), jnp.float32) for t in node))
            jspec = spec_only.cache_shardings(stacked, fake)
            assert type(spec).__name__ == type(jspec).__name__
            for got, want in zip(spec, jspec):
                assert got == _expected(want, True), (arch, mesh_shape)
        # a bare tensor threads through as a batch-sharded leaf
        bare = jax.ShapeDtypeStruct((8, 16, 128), jnp.float32)
        assert tshd.cache_specs([np.zeros((8, 16, 128))], mesh)[0] == \
            tuple(spec_only.cache_shardings([bare], fake)[0])


# the rule cases of tests/test_sharding.py, on its (4, 2) mesh
RULE_CASES = [
    ("blocks/attn/wq", (8, 128, 256)), ("blocks/attn/wo", (8, 256, 128)),
    ("blocks/attn/wq", (8, 127, 256)),
    ("blocks/moe/w_gate", (8, 16, 128, 64)),
    ("blocks/moe/w_down", (8, 16, 64, 128)),
    ("blocks/ln1", (8, 128)), ("ln_f", (128,)),
    ("embed", (64000, 4096)), ("lm_head", (4096, 64000)),
]


@pytest.mark.parametrize("path,shape", RULE_CASES,
                         ids=[f"{p}{s}" for p, s in RULE_CASES])
def test_param_rule_cases_equal_jax(path, shape):
    fake, mesh = _meshes((4, 2), ("data", "model"))
    assert tshd.param_spec(path, shape, mesh) == tuple(
        jshd.param_spec(path, shape, fake))


def test_rule_cases_values():
    """tests/test_sharding.py's expected values, on the port."""
    mesh = AbstractMesh((4, 2), ("data", "model"))
    assert tshd.param_spec("blocks/attn/wq", (8, 128, 256), mesh) == \
        (None, "data", "model")
    assert tshd.param_spec("blocks/attn/wq", (8, 127, 256), mesh) == \
        (None, None, "model")
    assert tshd.param_spec("blocks/moe/w_down", (8, 16, 64, 128), mesh) \
        == (None, "model", None, "data")
    assert tshd.param_spec("blocks/ln1", (8, 128), mesh) == ()
    assert tshd.param_spec("embed", (64000, 4096), mesh) == \
        ("model", "data")


def test_cache_specs_types_equal_jax(spec_only):
    """tests/test_sharding.py's stacked GQA + SSM cache tree."""
    fake, mesh = _meshes((4, 2), ("data", "model"))
    kv = (4, 2, 64, 2, 16)
    conv, state = (4, 2, 3, 128), (4, 2, 8, 16, 16)
    jtree = ([JKV(*(jax.ShapeDtypeStruct(kv, jnp.bfloat16),) * 2)],
             JSSM(jax.ShapeDtypeStruct(conv, jnp.bfloat16),
                  jax.ShapeDtypeStruct(state, jnp.float32)))
    ttree = ([KVCache(np.zeros(kv), np.zeros(kv))],
             SSMCache(np.zeros(conv), np.zeros(state)))
    jsh = spec_only.cache_shardings(jtree, fake)
    tsh = tshd.cache_specs(ttree, mesh)
    assert tsh[0][0].k == tuple(jsh[0][0].k) and tsh[1].conv == tuple(
        jsh[1].conv) and tsh[1].state == tuple(jsh[1].state)
    assert tshd.scalar_spec(mesh) == tuple(jshd.P()) == ()


@pytest.mark.parametrize("arch", ["yi-9b", "deepseek-v2-lite-16b",
                                  "whisper-base", "llava-next-mistral-7b"])
def test_train_specs_equal_jax(arch, spec_only):
    """``train_step.train_specs`` (JAX's ``train_shardings``): the
    params', the AdamW state's (a replicated step, the moments the
    params') and the batch's specs."""
    from repro.configs.base import ShapeConfig as JShape
    from repro.train.train_step import train_shardings
    from repro_torch.train.train_step import train_specs
    fake, mesh = _meshes((4, 2), ("data", "model"))
    jcfg, tcfg = _cfgs(arch)
    _, jp, jopt, _, jb = train_shardings(jreg.get_model(jcfg), jcfg,
                                         JShape("t", 64, 8, "train"), fake)
    tin = treg.input_specs(tcfg, ShapeConfig("t", 64, 8, "train"))
    p, opt, b = train_specs(_port_model(arch), mesh,
                            {k: s for k, (s, _) in tin.items()})
    assert opt.step == tuple(jopt.step) == () and opt.m is p and opt.v is p
    assert b == {k: tuple(v) for k, v in jb.items()}
    jflat = {jshd._path_str(q): v for q, v in
             jax.tree_util.tree_flatten_with_path(
                 jp, is_leaf=lambda x: isinstance(x, P))[0]}
    for path, spec in _spec_items(p):
        key, stacked = _jax_key(path)
        assert spec == _expected(jflat[key], stacked), path
