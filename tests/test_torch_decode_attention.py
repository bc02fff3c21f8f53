"""The port's sharded decode attention (``repro_torch.serve.
decode_attention``) on 4 gloo ranks against JAX's sharded decode on a mesh
of 4 host devices.

One module fixture builds the reduced models' weights with JAX's ``init``
(seed 0) and starts, together, two JAX subprocesses (one a mesh, a
``jax.sharding.Mesh`` of 4 forced host devices in ``Auto`` axes, which runs
JAX's ``shard_map`` paths on this host; ``jax.make_mesh``'s default
``Explicit`` axes fail at ``act_sharding.py:53``) and one launch of 4 gloo
ranks (``tests/torch_ranks.py``).  Both run every case of :data:`CASES`
on the meshes (data, model) = (1, 4) and (2, 2): reduced f32 yi-9b (GQA)
and deepseek-v2-lite-16b (MLA), 8 teacher-forced decode steps from seed
0's tokens, on the dense slab and on the pool (``CacheSpec(4, 12)``,
tables [[1..4], [5..8]]), f32 and ``bf16_grouped``, at one shared index
and at per-row indices; a prefill-then-``shard_cache`` case; and
``s_max`` 18, which model 4 does not divide (both packages stay dense
there; model 2 divides it).

* Every case's logits equal JAX's on the same mesh within ``REL_TOL``
  (1e-5) of JAX's largest logit; ranks that share rows hold equal logits.
* The sharded path ran: ``layers x steps`` calls and 3 all-reduces each,
  none where the axis does not divide.
* The combine runs over the model group: the (2, 2) case rerun over the
  whole world misses JAX by far more than the tolerance.
* bf16: ``sharded_gqa_decode`` itself on a bf16 slab (an f32 query, so
  no output rounding hides the forms), 8 steps on 4 ranks: the port's
  ``bf16_grouped`` within 1e-5 of JAX's, and JAX's grouped-vs-f32 gap
  (P rounded to bf16) far above that; the port's f32 form misses the
  grouped bound by that gap.  (A whole bf16 model cannot tell the forms
  apart: its logits differ between the two packages by about as much as
  the forms differ, in the max and in the mean.)
* The helpers against JAX's one by one (no ranks): the in-place writes,
  the paged view, the partials.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.registry import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro.serve import decode_attention as jda
from repro_torch.serve import decode_attention as tda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = os.path.join(ROOT, "tests", "torch_ranks.py")
#: max |port - JAX| over max |JAX| of every case's logits
REL_TOL = 1e-5
MESHES = ((1, 4), (2, 2))
ARCHS = {"yi": ("yi-9b", "float32"),
         "lite": ("deepseek-v2-lite-16b", "float32")}
STEPS = 8
#: per-row indices: row 1 decodes 5 positions ahead of row 0
OFFSETS = (0, 5)
POOL = dict(cache="pool", spec=(4, 12), tables=[[1, 2, 3, 4], [5, 6, 7, 8]],
            index="rows")


def _case(name, arch, precision, *, cache="slab", index="int", s_max=16,
          prefill=0, meshes=MESHES, **kw):
    return dict(name=name, arch=arch, precision=precision, cache=cache,
                index=index, s_max=s_max, prefill=prefill, steps=STEPS,
                offsets=OFFSETS, meshes=meshes, **kw)


CASES = [
    _case("gqa_slab_f32", "yi", "f32"),
    _case("gqa_slab_grouped", "yi", "bf16_grouped", index="rows"),
    _case("gqa_pool_f32", "yi", "f32", **POOL),
    _case("gqa_pool_grouped", "yi", "bf16_grouped", **POOL),
    _case("mla_slab_f32", "lite", "f32"),
    # MLA has no grouped form: the knob leaves it on the f32 path
    _case("mla_slab_grouped", "lite", "bf16_grouped", index="rows",
          meshes=((2, 2),)),
    _case("mla_pool_f32", "lite", "f32", **POOL),
    _case("gqa_slab_s18", "yi", "f32", s_max=18, meshes=((1, 4),)),
    _case("gqa_prefill", "yi", "f32", prefill=5, meshes=((2, 2),)),
]
#: the bf16 attention cases: sharded_gqa_decode on a (B, S, Hkv, dh) bf16
#: slab of mesh (1, 4), an f32 query of H heads, in each form
ATTN = dict(b=2, s=16, h=8, hkv=2, dh=32, mesh=(1, 4),
            forms={"grouped": True, "f32": False})
#: rerun on (2, 2) with the model group replaced by the world's
CONTROL = "gqa_slab_f32"

JAX_CODE = textwrap.dedent("""
    import pickle, sys
    from dataclasses import replace
    import jax, jax.numpy as jnp, numpy as np
    from repro.models.common import CacheSpec
    from repro.models.registry import get_config, get_model
    from repro.parallel.act_sharding import activation_sharding

    workdir, only = sys.argv[1], tuple(map(int, sys.argv[2].split("x")))
    with open(workdir + "/in.pkl", "rb") as f:
        job = pickle.load(f)
    devices = np.array(jax.devices())
    out = {}
    for case in job["cases"]:
        if only not in map(tuple, case["meshes"]):
            continue
        arch, dtype = job["archs"][case["arch"]]
        cfg = replace(get_config(arch).reduced(dtype=dtype, attn_impl="full"),
                      decode_attn="sharded",
                      decode_attn_precision=case["precision"])
        model = get_model(cfg)
        params = jax.tree.map(jnp.asarray, job["params"][case["arch"]])
        toks = jnp.asarray(job["tokens"][case["arch"]], jnp.int32)
        pool = case["cache"] == "pool"
        p0 = case["prefill"]
        for shape in [only]:
            mesh = jax.sharding.Mesh(devices.reshape(shape), ("data", "model"))
            state = (model.init_cache(2, case["s_max"],
                                      spec=CacheSpec(*case["spec"]))
                     if pool else model.init_cache(2, case["s_max"]))
            if p0:
                _, state = jax.jit(model.prefill)(params, toks[:, :p0], state)
            step = jax.jit(model.decode_step)      # a trace per mesh
            kw = ({"tables": jnp.asarray(case["tables"], jnp.int32)}
                  if pool else {})
            seq = []
            with mesh, activation_sharding(mesh):
                for i in range(case["steps"]):
                    pos = p0 + i
                    idx = (jnp.asarray([pos + o for o in case["offsets"]],
                                       jnp.int32)
                           if case["index"] == "rows" else jnp.int32(pos))
                    lg, state = step(params, toks[:, pos:pos + 1], state,
                                     idx, **kw)
                    seq.append(np.asarray(lg[:, 0].astype(jnp.float32)))
            out[(tuple(shape), case["name"])] = np.stack(seq)
    from repro.serve.decode_attention import sharded_gqa_decode
    a, x = job["attn"], job["attn_inputs"]
    if tuple(a["mesh"]) != only:
        a = dict(a, forms={})
    mesh = jax.sharding.Mesh(devices.reshape(a["mesh"]), ("data", "model"))
    bf = lambda v: jnp.asarray(v, jnp.bfloat16)
    for form, grouped in a["forms"].items():
        f = jax.jit(lambda q, kc, vc, kn, vn, i: sharded_gqa_decode(
            q, kc, vc, kn, vn, i, mesh, sm_scale=x["sm_scale"],
            grouped_bf16=grouped))
        kc = vc = jnp.zeros((a["b"], a["s"], a["hkv"], a["dh"]), jnp.bfloat16)
        seq = []
        with mesh:
            for i in range(len(x["q"])):
                o, kc, vc = f(jnp.asarray(x["q"][i]), kc, vc, bf(x["k"][i]),
                              bf(x["v"][i]), jnp.int32(i))
                seq.append(np.asarray(o))
        out[("attn", form)] = np.stack(seq)
    with open(workdir + "/jax_%dx%d.pkl" % only, "wb") as f:
        pickle.dump(out, f)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's logits by (mesh, case), each rank's results): JAX's two
    subprocesses (a mesh each) and the 4 gloo ranks run together on one
    input file."""
    workdir = tmp_path_factory.mktemp("decode_ranks")
    params, tokens = {}, {}
    for key, (arch, dtype) in ARCHS.items():
        cfg = jax_config(arch).reduced(dtype=dtype, attn_impl="full")
        params[key] = jax.tree.map(
            np.asarray, jax_model(cfg).init(jax.random.PRNGKey(0)))
        tokens[key] = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 16)).astype(np.int64)
    rng = np.random.default_rng(3)
    a = ATTN

    def bf16_values(shape):        # f32 arrays of bf16-exact values
        x = rng.standard_normal((STEPS,) + shape).astype(np.float32)
        return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))

    attn_inputs = {
        "q": rng.standard_normal(
            (STEPS, a["b"], 1, a["h"], a["dh"])).astype(np.float32),
        "k": bf16_values((a["b"], 1, a["hkv"], a["dh"])),
        "v": bf16_values((a["b"], 1, a["hkv"], a["dh"])),
        "sm_scale": 1.0 / float(a["dh"]) ** 0.5}
    with open(workdir / "in.pkl", "wb") as f:
        pickle.dump({"params": params, "tokens": tokens, "archs": ARCHS,
                     "cases": CASES, "meshes": MESHES, "control": CONTROL,
                     "attn": ATTN, "attn_inputs": attn_inputs}, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_backend_optimization_level=0")
    # JAX's meshes in a process each, beside the 4 ranks
    cmds = [[sys.executable, "-c", JAX_CODE, str(workdir), f"{d}x{m}"]
            for d, m in MESHES] + [[sys.executable, RANKS, "decode",
                                    str(workdir)]]
    procs = [subprocess.Popen(c, cwd=ROOT, env=env, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
        errs.append((p.returncode, err[-3000:]))
    assert all(rc == 0 for rc, _ in errs), errs
    want = {}
    for d, m in MESHES:
        with open(workdir / f"jax_{d}x{m}.pkl", "rb") as f:
            want.update(pickle.load(f))
    ranks = []
    for r in range(4):
        with open(workdir / f"out_{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return want, ranks


def _gather(ranks, res_of) -> np.ndarray:
    """The (steps, B, V) logits of the ranks' results (``res_of(rank
    output)``), each row from every rank that holds it, all equal."""
    rows = {}
    for out in ranks:
        res = res_of(out)
        for j, row in enumerate(res["rows"]):
            got = res["logits"][:, j]
            if row in rows:
                np.testing.assert_array_equal(got, rows[row])
            rows[row] = got
    return np.stack([rows[r] for r in sorted(rows)], axis=1)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


PARITY = [(shape, c["name"]) for c in CASES for shape in c["meshes"]]


@pytest.mark.parametrize("shape,name", PARITY,
                         ids=[f"{s[0]}x{s[1]}-{n}" for s, n in PARITY])
def test_sharded_decode_matches_jax(runs, shape, name):
    want, ranks = runs
    got = _gather(ranks, lambda out: out["cases"][(shape, name)])
    assert got.shape == want[(shape, name)].shape
    assert _rel(got, want[(shape, name)]) <= REL_TOL


def test_sharded_path_taken(runs):
    """layers x steps sharded calls on every rank, 3 all-reduces each;
    none where the model axis does not divide the slab (s_max 18 on 4)."""
    _, ranks = runs
    for out in ranks:
        for (shape, name), res in out["cases"].items():
            case = next(c for c in CASES if c["name"] == name)
            cut = not (name == "gqa_slab_s18" and shape[1] == 4)
            want = 2 * STEPS if cut else 0          # reduced: 2 layers
            assert (res["calls"], res["all_reduces"]) == (want, 3 * want), \
                (shape, name, res["calls"], res["all_reduces"])
            assert case["s_max"] % shape[1] == 0 or not cut


def test_mesh_groups(runs):
    """Each rank's coordinates and its axes' groups: row-major ranks, the
    model group the ranks of one data coordinate."""
    _, ranks = runs
    for r, out in enumerate(ranks):
        assert out["mesh"][(1, 4)] == {
            "coords": {"data": 0, "model": r},
            "groups": {"data": [r], "model": [0, 1, 2, 3]}}
        d, m = divmod(r, 2)
        assert out["mesh"][(2, 2)] == {
            "coords": {"data": d, "model": m},
            "groups": {"data": [m, 2 + m], "model": [2 * d, 2 * d + 1]}}


def test_combine_over_the_world_misses_jax(runs):
    """The (2, 2) slab case with its partials combined over all 4 ranks
    (each data row's with the other row's) is far from JAX's."""
    want, ranks = runs
    got = _gather(ranks, lambda out: out["control"])
    assert _rel(got, want[((2, 2), CONTROL)]) > 1e3 * REL_TOL


def test_bf16_grouped_attention_matches_jax(runs):
    """bf16 slab, f32 query: the port's grouped form within REL_TOL of
    JAX's; JAX's grouped-vs-f32 gap (P rounded to bf16 before P@V) over
    50x that; the port's f32 form as far from JAX's grouped as that gap
    (the bound tells the forms apart), and within REL_TOL of JAX's f32."""
    want, ranks = runs
    got = {form: _gather(ranks, lambda out: out["attn"][form])
           for form in ATTN["forms"]}
    gap = _rel(want[("attn", "f32")], want[("attn", "grouped")])
    assert gap > 50 * REL_TOL, gap
    assert _rel(got["grouped"], want[("attn", "grouped")]) <= REL_TOL
    assert _rel(got["f32"], want[("attn", "f32")]) <= REL_TOL
    assert _rel(got["f32"], want[("attn", "grouped")]) > gap / 2


# ---------------------------------------------------------------------------
# the helpers against JAX's, one rank's view (no process group)
# ---------------------------------------------------------------------------

def _rand(rng, shape, dtype=np.float32):
    return rng.standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("index", ["int", "rows"])
@pytest.mark.parametrize("rank", [0, 1, 3])
def test_local_update_in_place_equals_jax(index, rank):
    """The rank-local slab write: JAX's functional result, written in
    place into the same storage, only where the column lands in range."""
    rng = np.random.default_rng(rank)
    cache = _rand(rng, (3, 4, 2, 8))
    new = _rand(rng, (3, 1, 2, 8))
    idx = np.array([1, 6, 13]) if index == "rows" else 6
    want = np.asarray(jda._local_update(
        jnp.asarray(cache), jnp.asarray(new),
        jnp.asarray(idx) if index == "rows" else idx, rank, 4))
    t = torch.from_numpy(cache.copy())
    ptr = t.data_ptr()
    got = tda._local_update(t, torch.from_numpy(new),
                            torch.from_numpy(idx) if index == "rows" else idx,
                            rank, 4)
    assert got.data_ptr() == ptr
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_paged_local_update_and_view_equal_jax(rank):
    """The rank-local pool write (3 ranks of 4 blocks; a row whose block
    another rank owns writes nothing) and the masked logical view."""
    rng = np.random.default_rng(rank)
    pool = _rand(rng, (4, 4, 2, 8))
    new = _rand(rng, (3, 1, 2, 8))
    table = np.array([[1, 2, 5], [6, 9, 10], [4, 3, 11]])
    idx = np.array([2, 9, 4])
    phys = table[np.arange(3), idx // 4]
    off = idx % 4
    want = np.asarray(jda._paged_local_update(
        jnp.asarray(pool), jnp.asarray(new), jnp.asarray(phys),
        jnp.asarray(off), rank, 4))
    t = torch.from_numpy(pool.copy())
    tda._paged_local_update(t, torch.from_numpy(new), torch.from_numpy(phys),
                            torch.from_numpy(off), rank, 4, 3)
    np.testing.assert_array_equal(t.numpy(), want)
    jv, jo = jda._paged_local_view(jnp.asarray(want), jnp.asarray(table),
                                   rank, 4)
    tv, to = tda._paged_local_view(t, torch.from_numpy(table), rank, 4)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_partials_equal_jax(grouped, dtype):
    """(m, l, o) over one rank's view, per-row validity, 8 heads on 2 KV
    heads: within 1e-6 of JAX's (f32 accumulation both)."""
    rng = np.random.default_rng(7)
    q, k, v = (_rand(rng, s) for s in ((3, 1, 8, 16), (3, 6, 2, 16),
                                        (3, 6, 2, 16)))
    ok = np.arange(6)[None, None, :] <= np.array([0, 3, 5])[:, None, None]
    jt = jnp.dtype(dtype)
    want = jda._gqa_partials(jnp.asarray(q, jt), jnp.asarray(k, jt),
                             jnp.asarray(v, jt), jnp.asarray(ok), g=4,
                             sm_scale=0.25, grouped_bf16=grouped)
    tt = getattr(torch, dtype)
    got = tda._gqa_partials(*(torch.from_numpy(a).to(tt) for a in (q, k, v)),
                            torch.from_numpy(ok), g=4, sm_scale=0.25,
                            grouped_bf16=grouped)
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.float32
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-6,
                                   atol=1e-6)


def test_mla_partials_equal_jax():
    rng = np.random.default_rng(8)
    qa, qr, c, r = (_rand(rng, s) for s in ((2, 1, 4, 32), (2, 1, 4, 16),
                                             (2, 5, 32), (2, 5, 16)))
    ok = np.arange(5)[None, None, :] <= np.array([1, 4])[:, None, None]
    want = jda._mla_partials(*map(jnp.asarray, (qa, qr, c, r, ok)),
                             sm_scale=0.17)
    got = tda._mla_partials(*map(torch.from_numpy, (qa, qr, c, r, ok)),
                            sm_scale=0.17)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-6,
                                   atol=1e-6)


class _Mesh:
    """A mesh's shape and coordinates, no groups (``shard_cache`` reads
    nothing else)."""

    def __init__(self, shape, coords):
        self.axis_names = ("data", "model")
        self.shape = dict(zip(self.axis_names, shape))
        self.coords = dict(zip(self.axis_names, coords))
        self.groups = {"data": None, "model": None}


def test_shard_cache_cuts_by_the_layout_contract():
    """Dense: the rank's rows and contiguous columns (a KVShard copy);
    paged: its blocks, every row; a leaf the model axis does not divide
    stays whole (a plain KVCache: the dense path)."""
    from repro_torch.models.attention import KVCache, KVShard
    k = torch.arange(2 * 16 * 3, dtype=torch.float32).reshape(2, 16, 3)
    mesh = _Mesh((2, 2), (1, 1))
    got = tda.shard_cache([KVCache(k, k + 1)], mesh)[0]
    assert type(got) is KVShard
    torch.testing.assert_close(got.k, k[1:, 8:], rtol=0, atol=0)
    torch.testing.assert_close(got.v, k[1:, 8:] + 1, rtol=0, atol=0)
    assert got.k.data_ptr() != k.data_ptr()
    pool = torch.arange(12 * 4, dtype=torch.float32).reshape(12, 4)
    got = tda.shard_cache(KVCache(pool, pool), _Mesh((1, 4), (0, 2)),
                          paged=True)
    assert type(got) is KVShard
    torch.testing.assert_close(got.k, pool[6:9], rtol=0, atol=0)
    odd = torch.zeros(2, 18, 3)
    got = tda.shard_cache(KVCache(odd, odd), _Mesh((2, 4), (1, 3)))
    assert type(got) is KVCache and got.k.shape == (1, 18, 3)
    assert tda.owns_shard(KVShard(k, k), mesh)
    assert not tda.owns_shard(KVCache(k, k), mesh)
    assert tda.owns_shard(KVCache(k, k), _Mesh((4, 1), (2, 0)))
    assert not tda.owns_shard(KVShard(k, k), None)
