"""The port's int8 collectives (``repro_torch.parallel.collectives``) and
meshes (``repro_torch.launch.mesh``) against the JAX package.

* ``_q8``'s codes and scale, ``compress_grads_int8`` over a tree of f32
  and bf16 leaves, and ``ErrorFeedback`` over 5 steps (compressed
  gradients and residuals): bitwise JAX's, op by op.
* ``quantized_psum`` on 4 gloo ranks (``tests/torch_ranks.py``): over
  the world, bitwise JAX's ``quantized_psum`` over a 4-member axis
  (``jax.vmap`` with an axis name: the same ``pmax``/``psum``), and
  within JAX's own bound (``test_quantized_psum_multidevice``: 3% of the
  largest sum) of the exact sum; over a (2, 2) mesh's data group, JAX's
  over the "data" axis of a (2, 2) layout.
* The meshes: coordinates and groups, ``make_host_mesh`` and the
  production mesh refuse what they cannot build.
"""
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.parallel import collectives as jc
from repro_torch.launch import mesh as tmesh
from repro_torch.parallel import collectives as tc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = os.path.join(ROOT, "tests", "torch_ranks.py")


def _x(kind: str, shape=(64, 33), dtype=np.float32) -> np.ndarray:
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "tiny":              # every |x| under the 1e-12 scale floor
        x = x * 1e-14
    elif kind == "zeros":
        x = np.zeros(shape, np.float32)
    elif kind == "wide":            # a spread of magnitudes, ties at .5
        x = x * np.float32(10.0) ** rng.integers(-6, 4, shape)
        x[0, :8] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 126.5, -126.5,
                             127.0], np.float32) / 127.0 * x.max()
    return x.astype(dtype)


@pytest.mark.parametrize("kind", ["normal", "tiny", "zeros", "wide"])
def test_q8_bitwise_equals_jax(kind):
    x = _x(kind)
    jq, js = jc._q8(jnp.asarray(x))
    tq, ts = tc._q8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()


def _tree(rng):
    """A gradient-shaped tree: nested dicts and a list, f32 and bf16; the
    keys in sorted order, so both packages list the leaves alike."""
    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"bf16": a(8, 8),
            "blocks": [{"b": a(16), "w": a(16, 16)},
                       {"b": a(16), "w": a(16, 16) * 1e3}],
            "embed": a(32, 16)}


def _to_jax(tree):
    return jax.tree.map(
        lambda v: jnp.asarray(v, jnp.bfloat16 if v.shape == (8, 8)
                              else jnp.float32), tree)


def _to_torch(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda v: torch.from_numpy(v).to(
        torch.bfloat16 if v.shape == (8, 8) else torch.float32), tree)


def _assert_bitwise(got_tree, want_tree):
    from repro_torch.tree import leaves
    got, want = leaves(got_tree), jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w.astype(jnp.float32)))


def test_compress_grads_int8_bitwise_equals_jax():
    tree = _tree(np.random.default_rng(1))
    _assert_bitwise(tc.compress_grads_int8(_to_torch(tree)),
                    jc.compress_grads_int8(_to_jax(tree)))


def test_error_feedback_bitwise_equals_jax():
    """5 steps: each compressed tree and the residual after it."""
    rng = np.random.default_rng(2)
    jef, tef = jc.ErrorFeedback(), tc.ErrorFeedback()
    for _ in range(5):
        tree = _tree(rng)
        _assert_bitwise(tef.compress(_to_torch(tree)),
                        jef.compress(_to_jax(tree)))
        _assert_bitwise(tef.residual, jef.residual)


def test_make_host_mesh_needs_a_process_group():
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.make_host_mesh(model=1)
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.Mesh((1, 1), ("data", "model"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4 ranks' results on x (4, 64, 33): row r is rank r's."""
    workdir = tmp_path_factory.mktemp("collective_ranks")
    x = np.stack([_x("normal") * (r + 1) for r in range(4)])
    with open(workdir / "in.pkl", "wb") as f:
        pickle.dump({"x": x}, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, RANKS, "collectives", str(workdir)],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    outs = []
    for rank in range(4):
        with open(workdir / f"out_{rank}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return x, outs


def test_quantized_psum_over_the_world_equals_jax(ranks):
    x, outs = ranks
    want = np.asarray(jax.vmap(lambda v: jc.quantized_psum(v, "data"),
                               axis_name="data")(jnp.asarray(x)))
    for r, out in enumerate(outs):
        assert out["world"].dtype == np.float32
        np.testing.assert_array_equal(out["world"], want[r])
    exact = x.sum(0)
    assert np.abs(outs[0]["world"] - exact).max() / np.abs(exact).max() \
        < 0.03


def test_quantized_psum_over_a_data_group_equals_jax(ranks):
    """A (2, 2) mesh: each data group sums the two ranks that share a
    model coordinate (ranks m and 2 + m)."""
    x, outs = ranks
    xs = jnp.asarray(x.reshape((2, 2) + x.shape[1:]))      # (data, model)
    want = np.asarray(jax.vmap(jax.vmap(
        lambda v: jc.quantized_psum(v, "data"), axis_name="model"),
        axis_name="data")(xs))
    for r, out in enumerate(outs):
        d, m = divmod(r, 2)
        assert out["coords"] == {"data": d, "model": m}
        np.testing.assert_array_equal(out["data"], want[d, m])
        assert not np.array_equal(out["data"], out["world"])


def test_production_mesh_refuses_a_small_world(ranks):
    _, outs = ranks
    assert all("256 ranks" in out["production_refused"] for out in outs)
