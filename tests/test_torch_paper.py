"""The paper's own entry points on the port against the JAX package.

* ``repro_torch.core.cost_model`` equals ``repro.core.cost_model`` on
  every public function (bits 2-16, every ``LunaMode``; the same
  exceptions), and states the paper's numbers as
  ``tests/test_cost_model.py`` does (Tables I/II, Figs 2, 9, 10, 15, 16,
  18, storage scaling).
* ``tools/paper_tables_torch.py``'s ``ALL`` on the CPU: every row's
  assertion holds and each returned value equals
  ``benchmarks/paper_tables.py``'s (Fig 13's MAEs within 1e-6: the same
  numpy draws through the LUNA GEMM's plain version, JAX's library path).
* ``examples/fig13_nn_accuracy_torch.py`` from JAX's initial weights
  (``train_one(mode, steps=0)``'s, carried across as numpy): the first
  step's loss and every gradient within 1e-5 of JAX's (its scale), the
  final MAEs (``FINAL_MAE_TOL``, ``QAT_MAE_TOL``) and the PTQ columns
  (1e-6) against JAX's ``train_one`` and ``ptq_mae``, and ``main`` holds
  JAX's three bounds.
* ``examples/quickstart_torch.py``, ``serve_luna_torch.py`` and
  ``train_lm_torch.py`` run with ``--device cpu`` at a tiny size.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost_model as jcm
from repro.core.luna import LunaMode as JLunaMode
from repro_torch.core import cost_model as cm
from repro_torch.core.luna import LunaMode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the final MAE of the f32 ("ideal") net and of the PTQ columns, port
#: against JAX from the same start: f32 sums in other orders over 300
#: steps
FINAL_MAE_TOL = 1e-6
#: the QAT modes' final MAE, absolute, by mode.  Their forward is
#: piecewise constant, and JAX's train step is compiled: XLA divides by
#: the constant qmax as a multiply by its reciprocal, an ulp off the exact
#: quotient the port (and JAX op by op) takes, so a code near a boundary
#: takes the next code on one side.  300 steps of that walk apart:
#: opt_dc by 8.5e-3 (4% of its MAE), approx_dc and approx_dc2 by 2.2e-5
#: and 7.0e-5
QAT_MAE_TOL = {"opt_dc": 2e-2, "approx_dc2": 1e-3, "approx_dc": 1e-3}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Each module pins torch to one intra-op thread (the suite runs the
    files in several worker processes at once), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(relpath: str, name: str):
    """A script of the repo as a module (examples/, tools/, benchmarks/
    are not packages)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------

def _same(port_fn, jax_fn, *args):
    """Both raise the same exception type, or return equal values."""
    try:
        want = jax_fn(*args)
    except Exception as e:                   # noqa: BLE001 (the type is held)
        with pytest.raises(type(e)):
            port_fn(*args)
        return
    got = port_fn(*args)
    assert type(got).__name__ == type(want).__name__
    if isinstance(want, (jcm.HwCost,)):
        assert (got.srams, got.muxes, got.has, got.fas, got.transistors) \
            == (want.srams, want.muxes, want.has, want.fas, want.transistors)
    else:
        assert got == want


@pytest.mark.parametrize("bits", range(2, 17))
def test_cost_model_equals_jax(bits):
    for name in ("conventional_cost", "dc_cost", "opt_dc_cost",
                 "approx_dc_cost", "approx_dc2_cost"):
        _same(getattr(cm, name), getattr(jcm, name), bits)
    assert [m.value for m in LunaMode] == [m.value for m in JLunaMode]
    for mode in LunaMode:
        _same(cm.variant_cost, jcm.variant_cost, mode.value, bits)
    for digits in range(1, bits + 1):
        for width in (bits, bits + 2):
            assert cm.adder_tree_counts(digits, width) \
                == jcm.adder_tree_counts(digits, width)


def test_reports_equal_jax():
    assert cm.energy_report() == jcm.energy_report()
    assert cm.area_report(4) == jcm.area_report(4)
    for n in range(0, 9):
        assert cm.array_overhead(n) == jcm.array_overhead(n)
    assert cm.TRANSISTORS == jcm.TRANSISTORS
    a = cm.HwCost(1, 2, 3, 4) + cm.HwCost(5, 6, 7, 8)
    assert (a.srams, a.muxes, a.has, a.fas) == (6, 8, 10, 12)


@pytest.mark.parametrize("bits,expected", [
    (3, (48, 42)), (4, (128, 120)), (5, (320, 310)), (6, (768, 756)),
    (7, (1792, 1778)), (8, (4096, 4080))])
def test_table1_conventional_lut(bits, expected):
    c = cm.conventional_cost(bits)
    assert (c.srams, c.muxes) == expected


@pytest.mark.parametrize("fn,args,expected", [
    ("dc_cost", (4,), (24, 36, 3, 3)),                 # Fig 2
    ("opt_dc_cost", (4,), (10, 36, 3, 3)),             # Table II
    ("opt_dc_cost", (8,), (36, 120, 11, 21)),
    ("opt_dc_cost", (16,), (136, 432, 31, 105)),
    ("approx_dc_cost", (4,), (10, 18, 0, 0)),          # Fig 9
    ("approx_dc2_cost", (4,), (12, 18, 4, 1))])        # Fig 10
def test_paper_component_counts(fn, args, expected):
    c = getattr(cm, fn)(*args)
    assert (c.srams, c.muxes, c.has, c.fas) == expected


def test_paper_energy_area_overhead():
    rep = cm.energy_report()
    assert rep["multiplier_share"] == pytest.approx(2.76e-4, rel=0.02)
    assert rep["multiplier_share"] < 1e-3              # abstract: <0.1 %
    area = cm.area_report(4)
    ratio = area["opt_dc"]["area_vs_conventional"]
    assert 3.3 <= ratio <= 4.1, ratio                  # abstract: ~3.7x
    assert area["approx_dc"]["area_vs_conventional"] > ratio
    over = cm.array_overhead(4)
    assert over["overhead_fraction"] == pytest.approx(0.32, abs=0.01)
    assert over["unit_area_um2"] == 287.0
    assert over["total_area_um2"] == 3650.0
    for bits in (4, 8, 16):
        assert cm.opt_dc_cost(bits).srams < cm.conventional_cost(bits).srams
    assert cm.conventional_cost(16).srams == 2097152
    assert cm.opt_dc_cost(16).srams == 136


# ---------------------------------------------------------------------------
# the paper tables
# ---------------------------------------------------------------------------

def _equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _equal(a, b, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, jax.Array)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-6, abs=1e-6), path
    else:
        assert got == want, path


def test_paper_tables_all_on_cpu(capsys):
    port = _load("tools/paper_tables_torch.py", "paper_tables_torch")
    ref = _load("benchmarks/paper_tables.py", "paper_tables_jax")
    assert [f.__name__ for f in port.ALL] == [f.__name__ for f in ref.ALL]
    got = {f.__name__: f("cpu") for f in port.ALL}
    rows = [ln.split(",") for ln in capsys.readouterr().out.splitlines()]
    want = {f.__name__: f() for f in ref.ALL}
    jrows = [ln.split(",") for ln in capsys.readouterr().out.splitlines()]
    for name in want:
        _equal(got[name], want[name], name)
    # the same CSV rows (names and derived values; times differ), and one
    # more: Fig 13's forward timed on the device
    timed = {"fig5", "fig6"}
    strip = [(r[0], r[2] if r[0] not in timed else "") for r in rows
             if r[0] != "fig13_forward"]
    assert strip == [(r[0], r[2] if r[0] not in timed else "")
                     for r in jrows]
    assert rows[-5][0] == "fig13_forward" and rows[-5][2] == "device=cpu"
    assert port.main(["--device", "cpu"])["fig13"] == got["fig13"]


# ---------------------------------------------------------------------------
# Fig 13 end to end
# ---------------------------------------------------------------------------

def test_fig13_against_jax():
    jfig = _load("examples/fig13_nn_accuracy.py", "fig13_jax")
    tfig = _load("examples/fig13_nn_accuracy_torch.py", "fig13_torch")
    assert (tfig.MODES, tfig.PTQ_MAE_BOUND, tfig.NF4_DC_VS_DIRECT_TOL,
            tfig.NF4P_MAE_DELTA_BOUND) == (
        jfig.MODES, jfig.PTQ_MAE_BOUND, jfig.NF4_DC_VS_DIRECT_TOL,
        jfig.NF4P_MAE_DELTA_BOUND) == (
        ["ideal", "opt_dc", "approx_dc2", "approx_dc"], 1.25, 1e-4, 0.05)
    _, jinit = jfig.train_one("ideal", steps=0)
    init = {k: np.array(v) for k, v in jinit.items()}
    x, y = jfig.make_data()
    tx, ty = tfig.make_data()
    np.testing.assert_array_equal(tx.numpy(), np.asarray(x))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(y))
    for mode in jfig.MODES:
        jl, jg = jax.jit(jax.value_and_grad(
            lambda p: jnp.mean((jfig.mlp_fwd(p, x, mode) - y) ** 2)))(
            jax.tree.map(jnp.asarray, init))
        tl, tg = tfig.loss_and_grads(
            {k: torch.from_numpy(v) for k, v in init.items()}, tx, ty, mode)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
        for k, want in jg.items():
            want = np.asarray(want)
            np.testing.assert_allclose(tg[k].numpy(), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
    jres, jparams = {}, {}
    for mode in jfig.MODES:
        jres[mode], jparams[mode] = jfig.train_one(mode)
    ptq = (("lut_dc", None, "ptq_lut4"), ("dequant", None, "ptq_int4"),
           ("nf4_dc", None, "ptq_nf4"),
           ("nf4_dequant", None, "ptq_nf4_direct"),
           ("nf4_dc", tfig.NF4P_PRUNE_THRESHOLD, "ptq_nf4p"))
    for kernel, prune, label in ptq:
        jres[label] = jfig.ptq_mae(jparams["ideal"], kernel, prune)
    res = tfig.main(["--device", "cpu"], init=init)      # JAX's bounds
    for key, want in jres.items():
        tol = QAT_MAE_TOL.get(key, FINAL_MAE_TOL)
        assert abs(res[key] - want) <= tol, (key, res[key], want)
    for r in (res, jres):                 # the paper's ordering, both sides
        assert r["opt_dc"] < r["approx_dc2"] < r["approx_dc"]
    assert res["nf4p_table"] == jfig.nf4p_table_report()
    assert res["ptq_lut4"] == res["ptq_int4"]
    # the port's own start (torch.Generator seed 0) holds the bounds too
    own = tfig.main(["--device", "cpu"])
    assert own["ideal"] != res["ideal"]


# ---------------------------------------------------------------------------
# the other examples
# ---------------------------------------------------------------------------

def test_quickstart_on_cpu(capsys):
    quick = _load("examples/quickstart_torch.py", "quickstart_torch")
    out = quick.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "Done." in text and "3.8x smaller" in text
    assert 0 < out["rel_err"]["opt_dc"] < out["rel_err"]["approx_dc"]
    assert all(np.isfinite(v) for v in out["loss"].values())
    assert all(len(o) == 6 for outs in out["outputs"].values() for o in outs)


@pytest.mark.parametrize("quant", ["lut4", "luna_approx2"])
def test_serve_luna_on_cpu(capsys, quant):
    serve = _load("examples/serve_luna_torch.py", "serve_luna_torch")
    out = serve.main(["--device", "cpu", "--requests", "3", "--max-new",
                      "4", "--quant", quant])
    assert out["stats"]["done"] and len(out["streamed"]) == 6
    assert all(len(o) == 4 for o in out["outs"])
    assert "streamed req 99" in capsys.readouterr().out


@pytest.mark.parametrize("quant", ["int8", "int4_dequant", "lut_nf4",
                                   "luna_approx"])
def test_train_lm_on_cpu(tmp_path, monkeypatch, quant):
    """The example trains under each mode; with ``--grad-compression``
    each AdamW update gets JAX's ``compress_grads_int8`` of the step's
    gradients, bitwise."""
    train = _load("examples/train_lm_torch.py", "train_lm_torch")
    args = ["--device", "cpu", "--seq", "16", "--batch", "2", "--layers",
            "2", "--d-model", "64", "--quant", quant]
    hist = train.main(args + ["--steps", "3", "--ckpt-dir",
                              str(tmp_path / "a")])
    assert len(hist) == 3 and all(np.isfinite(hist))
    import repro_torch.train.train_step as ts
    from repro.parallel.collectives import compress_grads_int8 as jax_q8
    from repro_torch.tree import leaves
    calls = []

    def recorded(grads):
        calls.append((grads, ts_compress(grads)))
        return calls[-1][1]
    ts_compress = ts.compress_grads_int8
    monkeypatch.setattr(ts, "compress_grads_int8", recorded)
    hist = train.main(args + ["--steps", "1", "--grad-compression",
                              "--ckpt-dir", str(tmp_path / "b")])
    assert len(hist) == 1 and np.isfinite(hist[0]) and len(calls) == 1
    raw, out = calls[0]
    for r, o in zip(leaves(raw), leaves(out)):
        want = jax_q8(jnp.asarray(r.detach().numpy()))
        np.testing.assert_array_equal(o.detach().numpy(), np.asarray(want))


ENTRY_SCRIPTS = ("examples/quickstart_torch.py", "examples/serve_luna_torch.py",
                 "examples/train_lm_torch.py",
                 "examples/fig13_nn_accuracy_torch.py",
                 "tools/paper_tables_torch.py")


def test_entry_scripts_import_no_jax_and_default_to_the_card():
    """With ``jax`` blocked every new script loads and nothing of
    ``repro`` gets imported; without a GPU each ``main`` given no device
    raises (the port's device rule) instead of running on the CPU."""
    import subprocess
    import sys
    import textwrap
    code = textwrap.dedent(f"""
        import importlib.util, os, sys
        sys.modules["jax"] = None
        import torch
        for i, rel in enumerate({ENTRY_SCRIPTS!r}):
            spec = importlib.util.spec_from_file_location(
                f"entry{{i}}", os.path.join({ROOT!r}, rel))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            if torch.cuda.is_available():
                continue
            try:
                mod.main([])
            except RuntimeError as e:
                assert "CUDA" in str(e), (rel, e)
            else:
                raise AssertionError(rel + " ran without a card")
        leaked = sorted(m for m in sys.modules
                        if m == "repro" or m.startswith("repro."))
        assert not leaked, leaked
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
