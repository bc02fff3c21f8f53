"""The port's launch analysis arithmetic (``repro_torch.launch.roofline``,
``launch.accounting``, ``models.registry.cell_supported``,
``launch.dryrun.argument_bytes``) against the JAX package's, and the
kernels' meta paths and cost formulas (``launch.cost``).

* ``cell_supported``, ``model_flops``, ``analytic_flops`` and
  ``active_params`` equal JAX's on every registry arch and every shape of
  ``ALL_SHAPES``; ``roofline_terms`` equals JAX's with JAX's TPU constants
  put in; ``probe_plan`` equals JAX's less its ``scan_layers`` override;
  ``extrapolate`` equals JAX's on ``tests/test_accounting.py``'s cases
  and on random records.
* ``count_params`` of the port's full-width meta model equals JAX's
  ``count_params(jax.eval_shape(init))`` on every arch.
* Rank 0's argument bytes of every supported cell equal the bytes of the
  shard shapes of JAX's specs (params, AdamW state, batch, caches) on the
  production meshes (16, 16) and (2, 16, 16).
* Each kernel wrapper on ``meta`` operands returns the plain version's
  output shapes and dtypes and records its formula in a cost mode; the
  D&C formula gives ``PERF.md`` §6's bound of yi-9b's decode layer.
No process group is needed here; the dry run's steps are in
``tests/test_torch_dryrun.py``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ALL_SHAPES as J_SHAPES
from repro.launch import accounting as jacc
from repro.launch import roofline as jroof
from repro.models import registry as jreg
from repro.optim.adamw import AdamW as JAdamW
from repro.parallel import sharding as jshd
from repro_torch.configs.base import ALL_SHAPES
from repro_torch.launch import accounting as tacc
from repro_torch.launch import cost
from repro_torch.launch import roofline as troof
from repro_torch.launch.dryrun import argument_bytes
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import registry as treg

ARCHS = list(jreg.ARCH_IDS)
PRODUCTION = [((16, 16), ("data", "model")),
              ((2, 16, 16), ("pod", "data", "model"))]


def test_registry_arch_lists_equal_jax():
    assert treg.ARCH_IDS == jreg.ARCH_IDS
    assert treg.SUBQUADRATIC == jreg.SUBQUADRATIC


@pytest.mark.parametrize("arch", ARCHS)
def test_pure_arithmetic_equals_jax(arch):
    cfg, jcfg = treg.get_config(arch), jreg.get_config(arch)
    n = 1_234_567_891 + len(arch)
    assert troof.active_params(cfg, n) == jroof.active_params(jcfg, n)
    for shape, jshape in zip(ALL_SHAPES, J_SHAPES):
        assert shape.name == jshape.name
        assert treg.cell_supported(arch, shape) == \
            jreg.cell_supported(arch, jshape)
        for na in (None, n // 3):
            assert troof.model_flops(cfg, shape, n, na) == \
                jroof.model_flops(jcfg, jshape, n, na)
        assert troof.analytic_flops(cfg, shape) == \
            jroof.analytic_flops(jcfg, jshape)


def test_roofline_terms_equal_jax_under_its_constants(monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(troof, name, getattr(jroof, name))
    rng = np.random.default_rng(0)
    cases = [(0.0, 0.0, 0.0, 1)] + [
        tuple(float(x) for x in rng.uniform(0, 1e16, 3)) + (int(c),)
        for c in rng.choice([1, 4, 256, 512], 40)]
    for f, b, c, chips in cases:
        assert troof.roofline_terms(f, b, c, chips) == \
            jroof.roofline_terms(f, b, c, chips)


def test_roofline_constants_are_the_h100_sheets():
    assert (troof.PEAK_FLOPS, troof.HBM_BW, troof.ICI_BW) == (
        989e12, 3.35e12, 450e9)


def _plain(probes):
    """Probe plans as comparable plain data (EncDecConfig -> its fields)."""
    out = []
    for over, counts in probes:
        over = {k: (v if isinstance(v, int) else (v.enc_layers, v.enc_seq))
                for k, v in over.items()}
        out.append((over, counts))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_probe_plan_equals_jax_less_scan_layers(arch):
    cfg, jcfg = treg.get_config(arch), jreg.get_config(arch)
    for kind in ("train", "prefill", "decode"):
        probes, full = tacc.probe_plan(cfg, kind)
        jprobes, jfull = jacc.probe_plan(jcfg, kind)
        assert all(o.pop("scan_layers") is False for o, _ in jprobes)
        assert full == jfull
        assert _plain(probes) == _plain(jprobes)


def _records(values: list[tuple]) -> tuple[list, list]:
    """(port records, JAX records) of the same (flops, bytes, collective
    bytes, all-gather bytes, all-reduce bytes) per probe."""
    port, jax_ = [], []
    for f, b, c, ag, ar in values:
        port.append({"flops": f, "bytes": b, "collective_bytes": c,
                     "coll_all_gather": ag, "coll_all_reduce": ar})
        jax_.append({"hlo_flops": f, "hlo_bytes": b, "collective_bytes": c,
                     "collective_breakdown": {
                         "all-gather": ag, "all-reduce": ar,
                         "reduce-scatter": 0, "all-to-all": 0,
                         "collective-permute": 0}})
    return port, jax_


def _held_to_jax(cfg, jcfg, kind, values):
    probes, full = tacc.probe_plan(cfg, kind)
    jprobes, jfull = jacc.probe_plan(jcfg, kind)
    port, jrecs = _records(values)
    got = tacc.extrapolate(port, probes, full)
    want = jacc.extrapolate(jrecs, jprobes, jfull)
    for a, b in (("flops", "hlo_flops"), ("bytes", "hlo_bytes"),
                 ("collective_bytes", "collective_bytes"),
                 ("coll_all_gather", "coll_all_gather"),
                 ("coll_all_reduce", "coll_all_reduce"),
                 ("probe_residual", "probe_residual")):
        assert got[a] == want[b], (a, got[a], want[b])
    return got


def test_extrapolate_equals_jax_on_its_cases():
    """tests/test_accounting.py's extrapolation cases, through both."""
    cfg, jcfg = treg.get_config("yi-9b"), jreg.get_config("yi-9b")
    base, layer = 7.0, 3.0
    vals = [(base + layer * c, 2 * (base + layer * c), 10 * c, 5 * c, 5 * c)
            for c in (1, 2)]
    got = _held_to_jax(cfg, jcfg, "train", vals)
    assert got["flops"] == pytest.approx(base + layer * cfg.num_layers)
    assert got["probe_residual"] < 1e-9
    # hybrid: three components
    cfg, jcfg = (treg.get_config("zamba2-1.2b"),
                 jreg.get_config("zamba2-1.2b"))
    probes, full = tacc.probe_plan(cfg, "train")

    def f(c):
        return 5.0 * c["base"] + 11.0 * c["attn"] + 2.0 * c["mamba"]
    got = _held_to_jax(cfg, jcfg, "train",
                       [(f(c),) * 3 + (f(c) / 2,) * 2 for _, c in probes])
    assert full["attn"] == 7 and full["mamba"] == 38
    assert got["flops"] == pytest.approx(5 + 11 * 7 + 2 * 38)
    # encdec
    cfg, jcfg = (treg.get_config("whisper-base"),
                 jreg.get_config("whisper-base"))
    probes, _ = tacc.probe_plan(cfg, "train")
    vals = [(1 + 4 * c.get("enc", 0) + 9 * c.get("dec", 0),) * 2 + (0,) * 3
            for _, c in probes]
    got = _held_to_jax(cfg, jcfg, "train", vals)
    assert got["flops"] == pytest.approx(1 + 6 * 4 + 6 * 9)
    # moe: the first dense layer lives in "base"
    probes, full = tacc.probe_plan(treg.get_config("deepseek-v2-236b"),
                                   "train")
    assert full == {"base": 1, "moe": 59}
    assert probes[0][1] == {"base": 1, "moe": 1}


@pytest.mark.parametrize("arch", ["yi-9b", "deepseek-v2-lite-16b",
                                  "zamba2-1.2b", "whisper-base"])
def test_extrapolate_equals_jax_on_random_records(arch):
    rng = np.random.default_rng(len(arch))
    cfg, jcfg = treg.get_config(arch), jreg.get_config(arch)
    for kind in ("train", "decode"):
        n = len(tacc.probe_plan(cfg, kind)[0])
        _held_to_jax(cfg, jcfg, kind,
                     [tuple(rng.uniform(0, 1e12, 5)) for _ in range(n)])


@pytest.fixture(scope="module")
def jax_params():
    """JAX's abstract full-width params of every arch (by arch)."""
    out = {}
    for arch in ARCHS:
        model = jreg.get_model(jreg.get_config(arch))
        out[arch] = jax.eval_shape(
            lambda m=model: m.init(jax.random.PRNGKey(0)))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_equals_jax(arch, jax_params):
    model = treg.get_model(treg.get_config(arch), device="meta")
    n = troof.count_params(model)
    assert n == jroof.count_params(jax_params[arch])
    assert n == troof.count_params(model.params_tree())
    assert n == troof.count_params([tuple(p.shape)
                                    for p in model.parameters()])


class FakeMesh:
    """What JAX's rules read of a mesh (``tests/test_sharding.py``'s
    stand-in, as in ``tests/test_torch_sharding.py``)."""

    def __init__(self, shape, names):
        self.axis_names = names

        class _D:
            pass
        self.devices = _D()
        self.devices.shape = shape
        self.devices.size = int(np.prod(shape))


def _jax_shard_bytes(tree, specs, sizes) -> int:
    """Bytes of rank 0's blocks of a tree of abstract arrays under a tree
    of ``PartitionSpec`` s."""
    total = 0
    flat = jax.tree.leaves(tree)
    flat_specs = jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(flat) == len(flat_specs)
    for leaf, spec in zip(flat, flat_specs):
        shape = list(leaf.shape)
        for d, ax in enumerate(tuple(spec)):
            for a in ((ax,) if isinstance(ax, str) else (ax or ())):
                assert shape[d] % sizes[a] == 0
                shape[d] //= sizes[a]
        total += math.prod(shape) * jnp.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("mesh_shape,names", PRODUCTION,
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_jax_specs(arch, mesh_shape, names, jax_params,
                                        monkeypatch):
    monkeypatch.setattr(jshd, "NamedSharding", lambda mesh, spec: spec)
    fake = FakeMesh(mesh_shape, names)
    mesh = AbstractMesh(mesh_shape, names)
    sizes = dict(zip(names, mesh_shape))
    cfg, jcfg = treg.get_config(arch), jreg.get_config(arch)
    model = treg.get_model(cfg, device="meta")
    jmodel = jreg.get_model(jcfg)
    params = jax_params[arch]
    for shape, jshape in zip(ALL_SHAPES, J_SHAPES):
        if not jreg.cell_supported(arch, jshape)[0]:
            continue
        got = argument_bytes(cfg, shape, mesh, model, "bf16")
        p_sh = jshd.param_shardings(params, fake,
                                    serve_tp=False)
        want = {"params": _jax_shard_bytes(params, p_sh, sizes)}
        batch = jreg.input_specs(jcfg, jshape)
        want["batch"] = _jax_shard_bytes(
            batch, jshd.batch_shardings(batch, fake), sizes)
        if shape.kind == "train":
            opt = jax.eval_shape(JAdamW().init, params)
            want["opt_state"] = (2 * _jax_shard_bytes(opt.m, p_sh, sizes)
                                 + 4)
        else:
            cache = jax.eval_shape(lambda: jmodel.init_cache(
                jshape.global_batch, jshape.seq_len))
            if jcfg.family == "encdec" and shape.kind == "decode":
                cache = (cache, jax.ShapeDtypeStruct(
                    (jshape.global_batch, jcfg.encdec.enc_seq,
                     jcfg.d_model), jnp.dtype(jcfg.dtype)))
            want["caches"] = _jax_shard_bytes(
                cache, jshd.cache_shardings(cache, fake), sizes)
        want["total"] = sum(want.values())
        assert got == want, (shape.name, got, want)


# ---------------------------------------------------------------------------
# the kernels' meta paths and formulas
# ---------------------------------------------------------------------------

def _meta(*ts):
    return [None if t is None else t.to("meta") for t in ts]


def _same_layout(meta_out, plain_out):
    if isinstance(plain_out, (tuple, list)):
        assert len(meta_out) == len(plain_out)
        for a, b in zip(meta_out, plain_out):
            _same_layout(a, b)
        return
    if plain_out is None:
        assert meta_out is None
        return
    assert meta_out.device.type == "meta"
    assert meta_out.shape == plain_out.shape
    assert meta_out.dtype == plain_out.dtype


def _recorded(name, fn, *args, **kw):
    with cost.CostMode() as mode:
        out = fn(*args, **kw)
    assert set(mode.kernels) == {name}
    k = mode.kernels[name]
    assert k["launches"] == 1
    assert (mode.flops, mode.bytes) == (k["flops"], k["bytes"])
    return out, (k["flops"], k["bytes"])


def test_lut_gemm_meta_paths():
    from repro_torch.core.quant import quantize_weight
    from repro_torch.kernels.lut_gemm import lut_gemm as lg
    gen = torch.Generator().manual_seed(0)
    m, k, n = 8, 64, 48
    w = torch.randn(k, n, generator=gen)
    for x in (torch.randn(m, k, generator=gen),
              torch.randn(m, k, generator=gen).bfloat16()):
        xb = x.element_size()
        q = quantize_weight(w, "lut_dc")
        args = (x, q.codes, q.hi_tab, q.lo_tab, q.zero_point, q.scale)
        out, c = _recorded("lut_gemm_dc", lg.lut_gemm_dc, *_meta(*args))
        _same_layout(out, lg.lut_gemm_dc(*args))
        assert c == cost.lut_gemm_cost(m, k, n, xb, 32)
        q = quantize_weight(w, "nf4_dc", prune_threshold=0.05)
        args = (x, q.codes, q.hi_tab, q.lo_tab, q.residual, q.zero_point,
                q.scale)
        out, c = _recorded("lut_gemm_dc_res", lg.lut_gemm_dc_res,
                           *_meta(*args))
        _same_layout(out, lg.lut_gemm_dc_res(*args))
        assert c == cost.lut_gemm_cost(m, k, n, xb, 96)
        cb = torch.linspace(-1, 1, 16)
        args = (x, q.codes, cb, q.scale)
        out, c = _recorded("lut_gemm", lg.lut_gemm, *_meta(*args))
        _same_layout(out, lg.lut_gemm(*args))
        assert c == cost.lut_gemm_cost(m, k, n, xb, 64, 4)
        assert c[0] == 2 * m * k * n


def test_luna_mm_meta_path():
    from repro_torch.kernels.luna_mm import luna_mm as lm
    gen = torch.Generator().manual_seed(0)
    y = torch.randint(0, 16, (8, 64), generator=gen, dtype=torch.int8)
    w = torch.randint(0, 16, (64, 40), generator=gen, dtype=torch.int8)
    for mode in cost.LUNA_PLANES:
        out, c = _recorded("luna_mm", lm.luna_mm, *_meta(y, w), mode)
        _same_layout(out, lm.luna_mm(y, w, mode))
        assert c == cost.luna_mm_cost(8, 64, 40, mode)


def test_flash_attention_meta_path():
    from repro_torch.kernels.flash_attention import flash_attention as fa
    gen = torch.Generator().manual_seed(0)
    b, h, hkv, s, d = 2, 4, 2, 40, 16
    q = torch.randn(b * h, s, d, generator=gen)
    kv = [torch.randn(b * hkv, s, d, generator=gen) for _ in range(2)]
    kw = dict(sm_scale=0.25, causal=True, num_q_heads=h, num_kv_heads=hkv)
    out, c = _recorded("flash_attention", fa.flash_attention,
                       *_meta(q, *kv), **kw)
    _same_layout(out, fa.flash_attention(q, *kv, **kw))
    assert c == cost.flash_cost(b, s, h, hkv, d, 4, True)
    assert c[0] == 4 * b * h * s * s * d * 0.5


def _ssd_inputs(b=2, s=40, h=4, p=8, g=2, n=16, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return dict(
        x=torch.randn(b, s, h, p, generator=gen),
        dt=torch.rand(b, s, h, generator=gen) * 0.1,
        a=-torch.rand(h, generator=gen),
        b=torch.randn(b, s, g, n, generator=gen),
        c=torch.randn(b, s, g, n, generator=gen))


def test_ssd_scan_meta_paths():
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    t = _ssd_inputs()
    init = torch.randn(2, 4, 8, 16)
    mask = torch.ones(2, 40, dtype=torch.bool)
    for kw in ({}, {"initial_state": init, "mask": mask}):
        args = [t[k] for k in ("x", "dt", "a", "b", "c")]
        mkw = {k: v.to("meta") for k, v in kw.items()}
        out, c = _recorded("ssd_scan", sk.ssd_scan, *_meta(*args), chunk=16,
                           **mkw)
        _same_layout(out, sk.ssd_scan(*args, chunk=16, **kw))
        given = "initial_state" in kw
        assert c == cost.ssd_scan_cost(2, 40, 4, 8, 2, 16, 16, "mask" in kw,
                                       given, given)
        dy = torch.randn(2, 40, 4, 8)
        df = torch.randn(2, 4, 8, 16)
        out, c = _recorded("ssd_scan_bwd", sk.ssd_scan_bwd,
                           *_meta(*args, dy, df), chunk=16, **mkw)
        _same_layout(out, sk.ssd_scan_bwd(*args, dy, df, chunk=16, **kw))
        assert c == cost.ssd_scan_bwd_cost(2, 40, 4, 8, 2, 16, 16,
                                           "mask" in kw, given, given)
    # under autograd: SSDScanFn's forward and backward on meta
    leaves_ = [v.to("meta").requires_grad_(True) for v in t.values()]
    with cost.CostMode() as mode:
        y, final = ops.ssd_chunked_kernel(*leaves_, chunk=16)
        (y.sum() + final.sum()).backward()
    assert {k: v["launches"] for k, v in mode.kernels.items()} == {
        "ssd_scan": 1, "ssd_scan_bwd": 1}
    for leaf in leaves_:
        assert leaf.grad.shape == leaf.shape


def test_dc_formula_gives_the_yi9b_decode_layer_bound():
    """PERF.md §6: a yi-9b decode layer's 7 D&C projections at M = 8 (bf16
    x) are bounded by 0.0522 ms, by bytes."""
    shapes = [(4096, 4096), (4096, 512), (4096, 512), (4096, 4096),
              (4096, 11008), (4096, 11008), (11008, 4096)]
    rows = [troof.bound_ms(*cost.lut_gemm_cost(8, k, n, 2, 32))
            for k, n in shapes]
    assert all(by == "bytes" for _, by in rows)
    assert round(sum(ms for ms, _ in rows), 4) == 0.0522


def test_cost_mode_counts_views_as_free_and_matmuls_by_formula():
    a = torch.empty(64, 32, device="meta")
    b = torch.empty(32, 16, device="meta")
    with cost.CostMode() as mode:
        a.t()
        a.reshape(-1).view(32, 64)
        a.expand(2, 64, 32)
        a.narrow(0, 8, 16)
    assert (mode.flops, mode.bytes) == (0, 0)
    with cost.CostMode() as mode:
        a @ b
    assert mode.flops == 2 * 64 * 32 * 16
    assert mode.bytes == 4 * (64 * 32 + 32 * 16 + 64 * 16)
    with cost.CostMode() as mode:
        torch._int_mm(a.to(torch.int8), b.to(torch.int8))
    assert mode.flops == 2 * 64 * 32 * 16
    with cost.CostMode() as mode:     # a stride-0 operand is read once
        torch.empty(64, 1, device="meta").expand(64, 32) + a
    assert mode.bytes == 4 * (64 + 2 * 64 * 32)
