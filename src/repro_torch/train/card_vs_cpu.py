"""Reduced f32 training on the card against the same on the CPU: yi-9b
(:func:`training_card_vs_cpu`), the ssm and hybrid families
(:func:`family_training_card_vs_cpu`: mamba2-1.3b, zamba2-1.2b, the SSD
scan forward and backward on the kernels), one Mamba2 layer
(:func:`mamba2_layer_card_vs_cpu`), and the encdec and vlm families
(:func:`modality_card_vs_cpu`: whisper-base, llava-next-mistral-7b,
training and serving), yi-9b under the quantized training modes
(:func:`quant_training_card_vs_cpu`: ``int8``, ``int4_dequant``,
``lut_nf4``; :func:`nf4_backward_card_vs_plain`: the ``lut_nf4``
backward alone) and under ``remat_policy="dots"``
(:func:`remat_dots_card_vs_cpu`).

``chip_smoke.py`` (phase 4) and ``tests/test_torch_cuda.py`` both run
these checks.  Each raises ``AssertionError`` past its tolerance and
returns what it measured.  Nothing here is bitwise: the embedding's
backward sums with atomics on the card, and cuBLAS and the CPU sum f32
products in other orders.
"""
from __future__ import annotations

from dataclasses import replace

import torch

from repro_torch.core.layers import QuantConfig
from repro_torch.core.lut import NF4_CODEBOOK
from repro_torch.core.quant import ste_luna_matmul
from repro_torch.kernels.lut_gemm.lut_gemm import lut_gemm
from repro_torch.kernels.lut_gemm.ops import NF4MatmulFn, codebook_quantize
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan, ssd_scan_bwd
from repro_torch.configs.base import ShapeConfig
from repro_torch.models.registry import get_config, get_model, input_specs
from repro_torch.optim.adamw import AdamW
from repro_torch.train.train_step import make_train_step
from repro_torch.tree import leaves, tree_map

#: rtol = atol of hidden states, losses and one train step's params
TOL = 1e-4
#: gradients under chunked attention, as a share of each leaf's max |grad|
GRAD_REL = 1e-4
#: the same under luna_approx.  The STE's forward is piecewise constant:
#: an activation within f32 rounding of a code boundary takes the next
#: code on one device and not on the other, moving that row's output by a
#: quantization step.  ``chip_smoke.py`` phase 4 prints the effect beside
#: the same effect of 1e-7 relative weight noise on the CPU alone.
LUNA_GRAD_REL = 1e-3
#: the STE alone on identical inputs, forward and gradients, as a share of
#: each tensor's max |cpu value| (at least 1): f32 sums of 128-512
#: products in another order
STE_REL = 1e-5


def reduced_setup():
    """(cfg, f32 model on the CPU from seed 1, batch of B = 2, S = 256)."""
    cfg = get_config("yi-9b").reduced(dtype="float32", attn_chunk=128)
    cpu = get_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    toks = torch.randint(0, cfg.vocab_size, (2, 257),
                         generator=torch.Generator().manual_seed(2))
    return cfg, cpu, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def model_pair(cpu, cfg, dev):
    """``cpu``'s weights under ``cfg`` on the CPU and on ``dev``, both
    trainable."""
    a = type(cpu).from_params(cfg, cpu.params_tree(), device="cpu")
    b = type(cpu).from_params(
        cfg, tree_map(lambda t: t.to(dev), cpu.params_tree()), device=dev)
    return a.requires_grad_(True), b.requires_grad_(True)


def scaled_grad_err(a, b) -> float:
    """max over leaves of max|b's grad - a's grad| / max|a's grad|."""
    worst = 0.0
    for pa, pb in zip(a.parameters(), b.parameters()):
        scale = max(pa.grad.abs().max().item(), 1e-30)
        worst = max(worst, (pb.grad.cpu() - pa.grad).abs().max().item()
                    / scale)
    return worst


def ste_card_vs_cpu(dev) -> float:
    """``ste_luna_matmul`` (approx_dc) on identical f32 inputs, forward
    (the luna_mm kernel's route on the card) and the straight-through
    gradients; returns the largest error as a share of its tensor's
    scale, held to ``STE_REL``."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 256, 128), generator=gen)
    w = torch.randn((128, 384), generator=gen) / 12
    g = torch.randn((2, 256, 384), generator=gen)
    outs = []
    for d in ("cpu", dev):
        xd = x.to(d, copy=True).requires_grad_()
        wd = w.to(d, copy=True).requires_grad_()
        y = ste_luna_matmul(xd, wd, "approx_dc")
        y.backward(g.to(d))
        outs.append([t.detach().cpu() for t in (y, xd.grad, wd.grad)])
    err = max((tb - ta).abs().max().item() / max(1.0, ta.abs().max().item())
              for ta, tb in zip(*outs))
    assert err <= STE_REL, f"ste_luna_matmul card vs cpu: {err} of scale"
    return err


def training_card_vs_cpu(dev) -> dict:
    """The cacheless forward under attn_impl="flash" (hidden states), the
    loss and every gradient under chunked attention (``GRAD_REL``) and
    under luna_approx through the STE on luna_mm (``LUNA_GRAD_REL``), and
    one train step's params; returns each check's largest error."""
    cfg, cpu, batch = reduced_setup()
    gbatch = {k: t.to(dev) for k, t in batch.items()}
    out = {}
    a, b = model_pair(cpu, replace(cfg, attn_impl="flash"), dev)
    with torch.no_grad():
        ha, _ = a.forward(batch["tokens"])
        hb, _ = b.forward(gbatch["tokens"])
    torch.testing.assert_close(hb.cpu(), ha, rtol=TOL, atol=TOL)
    out["flash forward hidden"] = (hb.cpu() - ha).abs().max().item()
    for name, c, rel in (
            ("chunked", cfg, GRAD_REL),
            ("luna_approx", replace(cfg, quant=QuantConfig(
                mode="luna_approx")), LUNA_GRAD_REL)):
        a, b = model_pair(cpu, c, dev)
        la, _ = a.loss(batch)
        lb, _ = b.loss(gbatch)
        la.backward()
        lb.backward()
        torch.testing.assert_close(lb.detach().cpu(), la.detach(),
                                   rtol=TOL, atol=TOL)
        err = scaled_grad_err(a, b)
        assert err <= rel, (f"{name}: gradients differ by {err} of their "
                            f"leaf's scale (> {rel})")
        out[f"{name} loss"] = abs(lb.item() - la.item())
        out[f"{name} grads (scaled)"] = err
    out["train_step params"] = train_step_err(cpu, cfg, dev, batch, gbatch)
    return out


#: the train step's learning rate (:func:`train_step_err`)
STEP_LR = 1e-3


def train_step_err(cpu, cfg, dev, batch, gbatch, grads=None) -> float:
    """One ``make_train_step`` step (AdamW, lr ``STEP_LR``) from ``cpu``'s
    weights on the CPU and on ``dev``: every param within ``TOL``; returns
    the largest difference.  ``grads``: the CPU's gradients of ``batch``'s
    loss at those weights, one a leaf of ``params_tree()``.  AdamW's first
    step moves an element by ~lr * g / (|g| + eps), so where g lies within
    ``GRAD_REL`` of its leaf's scale from 0 the two devices' f32
    gradients need not agree on it: with ``grads`` given, those elements
    are held to the one-step bound 2 lr (``tests/
    test_torch_train_families.py``'s rule against JAX), the rest to
    ``TOL``."""
    a, b = model_pair(cpu, cfg, dev)
    for m, batch_d in ((a, batch), (b, gbatch)):
        opt = AdamW(lr=STEP_LR)
        make_train_step(cfg, opt)(m, opt.init(m.params_tree()), batch_d)
    err = 0.0
    pairs = zip(leaves(a.params_tree()), leaves(b.params_tree()))
    for i, (pa, pb) in enumerate(pairs):
        got, want = pb.detach().cpu(), pa.detach()
        err = max(err, (got - want).abs().max().item())
        if grads is not None:
            assert (got - want).abs().max().item() <= 2 * STEP_LR
            settled = grads[i].abs() > GRAD_REL * grads[i].abs().max()
            got, want = got[settled], want[settled]
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    return err


#: the families whose SSD scan trains on the kernels (``ssd_scan_tc.cu``
#: forward, ``ssd_scan_bwd.cu`` backward)
SCAN_FAMILIES = ("mamba2-1.3b", "zamba2-1.2b")


def family_training_card_vs_cpu(dev, arch: str) -> dict:
    """Reduced f32 ``arch`` (seed 1; B = 2, S = 96: three of the reduced
    32-position chunks) on the card against the CPU: the loss (``TOL``),
    every gradient (``GRAD_REL`` of its leaf's scale) and one train step's
    params (``TOL``); on the card the scan runs 2 forward launches a
    Mamba2 layer (the forward and remat's recompute) and 1 backward
    launch (a CPU ``dev``, a dry run, launches none).  Returns each check's largest error and the launches."""
    cfg = get_config(arch).reduced(dtype="float32")
    cpu = get_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    toks = torch.randint(0, cfg.vocab_size, (2, 97),
                         generator=torch.Generator().manual_seed(2))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    gbatch = {k: t.to(dev) for k, t in batch.items()}
    a, b = model_pair(cpu, cfg, dev)
    la, _ = a.loss(batch)
    la.backward()
    fwd, bwd = ssd_scan.launches, ssd_scan_bwd.launches
    lb, _ = b.loss(gbatch)
    lb.backward()
    launches = {"ssd_scan": ssd_scan.launches - fwd,
                "ssd_scan_bwd": ssd_scan_bwd.launches - bwd}
    on_card = torch.device(dev).type == "cuda"
    want = {"ssd_scan": 2 * cfg.num_layers * on_card,
            "ssd_scan_bwd": cfg.num_layers * on_card}
    assert launches == want, f"{arch}: launches {launches}, want {want}"
    torch.testing.assert_close(lb.detach().cpu(), la.detach(), rtol=TOL,
                               atol=TOL)
    err = scaled_grad_err(a, b)
    assert err <= GRAD_REL, (f"{arch}: gradients differ by {err} of their "
                             f"leaf's scale (> {GRAD_REL})")
    return {"loss": abs(lb.item() - la.item()), "grads (scaled)": err,
            "launches": launches,
            "train_step params": train_step_err(cpu, cfg, dev, batch, gbatch)}


def mamba2_layer_card_vs_cpu(dev) -> dict:
    """One Mamba2 layer at reduced mamba2-1.3b's widths (f32, seed 1; x of
    (2, 96, 128)): the gradients of ``w_in``, ``A_log`` and ``dt_bias``
    for the same output cotangent on the card (the scan on the kernels)
    and on the CPU, each within ``GRAD_REL`` of its CPU scale; ``A_log``
    and ``dt_bias`` reach the loss only through the scan.  Returns the
    errors."""
    from repro_torch.models.ssm import init_mamba2, mamba2_block, \
        mamba2_shapes
    cfg = get_config("mamba2-1.3b").reduced(dtype="float32")
    p = init_mamba2(torch.Generator().manual_seed(1), {
        name: torch.empty(shape, dtype=dtype)
        for name, (shape, dtype) in mamba2_shapes(cfg).items()})
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((2, 96, cfg.d_model), generator=gen)
    g = torch.randn((2, 96, cfg.d_model), generator=gen)
    grads = []
    for d in ("cpu", dev):
        pd = {k: v.to(d, copy=True).requires_grad_() for k, v in p.items()}
        out, _ = mamba2_block(pd, x.to(d), cfg)
        (out * g.to(d)).sum().backward()
        grads.append({k: pd[k].grad for k in ("w_in", "A_log", "dt_bias")})
    errs = {}
    for k, want in grads[0].items():
        got = grads[1][k].cpu()
        errs[k] = ((got - want).abs().max().item()
                   / max(want.abs().max().item(), 1e-30))
    assert all(e <= GRAD_REL for e in errs.values()), (
        f"one Mamba2 layer's gradients, card vs cpu: {errs} of their "
        f"scale (> {GRAD_REL})")
    return errs


#: the families fed frames or patches besides their tokens
MODALITY_ARCHS = ("whisper-base", "llava-next-mistral-7b")


def modality_batch(cfg, s: int, seed: int, b: int = 2,
                   device="cpu") -> dict:
    """A train batch of ``cfg``'s family in ``input_specs``' shapes for
    (B, S): tokens and labels uniform ids, frames / patches N(0, 1) in
    the model's dtype, from a ``torch.Generator`` on ``device`` seeded
    ``seed`` (``SyntheticLM`` carries no frames or patches)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for k, (shape, dt) in input_specs(
            cfg, ShapeConfig("modality", s, b, "train")).items():
        if dt.is_floating_point:
            out[k] = torch.randn(shape, generator=gen, device=device).to(dt)
        else:
            out[k] = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                                   device=device)
    return out


def modality_card_vs_cpu(dev, arch: str) -> dict:
    """Reduced f32 ``arch`` (seed 1; B = 2, S = 96: whisper's decoder over
    its 64 frames, llava's 16 patches then 80 tokens) on the card against
    the CPU: the loss (``TOL``), every gradient (``GRAD_REL`` of its
    leaf's scale), a 12-token prefill and 4 teacher-forced
    ``decode_step``s (llava's positions count the patches), every call's
    logits within ``TOL``, and one train step's params (``TOL``; 2 lr
    where the gradient is within ``GRAD_REL`` of 0: :func:`
    train_step_err`).  Returns each check's largest error."""
    cfg = get_config(arch).reduced(dtype="float32")
    cpu = get_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    batch = modality_batch(cfg, 96, 2)
    gbatch = {k: t.to(dev) for k, t in batch.items()}
    a, b = model_pair(cpu, cfg, dev)
    la, _ = a.loss(batch)
    lb, _ = b.loss(gbatch)
    la.backward()
    lb.backward()
    torch.testing.assert_close(lb.detach().cpu(), la.detach(), rtol=TOL,
                               atol=TOL)
    err = scaled_grad_err(a, b)
    assert err <= GRAD_REL, (f"{arch}: gradients differ by {err} of their "
                             f"leaf's scale (> {GRAD_REL})")
    out = {"loss": abs(lb.item() - la.item()), "grads (scaled)": err}
    key = "frames" if cfg.family == "encdec" else "patches"
    off = cfg.vlm.num_patches if cfg.vlm else 0
    logits = []
    with torch.no_grad():
        for m, bt in ((a, batch), (b, gbatch)):
            toks = bt["tokens"]
            lg, state = m.prefill(toks[:, :12], m.init_cache(2, off + 20),
                                  **{key: bt[key]})
            calls = [lg]
            for i in range(4):
                lg, state = m.decode_step(toks[:, 12 + i:13 + i], state,
                                          off + 12 + i)
                calls.append(lg)
            logits.append(calls)
    worst = 0.0
    for want, got in zip(*logits):
        torch.testing.assert_close(got.cpu(), want, rtol=TOL, atol=TOL)
        worst = max(worst, (got.cpu() - want).abs().max().item())
    out["prefill + decode logits"] = worst
    # last: the CPU side's step writes into ``cpu``'s tensors, which ``a``
    # shares
    out["train_step params"] = train_step_err(
        cpu, cfg, dev, batch, gbatch,
        grads=[p.grad.clone() for p in leaves(a.params_tree())])
    return out


#: the model-level modes that train through plain autograd or, on the
#: card, ``NF4MatmulFn`` (``lut_nf4``), each with its gradient bound.
#: int8 quantizes the activations dynamically, a piecewise constant
#: forward like the STE's: an activation within f32 rounding of a code
#: boundary takes the next code on one device (``LUNA_GRAD_REL``).  The
#: other two quantize only the weights, whose codes agree bitwise.
QUANT_TRAIN_REL = {"int8": LUNA_GRAD_REL, "int4_dequant": GRAD_REL,
                   "lut_nf4": GRAD_REL}


def quant_training_card_vs_cpu(dev, mode: str) -> dict:
    """Reduced f32 yi-9b (:func:`reduced_setup`) under ``mode`` on the
    card against the CPU: the loss (``TOL``), every gradient
    (``QUANT_TRAIN_REL[mode]`` of its leaf's scale) and one train step's
    params (``TOL``; 2 lr where the gradient is within ``GRAD_REL`` of
    0).  Under lut_nf4 the card runs the LUT GEMM kernel three times a
    projection (the forward, remat's recompute and the backward's dx over
    the transposed codes: ``NF4MatmulFn``).  Returns each check's largest
    error and the launches."""
    cfg, cpu, batch = reduced_setup()
    cfg = replace(cfg, quant=QuantConfig(mode=mode))
    gbatch = {k: t.to(dev) for k, t in batch.items()}
    a, b = model_pair(cpu, cfg, dev)
    la, _ = a.loss(batch)
    la.backward()
    launches, backward = lut_gemm.launches, NF4MatmulFn.backward_launches
    lb, _ = b.loss(gbatch)
    lb.backward()
    got = {"lut_gemm": lut_gemm.launches - launches,
           "lut_gemm backward": NF4MatmulFn.backward_launches - backward}
    per = 7 * cfg.num_layers * (torch.device(dev).type == "cuda"
                                and mode == "lut_nf4")
    want = {"lut_gemm": 3 * per, "lut_gemm backward": per}
    assert got == want, f"{mode}: launches {got}, want {want}"
    torch.testing.assert_close(lb.detach().cpu(), la.detach(), rtol=TOL,
                               atol=TOL)
    err = scaled_grad_err(a, b)
    rel = QUANT_TRAIN_REL[mode]
    assert err <= rel, (f"{mode}: gradients differ by {err} of their "
                        f"leaf's scale (> {rel})")
    return {"loss": abs(lb.item() - la.item()), "grads (scaled)": err,
            "launches": got,
            "train_step params": train_step_err(
                cpu, cfg, dev, batch, gbatch,
                grads=[p.grad.clone() for p in leaves(a.params_tree())])}


def nf4_backward_card_vs_plain(dev, m: int = 96, k: int = 256,
                               n: int = 192, dtype=torch.bfloat16) -> dict:
    """``NF4MatmulFn`` on the card (the LUT GEMM kernel forward and over
    the transposed codes) against the same Function on the CPU (its plain
    version, ``lut_gemm_ref``) on identical inputs: the output, dx and
    d absmax within the kernels' 1e-4 of each tensor's scale (dx, cast to
    x's dtype, also one ulp of that dtype at each element: two f32 values
    1e-6 apart may round to neighbouring bf16 values); the forward
    bitwise the one-launch ``lut_gemm(x, q, CB, absmax)``.  Returns the
    errors as shares of the scale."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((m, k), generator=gen).to(dtype)
    w = torch.randn((k, n), generator=gen) / k ** 0.5
    g = torch.randn((m, n), generator=gen)
    outs = []
    for d in ("cpu", dev):
        xd = x.to(d, copy=True).requires_grad_()
        codes, absmax = codebook_quantize(w.to(d), NF4_CODEBOOK)
        absmax = absmax.detach().requires_grad_()
        y = NF4MatmulFn.apply(xd, codes, absmax)
        if torch.device(d).type == "cuda":
            with torch.no_grad():
                one = lut_gemm(xd, codes, torch.as_tensor(
                    NF4_CODEBOOK, device=d), absmax)
            assert torch.equal(y.detach(), one), (
                "NF4MatmulFn's forward is not the one-launch forward "
                "bitwise")
        y.backward(g.to(d))
        outs.append([t.detach().float().cpu()
                     for t in (y, xd.grad, absmax.grad)])
    errs = {}
    for name, ta, tb in zip(("out", "dx", "d absmax"), *outs):
        scale = max(ta.abs().max().item(), 1e-30)
        ulp = torch.finfo(dtype).eps * ta.abs() if name == "dx" else 0.0
        errs[name] = (tb - ta).abs().max().item() / scale
        assert bool(((tb - ta).abs() <= 1e-4 * scale + ulp).all()), (
            f"NF4MatmulFn card vs plain, {name}: {errs[name]} of its scale")
    return errs


def remat_dots_card_vs_cpu(dev) -> dict:
    """Reduced f32 yi-9b under ``remat_policy="dots"`` on the card
    against the CPU (the loss at ``TOL``, every gradient at ``GRAD_REL``)
    and against ``"nothing"`` on the card (the largest gradient
    difference, as a share of its leaf's scale, held to ``GRAD_REL``;
    bitwise where the card's kernels are deterministic).  Returns the
    errors."""
    cfg, cpu, batch = reduced_setup()
    gbatch = {k: t.to(dev) for k, t in batch.items()}
    dots = replace(cfg, remat_policy="dots")
    a, b = model_pair(cpu, dots, dev)
    _, c = model_pair(cpu, cfg, dev)
    for m, bt in ((a, batch), (b, gbatch), (c, gbatch)):
        m.loss(bt)[0].backward()
    out = {"dots grads vs cpu (scaled)": scaled_grad_err(a, b),
           "dots vs nothing on the card (scaled)": max(
               ((pb.grad - pc.grad).abs().max()
                / pc.grad.abs().max().clamp_min(1e-30)).item()
               for pb, pc in zip(b.parameters(), c.parameters())),
           "bitwise leaves": sum(torch.equal(pb.grad, pc.grad) for pb, pc in
                                 zip(b.parameters(), c.parameters())),
           "leaves": sum(1 for _ in b.parameters())}
    for k in ("dots grads vs cpu (scaled)",
              "dots vs nothing on the card (scaled)"):
        assert out[k] <= GRAD_REL, f"remat dots: {k} {out[k]} > {GRAD_REL}"
    return out
