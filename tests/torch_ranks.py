"""Rank processes of the port's gloo tests (``test_torch_decode_attention``,
``test_torch_collectives``): imports torch, numpy and the port, never jax.

    python tests/torch_ranks.py JOB DIR

starts ``WORLD`` (4) processes from one spawn context; each pins torch to
one intra-op thread, joins a gloo group through ``file://DIR/rdv`` (no
TCP port to collide across test workers) with a timeout, so a rank that
misses a collective fails instead of hanging, runs ``JOBS[JOB](rank,
DIR)`` on ``DIR/in.pkl`` and writes its result to ``DIR/out_<rank>.pkl``.
The launcher exits nonzero if any rank does; the caller bounds it with a
subprocess timeout.  The pickles are written and read by these tests
only.
"""
from __future__ import annotations

import datetime
import os
import pickle
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
#: a collective that waits longer than this fails the rank
GROUP_TIMEOUT_S = 60
#: the launcher's wait for its ranks
JOIN_TIMEOUT_S = 240


def _inputs(workdir: str) -> dict:
    with open(os.path.join(workdir, "in.pkl"), "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# job: sharded decode (test_torch_decode_attention)
# ---------------------------------------------------------------------------

def run_case(model, toks, case: dict, mesh) -> dict:
    """One case of the decode job on this rank: the port's prefill (whole,
    no mesh) when ``case["prefill"]``, :func:`shard_cache`, then
    ``case["steps"]`` teacher-forced decode steps under
    ``activation_sharding(mesh)``.  Returns the rank's rows, their logits
    (steps, rows, V) as f32 numpy, and the sharded calls and all-reduces
    the steps made."""
    import numpy as np
    import torch

    from repro_torch.models.common import CacheSpec
    from repro_torch.parallel.act_sharding import activation_sharding
    from repro_torch.serve import decode_attention as da

    b = toks.shape[0]
    pool = case["cache"] == "pool"
    p0 = case["prefill"]
    if pool:
        rows = list(range(b))
        state = model.init_cache(b, case["s_max"],
                                 spec=CacheSpec(*case["spec"]))
        tables = torch.tensor(case["tables"])
    else:
        data = mesh.shape["data"]
        d = mesh.coords["data"]
        rows = list(range(d * b // data, (d + 1) * b // data))
        state = model.init_cache(b, case["s_max"])
        tables = None
    with torch.no_grad():
        if p0:
            _, state = model.prefill(torch.as_tensor(toks[:, :p0]), state)
        state = da.shard_cache(state, mesh, paged=pool)
        calls0 = da.sharded_gqa_decode.calls + da.sharded_mla_decode.calls
        reduces0 = da.all_reduce.calls
        seq = []
        with activation_sharding(mesh):
            for i in range(case["steps"]):
                pos = p0 + i
                if case["index"] == "rows":
                    idx = torch.tensor([pos + o for o in case["offsets"]])
                    idx = idx[rows]
                else:
                    idx = pos
                tok = torch.as_tensor(toks[rows, pos:pos + 1])
                lg, state = model.decode_step(tok, state, idx, tables=tables)
                seq.append(lg[:, 0].float().numpy())
    return {"rows": rows, "logits": np.stack(seq),
            "calls": (da.sharded_gqa_decode.calls
                      + da.sharded_mla_decode.calls - calls0),
            "all_reduces": da.all_reduce.calls - reduces0}


def decode_job(rank: int, workdir: str) -> dict:
    """Every case of ``in.pkl`` on its meshes, and the control: the first
    (2, 2) case rerun with the model group replaced by the world's."""
    import copy
    from dataclasses import replace

    import torch.distributed as dist

    from repro_torch.bridge import params_from_numpy
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.registry import get_config

    job = _inputs(workdir)
    meshes = {tuple(s): Mesh(tuple(s), ("data", "model"))
              for s in job["meshes"]}
    out = {"mesh": {s: {"coords": m.coords, "groups": {
        a: dist.get_process_group_ranks(g) for a, g in m.groups.items()}}
        for s, m in meshes.items()}, "cases": {}}
    for case in job["cases"]:
        arch, dtype = job["archs"][case["arch"]]
        cfg = replace(get_config(arch).reduced(dtype=dtype,
                                               attn_impl="full"),
                      decode_attn="sharded",
                      decode_attn_precision=case["precision"])
        model = params_from_numpy(job["params"][case["arch"]], cfg, "cpu")
        toks = job["tokens"][case["arch"]]
        for s in case["meshes"]:
            out["cases"][(tuple(s), case["name"])] = run_case(
                model, toks, case, meshes[tuple(s)])
        if case["name"] == job["control"]:
            bad = copy.copy(meshes[(2, 2)])
            bad.groups = dict(bad.groups, model=None)   # the whole world
            out["control"] = run_case(model, toks, case, bad)
    out["attn"] = {form: attention_case(job, meshes[tuple(job["attn"][
        "mesh"])], grouped) for form, grouped in job["attn"]["forms"].items()}
    return out


def attention_case(job: dict, mesh, grouped: bool) -> dict:
    """``sharded_gqa_decode`` alone over this rank's shard of a zero bf16
    slab: ``in.pkl``'s f32 queries and bf16 new K/V, one step each at
    index 0, 1, ...  Returns the rank's rows and its (steps, rows, 1, H,
    dh) outputs."""
    import numpy as np
    import torch

    from repro_torch.models.attention import KVCache
    from repro_torch.serve import decode_attention as da

    a, x = job["attn"], job["attn_inputs"]
    kc = torch.zeros(a["b"], a["s"], a["hkv"], a["dh"], dtype=torch.bfloat16)
    cache = da.shard_cache(KVCache(kc, kc.clone()), mesh)
    rows = list(range(a["b"]))       # mesh (1, 4): one data coordinate
    seq = []
    for i in range(len(x["q"])):
        out, _, _ = da.sharded_gqa_decode(
            torch.from_numpy(x["q"][i]), cache.k, cache.v,
            torch.from_numpy(x["k"][i]).to(torch.bfloat16),
            torch.from_numpy(x["v"][i]).to(torch.bfloat16), i, mesh,
            sm_scale=x["sm_scale"], grouped_bf16=grouped)
        seq.append(out.numpy())
    return {"rows": rows, "logits": np.stack(seq)}


# ---------------------------------------------------------------------------
# job: collectives (test_torch_collectives)
# ---------------------------------------------------------------------------

def collectives_job(rank: int, workdir: str) -> dict:
    """``quantized_psum`` of this rank's row of ``in.pkl``'s x over the
    world and over a (2, 2) mesh's data group, and the production mesh's
    refusal of a 4-rank world."""
    import torch

    from repro_torch.launch.mesh import Mesh, make_production_mesh
    from repro_torch.parallel.collectives import quantized_psum

    x = torch.from_numpy(_inputs(workdir)["x"][rank])
    mesh = Mesh((2, 2), ("data", "model"))
    try:
        make_production_mesh()
        refused = None
    except ValueError as e:
        refused = str(e)
    return {"world": quantized_psum(x).numpy(),
            "data": quantized_psum(x, mesh.groups["data"]).numpy(),
            "coords": mesh.coords, "production_refused": refused}


JOBS = {"decode": decode_job, "collectives": collectives_job}


def _rank(job: str, workdir: str, rank: int) -> None:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{workdir}/rdv", world_size=WORLD,
        rank=rank, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        out = JOBS[job](rank, workdir)
        with open(os.path.join(workdir, f"out_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def main(job: str, workdir: str) -> int:
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(job, workdir, r))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        print(f"rank exit codes {codes}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
