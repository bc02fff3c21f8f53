"""Serving CLI of the port: batched requests through the engine.

  # reduced yi-9b (the default), on the card:
  PYTHONPATH=src python -m repro_torch.launch.serve --quant lut4

  # full-width yi-9b (48 layers, bf16):
  PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced --quant lut4

  # on the CPU (plain PyTorch versions of the kernels):
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --quant nf4p

  # mamba2-1.3b (ssm family; prefill on the ssd_scan kernel on the card):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \
      --no-reduced --quant lut4

  # the paper's LUNA multiplier on every projection (model-level):
  PYTHONPATH=src python -m repro_torch.launch.serve --quant luna_approx2

  # the cache substrate: paged KV, chunked prefill, the prefix cache
  # (--shared-prefix gives every prompt the same head, so it has hits):
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --paged --block-size 8 --prefill-chunk 16 --prefix-cache \
      --shared-prefix 24 --quant lut4
  # mamba2 caches state snapshots (no --paged):
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch mamba2-1.3b --prefill-chunk 16 --prefix-cache --shared-prefix 24

  # speculative decoding (greedy-only): nf4p LUT drafts, the decode
  # precision verifies; or prompt-lookup drafts (--spec ngram):
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --quant lut4 --spec self_lut --spec-k 4

  # observability: Perfetto trace, Prometheus dump, a scrape endpoint:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --trace-out trace.json --metrics-dump metrics.txt --metrics-port 0

``--arch`` is ``yi-9b`` or ``mamba2-1.3b``.  Weights are random, drawn
from ``--seed``.  ``--quant lut4|int4|nf4|nf4p`` freezes the decode
projections (mamba2: ``w_in``/``w_out``) to 4 bits (lut4 and nf4/nf4p run the
hand-written LUT GEMM kernels on the card); prefill stays full precision.
Any other spelling but bf16 (``luna_*``, ``lut_nf4``, ``int8``,
``int4_dequant``) is a model-level mode that quantizes every projection
dynamically (``luna_*`` on the card run the LUNA GEMM kernel, ``lut_nf4``
the full-table LUT GEMM).  A prompt is ``--shared-prefix`` tokens common
to every request (0 by default) and 6 of its own.

The CLI serves from the BACKGROUND LOOP by default (``engine.start()``,
one ``submit()`` per request, streams consumed on client threads,
``engine.stop()`` drains), as JAX's does; ``--sync`` keeps the
caller-pumped ``engine.serve(requests)``.  ``--metrics-port`` serves the
engine's registry as a Prometheus scrape endpoint while the run lasts,
``--metrics-dump PATH`` writes the text exposition on exit and
``--trace-out PATH`` records request-lifecycle spans and writes Perfetto
JSON on exit.  Prints each request's tokens and the run's stats.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    from repro_torch.serve.config import EngineConfig, model_quant

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True, help="smoke-test widths (--no-reduced: "
                                       "the published widths)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="tokens every prompt starts with (prefix-cache "
                         "hits)")
    ap.add_argument("--sync", action="store_true",
                    help="caller-pumped engine.serve() instead of the "
                         "background serve loop")
    EngineConfig.add_cli_args(ap)
    ap.set_defaults(max_batch=4, max_seq=128)
    args = ap.parse_args(argv)

    from dataclasses import replace

    import numpy as np
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.serve.engine import Engine, Request

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    qcfg = model_quant(args.quant)
    if qcfg is not None:
        cfg = replace(cfg, quant=qcfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = get_model(cfg, device=device).init(gen)
    engine = Engine(cfg, model, EngineConfig.from_args(args), device=device)
    metrics_server = None
    if args.metrics_port is not None:
        from repro_torch.obs import start_metrics_server
        metrics_server = start_metrics_server(engine.registry,
                                              args.metrics_port)
        print(f"metrics: http://127.0.0.1:"
              f"{metrics_server.server_address[1]}/metrics")
    rng = np.random.default_rng(args.seed)
    head = rng.integers(1, cfg.vocab_size, args.shared_prefix).tolist()
    reqs = [Request(rid=i, prompt=head + rng.integers(
        1, cfg.vocab_size, 6).tolist(), max_new=args.max_new)
        for i in range(args.requests)]
    if args.sync:
        stats = engine.serve(reqs)
    else:
        from concurrent.futures import ThreadPoolExecutor

        start = engine.metrics.snapshot()
        t0 = engine.clock()
        engine.start()
        handles = [engine.submit(r) for r in reqs]
        with ThreadPoolExecutor(max_workers=min(8, len(handles))) as pool:
            streams = list(pool.map(lambda h: list(h.tokens()), handles))
        engine.stop()
        for r, s in zip(reqs, streams):
            assert s == r.out, f"rid {r.rid}: stream diverged from out"
        stats = engine.metrics.since(start).summary(engine.max_batch)
        stats.update({"wall_s": engine.clock() - t0,
                      "done": all(r.done for r in reqs)})
    for r in reqs:
        print(f"rid {r.rid}: {r.out}")
    tok_count = sum(len(r.out) for r in reqs)
    print(f"{cfg.name} x{cfg.num_layers} layers on {device}, quant "
          f"{args.quant or 'bf16'}: {tok_count} "
          f"tokens over {len(reqs)} requests, {stats['wall_s']:.2f}s wall, "
          f"done={stats['done']}")
    print(f"  prefill: {stats['prefill_tokens']} tok in "
          f"{stats['prefill_s']:.2f}s ({stats['prefill_tok_s']:.0f} tok/s, "
          f"{stats['prefill_calls']} calls, {stats['prefill_chunks']} "
          f"chunks)")
    print(f"  decode:  {stats['decode_tokens']} tok in "
          f"{stats['decode_s']:.2f}s ({stats['decode_tok_s']:.0f} tok/s, "
          f"occupancy {stats['occupancy']:.0%})")
    if args.prefix_cache:
        print(f"  prefix:  {stats['prefix_hits']} hits, "
              f"{stats['prefix_tokens_reused']} tok reused, "
              f"{stats['cache_evictions']} evictions")
    if args.spec:
        print(f"  spec:    {args.spec}, {stats['spec_ticks']} ticks, "
              f"{stats['spec_accepted']} of {stats['spec_drafted']} drafts "
              f"accepted ({stats['spec_acceptance']:.0%})")
    print(f"  lifecycle: {stats['cancelled']} cancelled, "
          f"{stats['preemptions']} preempted")
    print(f"  deadlines: {stats['deadline_hits']} hit, "
          f"{stats['deadline_misses']} missed")
    if metrics_server is not None:
        metrics_server.shutdown()
    if args.metrics_dump:
        from repro_torch.obs import dump_metrics
        dump_metrics(engine.registry, args.metrics_dump)
        print(f"metrics dump: {args.metrics_dump}")
    if args.trace_out:
        from repro_torch.obs import dump_trace
        dump_trace(engine.tracer, args.trace_out)
        print(f"trace: {args.trace_out} "
              f"({len(engine.tracer.events())} events, "
              f"{engine.tracer.dropped} dropped)")
    return stats


if __name__ == "__main__":
    main()
