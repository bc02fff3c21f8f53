"""EngineConfig: the serving knobs in one validated dataclass (mirrors
``repro.serve.config``), with the shared argparse binding.

Every knob of JAX's config is here and means the same: the substrate (a
dense slab or a paged block pool for the dense family, dense recurrent
state for ssm), chunked prefill, the prefix cache, the background loop's
idle backoff, request tracing and speculative decoding (greedy-only).
:meth:`EngineConfig.validate` raises ``NotImplementedError`` naming
ROADMAP queue 1 item 7 for a family the port does not serve yet.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace

from repro_torch.serve.sampling import SamplingConfig

#: engine-level decode quantization modes (EngineConfig.quant): the affine
#: pair lut4 (D&C sub-table LUT) / int4 (direct dequant) and the NF4 pair
#: nf4 (D&C + full residual) / nf4p (residual pruned).
ENGINE_QUANT_MODES = ("lut4", "int4", "nf4", "nf4p")


def model_quant(quant: str | None):
    """The model-level ``QuantConfig`` a ``--quant`` spelling names, or None
    for an engine-level mode, ``bf16`` or unset (JAX's launcher rule: any
    spelling but bf16 and the engine modes quantizes the model)."""
    if quant in (None, "bf16", *ENGINE_QUANT_MODES):
        return None
    from repro_torch.core.layers import QuantConfig
    return QuantConfig(mode=quant)


#: speculative-decoding draft proposers (EngineConfig.spec): "ngram"
#: prompt-lookup drafting (no extra weights), "self_lut" self-speculation
#: (the same model over pruned-LUT ``nf4p`` weights drafts, the decode
#: precision verifies); see ``repro_torch.serve.spec``
ENGINE_SPEC_MODES = ("ngram", "self_lut")


@dataclass(frozen=True)
class EngineConfig:
    """* ``max_batch`` / ``max_seq`` — slot count and per-slot token budget.
    * ``prefill_bucket`` — prompt lengths are padded up to multiples of
      this; one prefill call per bucket.
    * ``sampling`` / ``seed`` — sampling mode (None = greedy) and seed.
    * ``starvation_bound`` — scheduler aging threshold (see
      ``repro_torch.serve.engine.Scheduler``).
    * ``paged`` / ``block_size`` / ``num_blocks`` — paged KV: the cache
      is a pool of ``num_blocks`` (default: the dense-equivalent capacity
      plus the reserved garbage block) ``block_size``-token blocks, and
      admission reserves only the blocks a request's prompt and
      generation need (attention families).
    * ``prefill_chunk`` — prompts longer than this are admitted in
      pieces of this many tokens, one piece a tick between decode ticks.
    * ``prefix_cache`` / ``prefix_cache_nodes`` — a radix tree over
      prompt tokens: warm admissions reuse cached KV blocks (attention,
      needs ``paged``) or recurrent state snapshots (ssm) and prefill
      only the uncached tail; the tree keeps at most
      ``prefix_cache_nodes`` boundaries (LRU).
    * ``quant`` — decode weight quantization (``ENGINE_QUANT_MODES``);
      prefill always runs full precision; None keeps full-precision decode.
    * ``idle_backoff_s`` — the background serve loop (``engine.start()``)
      sleeps this long when there is no work before re-checking (a
      ``submit()``/``cancel()`` wakes it at once).
    * ``trace`` / ``trace_buffer`` — record clock-stamped request and
      engine-phase events (``repro_torch.obs``) into a ring buffer of
      ``trace_buffer`` events, exportable as Perfetto JSON.
    * ``spec`` / ``spec_k`` — speculative decoding: each tick drafts up to
      ``spec_k`` tokens per active request (``ENGINE_SPEC_MODES``),
      scores the whole window in one verify call at the decode precision,
      emits the accepted prefix plus the verifier's correction and rolls
      back the rest.  Greedy-only: the tokens equal plain greedy decode's.
    """
    max_batch: int = 8
    max_seq: int = 256
    prefill_bucket: int = 16
    paged: bool = False
    block_size: int = 16
    num_blocks: int | None = None
    prefill_chunk: int | None = None
    prefix_cache: bool = False
    prefix_cache_nodes: int = 256
    sampling: SamplingConfig | None = None
    seed: int = 0
    starvation_bound: int = 8
    quant: str | None = None
    idle_backoff_s: float = 0.002
    trace: bool = False
    trace_buffer: int = 65536
    spec: str | None = None
    spec_k: int = 4

    def __post_init__(self):
        if self.quant is not None and self.quant not in ENGINE_QUANT_MODES:
            raise ValueError(
                f"quant must be one of {ENGINE_QUANT_MODES} or None, "
                f"got {self.quant!r}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_seq < 2:
            raise ValueError(f"max_seq must be >= 2 (one prompt token + one "
                             f"generated), got {self.max_seq}")
        if self.prefill_bucket < 1:
            raise ValueError(f"prefill_bucket must be >= 1, "
                             f"got {self.prefill_bucket}")
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, "
                             f"got {self.prefill_chunk}")
        if self.paged and self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, "
                             f"got {self.block_size}")
        if self.prefix_cache and self.prefix_cache_nodes < 1:
            raise ValueError(f"prefix_cache_nodes must be >= 1, "
                             f"got {self.prefix_cache_nodes}")
        if self.starvation_bound < 1:
            raise ValueError(f"starvation_bound must be >= 1, "
                             f"got {self.starvation_bound}")
        if self.idle_backoff_s < 0:
            raise ValueError(f"idle_backoff_s must be >= 0, "
                             f"got {self.idle_backoff_s}")
        if self.trace_buffer < 1:
            raise ValueError(f"trace_buffer must be >= 1, "
                             f"got {self.trace_buffer}")
        if self.spec is not None and self.spec not in ENGINE_SPEC_MODES:
            raise ValueError(
                f"spec must be one of {ENGINE_SPEC_MODES} or None, "
                f"got {self.spec!r}")
        if self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {self.spec_k}")
        if self.spec is not None and self.sampling is not None \
                and self.sampling.mode != "greedy":
            raise ValueError(
                "speculative decoding is greedy-only (acceptance is pinned "
                "token-identical to non-speculative greedy argmax); got "
                f"spec={self.spec!r} with sampling mode "
                f"{self.sampling.mode!r}")

    def validate(self, family: str) -> None:
        """Every family-dependent rule, in one place (JAX's cross-rules
        over the families the port serves)."""
        from repro_torch.serve.backend import PAGED_FAMILIES, SERVED_FAMILIES
        if family not in SERVED_FAMILIES:
            raise NotImplementedError(
                f"serving family {family!r} is not ported yet: ROADMAP "
                "queue 1 item 7")
        if self.paged and family not in PAGED_FAMILIES:
            raise ValueError(
                f"paged=True is not supported for family {family!r}: "
                "its cache is O(1) recurrent state per slot with no KV "
                f"leaves to page (paged families: {PAGED_FAMILIES})")
        if self.prefix_cache and family in PAGED_FAMILIES and not self.paged:
            raise ValueError(
                f"prefix_cache for family {family!r} shares its "
                "attention KV as copy-on-write paged blocks: construct "
                "with paged=True (the ssm family caches dense state "
                "snapshots and needs no paging)")

    # --- CLI binding ----------------------------------------------------
    @staticmethod
    def add_cli_args(ap) -> None:
        """Register the engine flags on an argparse parser."""
        ap.add_argument("--max-batch", type=int, default=None,
                        help="concurrent sequence slots")
        ap.add_argument("--max-seq", type=int, default=None,
                        help="per-slot token budget (prompt + generation)")
        ap.add_argument("--prefill-bucket", type=int, default=None,
                        help="prompt lengths are padded up to multiples of "
                             "this and prefilled one call per bucket")
        ap.add_argument("--paged", action="store_true",
                        help="paged-block KV cache: per-request block "
                             "reservation instead of full max-seq rows "
                             "(attention families)")
        ap.add_argument("--block-size", type=int, default=None,
                        help="tokens per KV block in --paged mode")
        ap.add_argument("--num-blocks", type=int, default=None,
                        help="pool size in blocks (default: dense-equivalent "
                             "capacity + the reserved garbage block)")
        ap.add_argument("--prefill-chunk", type=int, default=None,
                        help="admit prompts longer than this in N-token "
                             "chunks interleaved with decode ticks")
        ap.add_argument("--prefix-cache", action="store_true",
                        help="radix-tree prompt-prefix sharing: warm "
                             "admissions reuse cached KV blocks (attention, "
                             "needs --paged) or recurrent state snapshots "
                             "(ssm) and prefill only the uncached tail")
        ap.add_argument("--prefix-cache-nodes", type=int, default=None,
                        help="LRU budget for cached prefix boundaries")
        ap.add_argument("--idle-backoff-s", type=float, default=None,
                        help="background serve loop: idle sleep between "
                             "re-checks when no work is pending")
        ap.add_argument("--trace", action="store_true",
                        help="record request-lifecycle + engine-phase trace "
                             "events (ring-buffered; export with "
                             "--trace-out)")
        ap.add_argument("--trace-buffer", type=int, default=None,
                        help="trace ring-buffer capacity in events "
                             "(oldest dropped on overflow)")
        ap.add_argument("--trace-out", default=None, metavar="PATH",
                        help="write the trace as Perfetto/Chrome "
                             "trace_event JSON on exit (implies --trace)")
        ap.add_argument("--metrics-port", type=int, default=None,
                        help="serve the metrics registry at "
                             "http://127.0.0.1:PORT/metrics (Prometheus "
                             "text exposition) from a background thread")
        ap.add_argument("--metrics-dump", default=None, metavar="PATH",
                        help="write the Prometheus text exposition to PATH "
                             "on exit")
        ap.add_argument("--spec", default=None,
                        choices=list(ENGINE_SPEC_MODES),
                        help="speculative decoding draft proposer: 'ngram' "
                             "(prompt-lookup, no extra weights) or "
                             "'self_lut' (the same model over pruned nf4p "
                             "LUT weights drafts, the decode precision "
                             "verifies); greedy-only")
        ap.add_argument("--spec-k", type=int, default=None,
                        help="max draft tokens per request per tick "
                             "(speculation window = spec_k + 1)")
        ap.add_argument("--sampling", default="greedy",
                        choices=["greedy", "temperature", "top_k"])
        ap.add_argument("--temperature", type=float, default=1.0)
        ap.add_argument("--top-k", type=int, default=40)
        ap.add_argument("--seed", type=int, default=0)
        ap.add_argument("--quant", default=None,
                        help="weight quantization.  Engine-level (frozen "
                             "4-bit decode weights, prefill full precision): "
                             "lut4 (D&C sub-table LUT gemm), int4 (direct "
                             "dequant), nf4 (NF4 codebook, D&C + residual), "
                             "nf4p (pruned residual).  Model-level (every "
                             "projection, dynamically, prefill and decode): "
                             "int8, int4_dequant, lut_nf4, "
                             "luna_conventional, luna_dc, luna_approx, "
                             "luna_approx2.  bf16 or unset = none")

    @classmethod
    def from_args(cls, args, **overrides) -> "EngineConfig":
        """Build a config from a namespace of :meth:`add_cli_args`;
        ``overrides`` win, flags left at None/False keep the defaults.
        ``--quant`` reaches ``quant`` only for engine modes; a model-level
        spelling is the caller's to route into ``cfg.quant`` (see
        :func:`model_quant`)."""
        vals = {}
        for f in fields(cls):
            if f.name in ("sampling", "quant"):
                continue
            v = getattr(args, f.name, None)
            if v is not None and v is not False:
                vals[f.name] = v
        q = getattr(args, "quant", None)
        if q in ENGINE_QUANT_MODES:
            vals["quant"] = q
        if getattr(args, "trace_out", None):
            vals["trace"] = True       # a trace sink implies recording
        mode = getattr(args, "sampling", "greedy")
        vals["sampling"] = SamplingConfig(
            mode=mode, temperature=getattr(args, "temperature", 1.0),
            top_k=getattr(args, "top_k", 0) if mode == "top_k" else 0)
        vals.update(overrides)
        return replace(cls(), **vals)
