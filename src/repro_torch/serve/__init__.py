"""Serving engine of the port (mirrors ``repro.serve``): continuous
batching over a dense KV slab, a paged block pool or recurrent state, the
request lifecycle and background loop, and speculative decoding."""
