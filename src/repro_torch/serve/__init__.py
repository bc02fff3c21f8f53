"""Serving engine of the port (mirrors ``repro.serve``): the synchronous
continuous-batching path over a dense KV slab."""
