"""Core numerics of the port: LUT machinery and the 4-bit quantizers
(mirrors ``repro.core``)."""
