"""Models of the port (mirrors ``repro.models``)."""
