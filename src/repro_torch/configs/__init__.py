"""Model configs of the port (mirrors ``repro.configs``)."""
