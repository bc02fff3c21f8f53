"""SSD chunk scan: the mamba2 prefill's state-space scan."""
