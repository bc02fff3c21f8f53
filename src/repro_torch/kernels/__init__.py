"""Hand-written Hopper kernels of the port (mirrors ``repro.kernels``).

Each kernel package holds the wrapper (``<name>.py``), its plain PyTorch
version (``ref.py``), the dispatch (``ops.py``) and the CUDA source under
``csrc/``, built by :mod:`repro_torch.kernels._build` on first use.
"""
