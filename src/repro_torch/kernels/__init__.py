"""Hand-written Hopper kernels, one package each: the wrapper (``<name>.py``,
which launches the CUDA source in ``repro_torch/csrc/``) beside its plain
PyTorch version (``ref.py``)."""
