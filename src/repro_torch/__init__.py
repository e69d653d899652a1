"""PyTorch and CUDA port of the FAST/FLASH reproduction (``repro``).

The modules mirror ``src/repro/`` so each one's counterpart is easy to find.
The host side (``configs/``, ``core/``, ``data/``, ``serving/``,
``analysis/locks.py`` and ``analysis/planlint.py``) is a byte-identical
copy of the reference's; the device side (``comm/``,
``kernels/``, ``models/``, ``launch/``) is PyTorch, with hand-written CUDA
kernels for Hopper under ``csrc/``.  Nothing here imports ``jax`` or
``repro``.
"""
