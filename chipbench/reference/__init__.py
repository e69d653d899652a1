"""Plain PyTorch reference of the benchmark's models, independent of the
program: it imports nothing of ``repro_torch`` (nor ``repro`` or JAX) and
takes nothing the program made, only the benchmark's own seeded weights
and batches."""
