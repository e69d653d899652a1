"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on NVIDIA
GPUs: ``python3 chipbench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``, cells and metrics listed in ``BENCHMARK.json``."""
