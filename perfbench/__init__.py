"""The benchmark of the PyTorch/CUDA port (``repro_torch``): see
``perfbench/run.py`` and ``PERF.md``."""
