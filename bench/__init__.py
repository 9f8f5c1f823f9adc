"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one command runs
one cell once (``python3 bench/run.py --workload <cell> ...``).  See
``bench/README.md``."""
