"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one command
runs one cell once (``python3 perfbench/run.py --workload <name> ...``);
``BENCHMARK.json`` at the repository's root names the cells, and each
configuration, traffic mix and metric is a file of its own here."""
