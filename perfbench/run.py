"""The benchmark's command: run one cell once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the program (``src/``).  The
program's kernel build cache and every other cache stay inside the
checkout, at fixed paths under ``build/``.
"""
import os
import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(root, "build", "cache", sub)
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [root, os.path.join(root, "src")]
    from perfbench.harness import main
    sys.exit(main(t_start=T_START))
