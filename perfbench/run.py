"""Run one cell of the benchmark of ``repro_torch`` once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. It puts the checkout's root and ``src`` on
``sys.path`` itself, keeps every build and kernel cache inside the
checkout, and prints the result's JSON object as the last line of its
standard output (see ``perfbench/harness.py``). It exits non-zero, with
no result, without a CUDA device or without the program's sources.
"""
import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)
CACHE = os.path.join(ROOT, ".perfbench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
# Python's bytecode of every module the run imports (torch's, the
# program's) is read and written here too: where the installation keeps
# none, each process would compile some two thousand sources in set-up.
sys.pycache_prefix = os.path.join(CACHE, "pycache")
sys.dont_write_bytecode = False
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

if __name__ == "__main__":
    from perfbench.harness import main
    sys.exit(main(t0=T0))
