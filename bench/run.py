"""Benchmark of the PyTorch and CUDA port (``src/repro_torch``): one run of
one cell.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's NVIDIA
cards; there is no CPU fallback. The port's kernel library builds into
``build/kernels/<hash>/`` of the checkout on the first run there; the
PyTorch extension and Triton caches are pinned inside ``build/`` too.
The last line of standard output is the run's JSON result.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
# one host thread for the BLAS and OpenMP pools: the program's host work
# is one Python thread, and idle pool threads only add noise
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench.lib import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
