"""One run of one cell of the benchmark of the PyTorch and CUDA port.

    python3 cudabench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with the cell's CUDA devices.
The last line of standard output is the result (``harness.py``).  Triton's
cache and the port's nvcc outputs stay in the checkout, under
``build/osga_torch_kernels/``, so only a cell's first run there compiles.
"""

import time

T_PROCESS = time.perf_counter()  # setup_s counts from here: before any heavy import

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "osga_torch_kernels" / "triton")
sys.path.insert(0, str(ROOT))

from cudabench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_process=T_PROCESS))
