"""Run one cell of the port's benchmark once, on the CUDA card.

    python3 dfl_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object (correct, attempted, failed, metrics, device[, breakdown],
tf32, checks); the last lines of standard error give each number compared
beside its limit.  Without a CUDA card it exits with 2 and prints no
result.  See `dfl_bench/harness.py`.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Caches the run may fill live at fixed paths inside the checkout.
CACHE = ROOT / "dfl_bench" / "out" / "cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_TF"] = "0"
sys.path[0] = str(ROOT)                 # not this folder: run as a package
sys.path.insert(1, str(ROOT / "src"))

from dfl_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
