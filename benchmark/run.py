"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. With ``--trace 0`` the last line of standard output is the result
with the cell's end-to-end metrics; with ``--trace 1`` with its per-layer
metrics, a ``breakdown`` and the device's busy time. Either way the run
ends by comparing one sample of the window with the plain reference
(``benchmark/reference/``) and prints each number compared beside its
limit, as the last lines of standard error and under ``checks`` in the
result. Without a card the run exits 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # build and kernel caches at fixed paths inside the checkout
    cache = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_ext")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    return harness.run(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
