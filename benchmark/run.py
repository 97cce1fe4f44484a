"""Runs one cell of the port's benchmark once (see BENCHMARK.json):

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result, as one JSON object; the checks, each number beside its limit, are
the last lines of standard error. It exits with 2 and prints no result
where the card is missing, the JAX package or JAX was loaded, or the run
failed.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the program's and the toolchains' build caches stay inside the checkout,
# at fixed paths, so only a checkout's first run builds
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".bench_cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, ".bench_cache",
                                                  "torch_extensions")
sys.path[0] = ROOT

from benchmark.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
