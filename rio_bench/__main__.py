"""``python3 -m rio_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""

import time

T_START = time.perf_counter()  # set-up is counted from here, before torch loads

import os  # noqa: E402
import sys  # noqa: E402

# A library that would load JAX by itself is kept from doing so.
os.environ.setdefault("USE_FLAX", "0")

from rio_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
