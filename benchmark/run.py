"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
    python -m benchmark.run ...   (the same, from the checkout's root)

The cell, its configuration, its traffic and its metrics are found by name
from `BENCHMARK.json` (see `benchmark/harness.py`). The last line of
standard output is one JSON object: `correct`, `attempted`, `failed`,
`metrics`, `device` and, with `--trace 1`, `breakdown`, then `compared`:
each number held against the reference beside its limit.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

if __name__ == "__main__":
    # the process's own start, before the interpreter imported anything
    START = time.perf_counter()
    # every build and kernel cache inside the checkout, at fixed paths, so
    # that only a cell's first run there builds; transformers, where a
    # library pulls it in, stays off JAX
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / ".cache" / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark.harness import main

    sys.exit(main(sys.argv[1:], started=START))
