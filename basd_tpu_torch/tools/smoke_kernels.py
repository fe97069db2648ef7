"""Every kernel of the port's train path, once at a tiny real shape on the
card, against its plain version: the start-up check of
`basd_tpu_torch.utils.kernel_smoke`, standalone, to run first when a card
or a toolchain is new. One PASS/FAIL line per kernel, then `ALL PASS` or
`SOME FAILED`; exits 1 if anything failed.

    python -m basd_tpu_torch.tools.smoke_kernels [--device cuda:0]

The counterpart of the JAX package's `tools/smoke_kernels.py`. It runs on
the card by default; `--device cpu` reports that there is nothing to check
(the CPU runs the plain versions).
"""

from __future__ import annotations

import argparse
import sys

from basd_tpu_torch import kernels
from basd_tpu_torch.device import resolve_device
from basd_tpu_torch.utils.kernel_smoke import run_kernel_checks


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="the CUDA device to check (default: the card)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cpu":
        print("smoke_kernels: the CPU runs the plain versions; nothing to check",
              flush=True)
        return 0
    kernels.reset_launches()
    results = run_kernel_checks(device)
    failed = [name for name, r in results.items() if isinstance(r, Exception)]
    for name, r in results.items():
        if name in failed:
            print(f"FAIL {name}: {type(r).__name__}: {r}", flush=True)
        else:
            print(f"PASS {name}: {r}", flush=True)
    print(f"launches {dict(kernels.LAUNCHES)}", flush=True)
    print("SOME FAILED" if failed else "ALL PASS", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
