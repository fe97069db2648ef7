"""Stamp measurement provenance onto a bench JSON line: the port of
`tools/stamp_bench_artifact.py`.

    python -m basd_tpu_torch.tools.stamp_bench_artifact <arm> '<json line>' [rev]

Prints the JSON object with a `provenance` field: `measured_at` (UTC
time), `git_rev_at_measurement` (the given rev, else the checkout's HEAD
at stamp time, else "unknown") and `note`, which names the arm and the
card. The card is the line's own `device` (top level or under `detail`,
as `python -m basd_tpu_torch.bench` writes it), else what `nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader` prints, else "unknown
card". Exits non-zero on a malformed line or missing arguments, so a
caller writing through a temporary file cannot truncate an artifact.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]


def card_name(line: dict) -> str:
    """The card that measured `line`: its `device` field, else nvidia-smi's
    first card, else "unknown card"."""
    detail = line.get("detail")
    device = line.get("device") or (detail.get("device") if isinstance(detail, dict) else None)
    if device:
        return str(device)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown card"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else "unknown card"


def git_rev() -> str:
    """HEAD of this checkout, short, or "" outside git."""
    try:
        return subprocess.run(["git", "rev-parse", "--short", "HEAD"], capture_output=True,
                              text=True, cwd=_ROOT).stdout.strip()
    except OSError:
        return ""


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    arm, line = argv[0], argv[1]
    j = json.loads(line)
    if not isinstance(j, dict):
        raise ValueError(f"a bench line is a JSON object, got {type(j).__name__}")
    rev = argv[2].strip() if len(argv) > 2 else ""
    j["provenance"] = {
        "measured_at": time.strftime("%Y-%m-%dT%H:%MZ", time.gmtime()),
        "git_rev_at_measurement": rev or git_rev() or "unknown",
        "note": f"python -m basd_tpu_torch.bench arm '{arm}' on {card_name(j)}",
    }
    print(json.dumps(j))
    return 0


if __name__ == "__main__":
    sys.exit(main())
