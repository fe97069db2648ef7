"""The kernels' build lock: several processes calling `kernels.build_all` on
an empty build directory compile each source once (one process builds
under the `fcntl` lock, the others find the libraries and load). `nvcc` is
replaced by a stub that logs its source, sleeps and writes the output."""

import multiprocessing
import stat

import torch_parallel_ranks as ranks
from basd_tpu_torch import kernels

STUB = """#!/bin/sh
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in
    -o) out="$2"; shift ;;
    *.cu) src="$1" ;;
  esac
  shift
done
echo "$src" >> "$STUB_NVCC_LOG"
sleep 0.3
echo built > "$out"
"""


def test_concurrent_builds_compile_each_source_once(tmp_path):
    stub_dir = tmp_path / "bin"
    stub_dir.mkdir()
    nvcc = stub_dir / "nvcc"
    nvcc.write_text(STUB)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    build, log = tmp_path / "_build", tmp_path / "nvcc.log"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=ranks.build_kernels_in,
                         args=(str(build), str(stub_dir), str(log)))
             for _ in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    assert [p.exitcode for p in procs] == [0] * 4
    built = sorted(line.rsplit("/", 1)[-1] for line in log.read_text().split())
    assert built == sorted(f"{name}.cu" for name in kernels._SIGNATURES)
    libs = sorted(p.name.split("-")[0] for p in build.glob("lib*.so"))
    assert libs == sorted(f"lib{name}" for name in kernels._SIGNATURES)
    assert not list(build.glob("*.tmp"))
