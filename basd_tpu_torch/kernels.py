"""Build, load and count the port's hand-written CUDA kernels.

Each kernel library is one `csrc/<name>.cu` file with a plain C interface,
compiled by `nvcc` for Hopper (`sm_90a`) into `_build/lib<name>-<hash>.so`
at first use and loaded with `ctypes`. The hash of the source is part of
the file name, so an edited source is rebuilt and a stale library is never
loaded. Nothing is built while a module is imported. Builds hold an
`fcntl` lock on `_build/.lock` (`build_lock`), so when several ranks start
on a cold `_build/` one of them compiles and the others wait and load.

`LAUNCHES` counts, per kernel wrapper, the calls that launched a kernel on
the card. Wrappers add one where they launch and nowhere else; callers that
want to show a run went through the kernels reset it with
`reset_launches()` and read it afterwards. Two wrappers launch twice in
one call: K3's `jacobi_eigh` above n = 96 (the rotations, then the V^T
replay) counts the call once; K6's `attn_probe` tilemax (the tile maxima,
then the variant) counts each launch.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from contextlib import contextmanager
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# the C libraries and the ctypes signatures of their entry points
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES: dict[str, dict[str, list]] = {
    "attention": {
        # q, k, v, o, m, denom, B, N, H, hd, q strides (b, n), k strides,
        # v strides, is_bf16, stream
        "basd_attention_fwd": [_P] * 6 + [_I] * 4 + [_L] * 6 + [_I, _P],
        # q, k, v, do, m, denom, dd, dq, dk, dv, B, N, H, hd, q/k/v/do
        # strides (b, n), is_bf16, stream
        "basd_attention_bwd": [_P] * 10 + [_I] * 4 + [_L] * 8 + [_I, _P],
    },
    "jacobi_eigh": {
        # a, w, vt, batch, n, steps, stream
        "basd_jacobi_eigh_pingpong": [_P] * 3 + [_I] * 3 + [_P],
        # a, w, log, batch, n, steps, stream (the packed_log route's first
        # launch), then log, vt, batch, n, steps, stream (its second)
        "basd_jacobi_eigh_packed_log": [_P] * 3 + [_I] * 3 + [_P],
        "basd_jacobi_eigh_vt_replay": [_P] * 2 + [_I] * 3 + [_P],
        # a, w, batch, n, steps, stream
        "basd_jacobi_eigvals_packed": [_P] * 2 + [_I] * 3 + [_P],
    },
    "warp": {
        # images, out, params, batch, n, channels, stream: one entry point
        # per route (ops/warp_kernel.py:warp_route)
        "basd_warp_cta": [_P] * 3 + [_I] * 3 + [_P],
        "basd_warp_cluster": [_P] * 3 + [_I] * 3 + [_P],
        "basd_warp_plane": [_P] * 3 + [_I] * 3 + [_P],
    },
    "attn_probe": {
        # q, k, v, o, tile_max, B, H, N, hd, group, variant, stream
        "basd_attn_probe": [_P] * 5 + [_I] * 6 + [_P],
    },
    "mp_rank": {
        # gram, ranks, diag, off2, batch, n, cluster, m, edge, stream
        "basd_mp_rank": [_P] * 4 + [_I] * 3 + [_F] * 2 + [_P],
    },
    "swiglu": {
        # x, out, rows, g, is_bf16, stream
        "basd_swiglu_gate": [_P] * 2 + [_L] + [_I] * 2 + [_P],
    },
    "rope": {
        # qkv, table, q_out, k_out, rows, n, prefix, heads, hd, scale,
        # is_bf16, stream
        "basd_rope_qk": [_P] * 4 + [_L] + [_I] * 4 + [_F, _I, _P],
    },
    "gelu": {
        # x, y, n, is_bf16, stream
        "basd_gelu_fwd": [_P] * 2 + [_L, _I, _P],
        # dy, x, dx, n, is_bf16, stream
        "basd_gelu_bwd": [_P] * 3 + [_L, _I, _P],
    },
    "layernorm": {
        # x, weight, bias, y, rows, D, eps, is_bf16, stream
        "basd_layernorm_fwd": [_P] * 4 + [_L, _I, _F, _I, _P],
        # x, weight, bias, y, D, is_bf16: the route the call would take
        "basd_layernorm_route": [_P] * 4 + [_I, _I],
    },
    "spans": {
        # flag, ring, slot, boundary, width, steps, closing, stream: the
        # train step's span stamps (utils/spans.py), no ported kernel and
        # no launch counter
        "basd_span_stamp_launch": [_P] * 3 + [_I] * 4 + [_P],
    },
}

LAUNCHES: dict[str, int] = {
    "attention_fwd": 0,
    "attention_bwd": 0,
    "jacobi_eigh": 0,
    "warp": 0,
    "jacobi_eigvals": 0,
    "attn_probe": 0,
    "mp_rank": 0,
    "swiglu_gate": 0,
    "gelu_fwd": 0,
    "gelu_bwd": 0,
    "rope_qk": 0,
    "layernorm": 0,
}

_LOADED: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from "
        "basd_tpu_torch/csrc at first use and need the CUDA toolkit"
    )


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _nvcc_cmd(name: str, out: Path) -> list[str]:
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(out), str(CSRC / f"{name}.cu"),
    ]


@contextmanager
def build_lock(directory: Path):
    """An exclusive `fcntl` lock on `directory/.lock` across processes
    (released when the holder exits, however it exits)."""
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / ".lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_all() -> dict[str, str]:
    """Compile every kernel library that is not built yet, one `nvcc` per
    source, all started together, under `build_lock`. Returns the
    compiler's output per library (register and shared-memory use from
    `-Xptxas -v`); raises if any build fails."""
    with build_lock(BUILD_DIR):
        return _build_missing()


def _build_missing() -> dict[str, str]:
    procs = {}
    for name in _SIGNATURES:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                _nvcc_cmd(name, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
            ),
            tmp,
            out,
        )
    logs = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is not None:
            return lib
        path = _lib_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LOADED[name] = lib
        return lib


def sass(name: str) -> str:
    """The machine code of library `name` as `cuobjdump -sass` prints it
    (the toolkit's, beside `nvcc`), built first if needed."""
    library(name)
    tool = Path(_nvcc()).with_name("cuobjdump")
    return subprocess.run(
        [str(tool), "-sass", str(_lib_path(name))],
        check=True, capture_output=True, text=True,
    ).stdout


def check(status: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (its `cudaGetLastError`)."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
