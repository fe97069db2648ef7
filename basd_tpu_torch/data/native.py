"""ctypes bindings for the native host data library (`native/basd_host.cpp`):
the port of `basd_tpu/data/native.py`.

The library is built from the repo's source with the flags of
`native/Makefile` (`g++ -O3 -march=native -fPIC -shared -std=c++17`: with
the host's FMAs its float64 sums round as the JAX package's library does)
into `basd_tpu_torch/_build/libbasd_host-<hash of the source>.so` at first
use (never into `native/`, and never the committed binary there), under
the kernels' build lock (one rank builds, the others wait), and a failed
build raises: nothing switches to numpy quietly. The numpy versions
(`resize_batch_u8_plain`, `welford_update_plain`) are the plain versions
the tests hold the library against.

  * `resize_batch_u8`   -- batched uint8 HWC bilinear resize
  * `WelfordStats`      -- streaming channel mean/std accumulator
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from basd_tpu_torch.kernels import build_lock

_SOURCE = Path(__file__).resolve().parents[2] / "native" / "basd_host.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

_lib: ctypes.CDLL | None = None
_LOCK = threading.Lock()


def _lib_path() -> Path:
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libbasd_host-{digest}.so"


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        ["g++", "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
         "-o", str(tmp), str(_SOURCE)],
        capture_output=True, text=True, timeout=300,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {out.name} from {_SOURCE} failed "
            f"(g++ exited {proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)


def library() -> ctypes.CDLL:
    """The loaded host library, built first if needed."""
    global _lib
    with _LOCK:
        if _lib is None:
            path = _lib_path()
            if not path.exists():
                with build_lock(_BUILD_DIR):
                    if not path.exists():
                        _build(path)
            lib = ctypes.CDLL(str(path))
            lib.resize_bilinear_u8.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
            ]
            lib.resize_bilinear_u8.restype = None
            lib.channel_stats_update.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.channel_stats_update.restype = None
            _lib = lib
        return _lib


def _u8_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f64_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def resize_batch_u8(images: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """(N, H, W, C) uint8 -> (N, oh, ow, C) uint8, half-pixel bilinear."""
    if images.dtype != np.uint8 or images.ndim != 4:
        raise ValueError(f"expected (N, H, W, C) uint8, got {images.dtype} "
                         f"{images.shape}")
    n, h, w, c = images.shape
    if h == oh and w == ow:
        return images
    src = np.ascontiguousarray(images)
    dst = np.empty((n, oh, ow, c), np.uint8)
    library().resize_bilinear_u8(_u8_ptr(src), n, h, w, c, _u8_ptr(dst), oh, ow)
    return dst


def resize_batch_u8_plain(images: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """The numpy version of `resize_batch_u8` (the same half-pixel rule; it
    interpolates as (1 - f) a + f b, the library as a + f (b - a), so the two
    may round a value to neighbouring levels)."""
    n, h, w, c = images.shape
    if h == oh and w == ow:
        return images
    sy = (np.arange(oh) + 0.5) * (h / oh) - 0.5
    sx = (np.arange(ow) + 0.5) * (w / ow) - 0.5
    sy = np.clip(sy, 0, h - 1)
    sx = np.clip(sx, 0, w - 1)
    y0 = sy.astype(np.int32)
    x0 = sx.astype(np.int32)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = (sy - y0)[None, :, None, None].astype(np.float32)
    fx = (sx - x0)[None, None, :, None].astype(np.float32)
    img = images.astype(np.float32)
    top = img[:, y0][:, :, x0] * (1 - fx) + img[:, y0][:, :, x1] * fx
    bot = img[:, y1][:, :, x0] * (1 - fx) + img[:, y1][:, :, x1] * fx
    out = top * (1 - fy) + bot * fy
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)


def welford_update_plain(mean: np.ndarray, m2: np.ndarray, count: np.ndarray,
                         flat_u8: np.ndarray) -> None:
    """The numpy version of the library's `channel_stats_update`: merge the
    (pixels, C) uint8 rows into the running (mean, m2, count) in place."""
    x = flat_u8.astype(np.float64) / 255.0
    n = x.shape[0]
    batch_mean = x.mean(0)
    batch_var = x.var(0)
    delta = batch_mean - mean
    new_count = int(count[0]) + n
    mean += delta * n / new_count
    m2 += batch_var * n + delta**2 * int(count[0]) * n / new_count
    count[0] = new_count


class WelfordStats:
    """Streaming per-channel mean/std (parallel-merge Welford) in the native
    library."""

    def __init__(self, channels: int = 3):
        if not 1 <= channels <= 8:  # the library's per-channel arrays hold 8
            raise ValueError(f"channels must be in 1..8, got {channels}")
        self.c = channels
        self.mean = np.zeros(channels, np.float64)
        self.m2 = np.zeros(channels, np.float64)
        self.count = np.zeros(1, np.int64)

    def update(self, image_u8: np.ndarray) -> None:
        flat = np.ascontiguousarray(image_u8.reshape(-1, self.c), dtype=np.uint8)
        library().channel_stats_update(
            _u8_ptr(flat), flat.shape[0], self.c, _f64_ptr(self.mean),
            _f64_ptr(self.m2),
            self.count.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )

    def result(self) -> tuple[tuple[float, ...], tuple[float, ...]]:
        std = np.sqrt(self.m2 / self.count[0])
        return tuple(self.mean.tolist()), tuple(std.tolist())
