"""The attention-forward timing probe: kernel K6 (`csrc/attn_probe.cu`) and
its plain torch version.

Counterpart of the Pallas `kernel` of `tools/probe_attn_internals.py`. Six
variants of a softmax-free attention forward, each dropping or changing
one pass of the forward, so that their times show which pass costs what.
They compute wrong math on purpose: no 1/sqrt(hd) scale and no
normalisation. q, k, v are in the probe's (B, H, N, hd) layout, bf16 (the
kernel takes hd = 64, the head_dim of every BASD ViT attention):

    s = q k^T in fp32, then e per variant:
      full     bf16(exp(s - rowmax))
      tilemax  bf16(exp(s - M)), M = max of s over each (group, N, N) tile
               of `group` consecutive sequences of one head
      nomax    bf16(exp(s))
      bf16exp  bf16(exp(bf16(s - rowmax)))
      noexp    bf16(s)
      mxonly   bf16(s), rounded as the product is made (no pass over s)
    o = bf16(e v), accumulated in fp32.

The tensor's device picks the implementation: a CUDA tensor launches the
kernel (or raises), a CPU tensor takes the plain version. On the card both
products run on the tensor cores, for any 1 <= N <= 1024. tilemax is two
launches on the card (the tile maxima, then the variant), and the launch
counter `attn_probe` counts both.
"""

from __future__ import annotations

import torch

from basd_tpu_torch import kernels

VARIANTS = ("full", "tilemax", "nomax", "bf16exp", "noexp", "mxonly")
_MAX_PASS = 6  # the kernel's tilemax first launch
MAX_SEQ = 1024
HEAD_DIM = 64  # every BASD ViT attention's head_dim
_QUERY_BLOCK = 64  # query rows per CTA: tilemax's first launch writes one max each


def probe_flops(b: int, h: int, n: int, hd: int) -> int:
    """The probe's FLOP count, two (N, N, hd) products: 4 B H N^2 hd."""
    return 4 * b * h * n * n * hd


def probe_attention_plain(q, k, v, *, variant: str, group: int = 8):
    """K6's function in torch ops: (B, H, N, hd) -> o (B, H, N, hd)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    b, h, n, hd = q.shape
    dt = q.dtype
    rnd = lambda x: x.to(dt).float()
    s = q.float() @ k.float().transpose(-1, -2)
    if variant in ("full", "bf16exp"):
        m = s.amax(dim=-1, keepdim=True)
    if variant == "full":
        e = rnd(torch.exp(s - m))
    elif variant == "tilemax":
        if b % group:
            raise ValueError(f"tilemax needs B % group == 0, got {b} % {group}")
        sg = s.reshape(b // group, group, h, n, n)
        m = sg.amax(dim=(1, 3, 4), keepdim=True)
        e = rnd(torch.exp(sg - m)).reshape(b, h, n, n)
    elif variant == "nomax":
        e = rnd(torch.exp(s))
    elif variant == "bf16exp":
        e = rnd(torch.exp(rnd(s - m)))
    else:  # noexp, mxonly
        e = rnd(s)
    return (e @ v.float()).to(dt)


def _check_cuda(q, k, v, variant, group):
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    b, h, n, hd = q.shape
    for x, name in ((q, "q"), (k, "k"), (v, "v")):
        if x.shape != q.shape or x.device != q.device:
            raise ValueError(f"{name} must match q in shape and device")
        if x.dtype != torch.bfloat16 or not x.is_contiguous():
            raise ValueError("attention probe kernel takes contiguous bf16 (B, H, N, hd)")
        if x.data_ptr() % 16:
            raise ValueError(f"attention probe kernel loads 16-byte pieces: {name} is "
                             "not 16-byte aligned")
    if hd != HEAD_DIM or not 1 <= n <= MAX_SEQ or b > 65535 or h > 65535:
        raise ValueError(
            f"attention probe kernel takes hd = {HEAD_DIM}, 1 <= N <= "
            f"{MAX_SEQ}, B, H <= 65535; got {tuple(q.shape)}")
    if variant == "tilemax" and (group < 1 or b % group):
        raise ValueError(f"tilemax needs B % group == 0, got {b} % {group}")


def _stream(q: torch.Tensor) -> int:
    return torch.cuda.current_stream(q.device).cuda_stream


def _probe_cuda(q, k, v, variant: str, group: int) -> torch.Tensor:
    _check_cuda(q, k, v, variant, group)
    b, h, n, hd = q.shape
    o = torch.empty_like(q)
    lib = kernels.library("attn_probe")
    stream = _stream(q)

    def launch(code: int, tile_max) -> None:
        status = lib.basd_attn_probe(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if tile_max is None else tile_max.data_ptr(), b, h, n, hd,
            group, code, stream,
        )
        kernels.check(status, "basd_attn_probe")
        kernels.LAUNCHES["attn_probe"] += 1

    tile_max = None
    if variant == "tilemax":
        nqb = -(-n // _QUERY_BLOCK)
        tile_max = torch.empty((b, h, nqb), dtype=torch.float32, device=q.device)
        launch(_MAX_PASS, tile_max)
    launch(VARIANTS.index(variant), tile_max)
    return o


def probe_attention(q, k, v, *, variant: str, group: int = 8) -> torch.Tensor:
    """K6 on a CUDA tensor, its plain version on a CPU one."""
    if q.device.type == "cpu":
        return probe_attention_plain(q, k, v, variant=variant, group=group)
    if q.device.type != "cuda":
        raise ValueError(f"attention probe runs on cuda or cpu, not {q.device}")
    return _probe_cuda(q, k, v, variant, group)
