#!/usr/bin/env python3
"""Smoke run of the BASD PyTorch port (`basd_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is not 0:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every kernel of the port from basd_tpu_torch/csrc (nvcc,
     sm_90a, one process per source, all at once); the HMMA (tensor-core)
     instructions in each bf16 attention kernel's and each attention-probe
     kernel's SASS (cuobjdump), none allowed to have none; the instruction
     mix of one rotation step of K3 at n = 48 and of K5 (and of its
     rotation-log twin, K3's first launch above n = 96) at n = 192;
  3. staging: the Table-3 models at full width (DeiT-Tiny/4 student at
     32 px, DINOv2 ViT-B/14 teacher, bf16, random weights from seeds,
     batch 128) and the calibrated subspace K;
  4. kernels: each kernel against its plain torch version on the card at
     the shapes of the paths below, with its stated tolerance, timed beside
     the plain version and a PyTorch library yardstick where one exists:
     K1-K4 at the train step's shapes, K1 and K2 also at the Table-1
     student's (256, 197, 384) H=6 and the Table-2 student's (256, 197,
     192) H=3, K1 at the Table-1 ViT-L/14 teacher's (256, 257, 1024) H=16,
     K1 and K2 at the gate's edges, bf16 K1/K2 and
     SDPA also by device time alone (the host kept ahead of the card by a
     spin kernel); K3 on the main path's own eigh inputs, timed also by
     device time alone per launch and per rotation step, on wide-spectrum
     Grams and at every even n of its ping-pong route (4..96, there bit
     for bit), and through its packed_log route (96 < n <= 238: K5's
     packed kernel writing a rotation log, then V^T replayed from it) at
     (4, 128, 128) and (3, 167, 167), its eigenvalues K5's bits, each case
     printed with its route;
     K4 bit for bit at the main path's (128, 32, 32, 3), the reference
     default's (256, 224, 224, 3) (both also by device time alone) and at
     each route's edges, each case printed with its route;
     K5 on the spectral tuner's own (12, 192, 192) token covariances and
     at an odd n (191), both also by device time alone, and at the
     smallest and largest n of each route (4, 192, 238);
     K3 at (48, 192, 192), its packed_log route, on the sweeps probe's two
     spectrum families, by device time alone at sweeps 6 and 12; K6 in all
     six variants at the teacher's attention shape (256, 12, 257, 64)
     (also by device time alone) and at N = 1024 and 300, with K1
     checked on the same q, k, v. At these tool shapes the
     kernels' event-loop times (K5,
     K3 at n = 192, K6 and K1 beside it) are the tools' readings in phase
     5b, and the tuner reuses the features staged here;
  5. main path: a short `make_train_step(augment=False)` run, then train
     steps of `make_train_step(augment=True)` (bench.py's step), each with
     the kernels' launch counters reset just before and read just after;
  5b. tools: one full-size run of each tool path
     (`basd_tpu_torch.tools.tune_spectral`, `probe_jacobi_sweeps`,
     `probe_attn_internals`), counters reset just before and read just
     after each;
  5c. the 224 px steps at full width, batch 256 (bench.py's `--imagenet
     --teacher dinov2_vitl14` and `--cross-arch` arms): Table-1 (DINOv2
     ViT-L/14 teacher, ViT-S/16 student) and Table-2 (ConvNeXt-V2-Tiny
     teacher, DeiT-Tiny/16 student), staged as bench.py stages them, 1 + 2
     augmented steps each with the exact launches per step, counters reset
     just before and read just after; K3 at Table-2's (4, K, K); the ViT-L
     teacher's intrinsic dimension and the student it derives;
  6. reference: small configurations stepped with augment=True on the
     card and on the CPU (plain versions) from one set of draws, student
     views, losses and ranks compared, with a ViT and a ConvNeXt-V2
     teacher; a ResNet teacher's forward and a no-CLS ViT's forward and
     backward on both; a remat=True step against remat=False on the card;
  7. profile: one main-path step and one Table-1 step under
     torch.profiler, device time by kernel and host time by stage, and K4's
     device time from phase 4 (profiles have dropped its one launch);
  8. entry points: `basd_tpu_torch.train.main` at Table-3 width (the
     basd_cifar100 experiment on 1,024 synthetic images, one epoch of 8
     steps, bf16, remat, K auto, `latest` every 4 steps) with its exact
     launches, the restored `latest` against the live state bit for bit,
     and `python -m basd_tpu_torch.evaluate` from the run's snapshot
     reproducing its final eval; the trainer's step times beside the bare
     step's, the eval throughput, each save's blocking time, peak memory;
then a JSON line of the kernels, the card's name and power limit, and the
result line {"ok": true, "device": {...}} last.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

MAIN_STEPS = 6
DETERMINISTIC_STEPS = 2
STEPS_224 = 2  # timed steps after the first at 224 px
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
TEACHER_STATS = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
DATASET_STATS = ((0.507, 0.487, 0.441), (0.267, 0.256, 0.276))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 2

    import torch.nn.functional as F

    from basd_tpu_torch import kernels
    from basd_tpu_torch.losses import (
        calibrate_subspace_k,
        extraction_points,
        init_selector,
    )
    from basd_tpu_torch.models import (
        VisionTransformer,
        ViTConfig,
        create_student,
        derive_student_arch,
        estimate_intrinsic_dim,
        load_teacher,
    )
    from basd_tpu_torch.ops import attention as attn
    from basd_tpu_torch.ops import augment as augment_ops
    from basd_tpu_torch.ops import warp_kernel as wk
    from basd_tpu_torch.ops.mixup import mixup_cutmix
    from basd_tpu_torch.ops.preprocess import dual_view, eval_view
    from basd_tpu_torch.spectral import jacobi
    from basd_tpu_torch.ops import attn_probe
    from basd_tpu_torch.spectral.jacobi_kernel import (
        _jacobi_eigvals_raw_cuda,
        _jacobi_raw_cuda,
        eigh_route,
        eigvals_route,
        kernel_jacobi_eigh,
        kernel_jacobi_eigvals,
    )
    from basd_tpu_torch.tools import (
        probe_attn_internals,
        probe_jacobi_sweeps,
        time_warp,
        tune_spectral,
    )
    from basd_tpu_torch.tools.timing import (
        device_events,
        device_ms,
        device_us,
        kernel_ms,
    )
    from basd_tpu_torch.spectral.ops import use_jacobi
    from basd_tpu_torch import evaluate as evaluate_entry
    from basd_tpu_torch import train as train_entry
    from basd_tpu_torch.training import train_step
    from basd_tpu_torch.training.train_step import make_train_step
    from basd_tpu_torch.training.trainer import Trainer

    # fp32 means fp32 here: no TF32 in matmuls or in cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    peak_flops = {torch.bfloat16: 989e12, torch.float32: 67e12}
    dev = torch.device("cuda", 0)
    bf16, f32 = torch.bfloat16, torch.float32

    def timed_ms(fn, reps: int) -> float:
        return device_ms(fn, dev, reps)

    def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / peak_flops[dtype] * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def rel_err(got, want) -> tuple[float, float]:
        diff = (got.float() - want.float()).abs().max().item()
        return diff, diff / max(want.float().abs().max().item(), 1e-30)

    # ---- 1. device ----
    card = card_line()
    print(f"device: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    logs = kernels.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(sorted(logs)) or 'cached'})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")
    # the bf16 attention kernels (K1, K2's two launches, one per head_dim of
    # the gate) run on the tensor cores: HMMA instructions in each one's SASS
    hmma, fn = {}, None
    for line in kernels.sass("attention").splitlines():
        if "Function :" in line:
            found = re.search(r"(attn_\w+?_mma)ILi(\d+)E", line)
            fn = f"{found.group(1)}<{found.group(2)}>" if found else None
            if fn:
                hmma[fn] = 0
        elif fn and "HMMA" in line:
            hmma[fn] += 1
    if len(hmma) != 3 * 8 or min(hmma.values()) == 0:
        raise AssertionError(f"bf16 attention kernels without HMMA: {hmma}")
    print(f"sass: HMMA instructions per bf16 attention kernel {hmma}")
    # K6's kernels too: one per variant and tilemax's first launch
    hmma6, fn = {}, None
    for line in kernels.sass("attn_probe").splitlines():
        if "Function :" in line:
            found = re.search(r"attn_probe_mmaILi(\d+)E", line)
            fn = f"attn_probe_mma<{found.group(1)}>" if found else None
            if fn:
                hmma6[fn] = 0
        elif fn and "HMMA" in line:
            hmma6[fn] += 1
    if len(hmma6) != 7 or min(hmma6.values()) == 0:
        raise AssertionError(f"attention probe kernels without HMMA: {hmma6}")
    print(f"sass: HMMA instructions per attention probe kernel {hmma6}")
    # the machine code of one rotation step: the instructions between the
    # loop's first and second step barriers (barrier 0), the block threads'
    # and the rotation lanes' code both, the IEEE division's and square
    # root's branches to their slow paths included (taken only on special
    # operands); K3's ping-pong route at n = 48 (the main path's), K5's
    # packed route at n = 192 (the spectral tuner's) and its rotation-log
    # twin (the first launch of K3's packed_log route at n = 192)
    jacobi_sass = kernels.sass("jacobi_eigh").splitlines()

    def step_mix(fn_name, mangled):
        step_ops, fn = [], None
        for line in jacobi_sass:
            if "Function :" in line:
                fn = mangled in line
            elif fn and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
                step_ops.append(line.split("*/", 1)[1].strip())
        bars = [i for i, op in enumerate(step_ops)
                if re.match(r"BAR\.SYNC\S* 0x0\s*;", op)]
        if len(bars) < 3:
            raise AssertionError(f"{fn_name}: barriers at {bars}")
        one_step = step_ops[bars[1] + 1:bars[2] + 1]
        mix = {k: sum(k in op for op in one_step) for k in
               ("MUFU", "FFMA", "FMUL", "FADD", "IADD", "LDS", "STS", "STG", "SHFL", "CALL",
                "BAR")}
        print(f"sass: {fn_name} one rotation step: {len(one_step)} "
              f"instructions per warp ({mix})")

    step_mix("jacobi_pingpong_kernel<48>", "jacobi_pingpong_kernelILi48E")
    step_mix("jacobi_packed_kernel<6, 192>", "jacobi_packed_kernelILi6ELi192ELb0EE")
    step_mix("jacobi_packed_kernel<6, 192, log>", "jacobi_packed_kernelILi6ELi192ELb1EE")

    # ---- 3. staging: Table-3 at full width (bench.py's default workload) ----
    img, batch, num_classes, patch = 32, 128, 100, 4
    raw = img + 2 * patch
    teacher = load_teacher("dinov2_vitb14", img_size=img, dtype=bf16, device=dev)
    points = extraction_points(12, 4)
    student, cfg = create_student(
        "vit_tiny_patch16", num_classes=num_classes, drop_path_rate=0.05,
        img_size=img, arch_overrides={"patch_size": patch},
        capture_layers=points, dtype=bf16, remat=False, device=dev,
    )
    selector = init_selector(1, len(points), cfg.embed_dim,
                             teacher.spec.embed_dim, device=dev)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(
        (rng.random((batch, raw, raw, 3)) * 255).astype(np.uint8)).to(dev)
    labels = torch.from_numpy(
        rng.integers(0, num_classes, batch, dtype=np.int64)).to(dev)
    calib = eval_view(images, img, img / raw, *TEACHER_STATS)
    k_cal = calibrate_subspace_k(teacher, cfg.embed_dim, calib, seed=0,
                                 num_extraction_points=len(points))
    k3_on_path = use_jacobi((len(points), k_cal, k_cal))
    print(f"staging: student D={cfg.embed_dim} heads={cfg.num_heads} "
          f"tokens={cfg.num_patches + 1}; teacher D={teacher.spec.embed_dim} "
          f"tokens={teacher.num_tokens + 1}; K={k_cal} "
          f"(Jacobi kernel gate 16 <= K <= 96: {k3_on_path})")

    # ---- 4. kernels against their plain versions ----
    gen = torch.Generator(device=dev).manual_seed(0)
    report = {}

    def attention_inputs(b, n, d, hd, dtype):
        mk = lambda s: (torch.randn((b, n, d), device=dev, generator=gen) * s).to(dtype)
        return mk(hd**-0.5), mk(1.0), mk(1.0)

    def sdpa_layout(x, hd):
        b, n, d = x.shape
        return x.reshape(b, n, d // hd, hd).transpose(1, 2).contiguous()

    # K1 at the Table-3 shapes and the Table-1 student's, K2 where a
    # backward runs (the student; the teacher is frozen), bf16 and fp32,
    # each beside SDPA (forward or its autograd backward). bf16 runs on the
    # tensor cores; its times are read twice: `ms` by CUDA events around a
    # loop of calls (which a kernel of a few us leaves at the host's
    # enqueue rate) and `device_ms` by CUDA events around calls that the
    # host enqueued while a spin kernel held the card (`kernel_ms`).
    att_cases = [("student", 128, 65, 192, 3, (bf16, f32)),
                 ("teacher", 128, 5, 768, 12, (bf16, f32)),
                 ("Table-1 student", 256, 197, 384, 6, (bf16, f32)),
                 ("Table-2 student", 256, 197, 192, 3, (bf16,)),
                 ("Table-1 ViT-L teacher", 256, 257, 1024, 16, (bf16,))]
    bwd_cases = ("student", "Table-1 student", "Table-2 student")
    fmt = lambda x: "-" if x is None else f"{x:.4f}"

    def attention_row(what, errs, tol, dtype, bnd, kernel, plain, library):
        worst = max(e[1] for e in errs)
        if not worst <= tol:
            raise AssertionError(f"{what}: rel err {worst} > {tol}")
        row = dict(max_abs_err=max(e[0] for e in errs), rel_err=worst, tol=tol,
                   ms=timed_ms(kernel, 50), plain_ms=timed_ms(plain, 20),
                   library_ms=timed_ms(library, 50), bound_ms=bnd[0],
                   bound_by=bnd[1], device_ms=None, library_device_ms=None)
        if dtype == bf16:
            row.update(device_ms=kernel_ms(kernel, dev),
                       library_device_ms=kernel_ms(library, dev))
        print(f"kernel {what}: rel err {worst:.3g} (tol {tol}) ms {row['ms']:.4f} "
              f"(device {fmt(row['device_ms'])}) plain {row['plain_ms']:.4f} "
              f"sdpa {row['library_ms']:.4f} (device "
              f"{fmt(row['library_device_ms'])}) bound {bnd[0]:.4f} ({bnd[1]})")
        return row

    for label, b, n, d, h, dtypes in att_cases:
        hd = d // h
        for dtype in dtypes:
            tol = 2e-2 if dtype == bf16 else 1e-5
            dname = str(dtype).split(".")[-1]
            case = f"{label} B={b} N={n} D={d} H={h} {dname}"
            q, k, v = attention_inputs(b, n, d, hd, dtype)
            got = attn._attention_forward_cuda(q, k, v, hd)
            want = attn.attention_forward_plain(q, k, v, hd)
            torch.cuda.synchronize()
            itm = q.element_size()
            qh, kh, vh = (sdpa_layout(x, hd) for x in (q, k, v))
            row = attention_row(
                f"attention_fwd {case}", [rel_err(g, w) for g, w in zip(got, want)],
                tol, dtype,
                bound(4 * b * n * d * itm + 2 * b * n * h * 4, 4 * b * h * n * n * hd, dtype),
                lambda: attn._attention_forward_cuda(q, k, v, hd),
                lambda: attn.attention_forward_plain(q, k, v, hd),
                lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=1.0))
            report.setdefault("attention_fwd", {})[case] = dict(
                shape=[b, n, d], heads=h, dtype=dname, **row)
            if label not in bwd_cases:
                continue
            o, m, denom = want
            do = torch.randn((b, n, d), device=dev, generator=gen).to(dtype)
            dd = (do.float() * o.float()).reshape(b, n, h, hd).sum(-1).contiguous()
            args = (q, k, v, do, m, denom, dd, hd)
            got = attn._attention_backward_cuda(*args)
            want = attn.attention_backward_plain(*args)
            torch.cuda.synchronize()
            qg, kg, vg = (x.requires_grad_(True) for x in (qh, kh, vh))
            og = F.scaled_dot_product_attention(qg, kg, vg, scale=1.0)
            doh = sdpa_layout(do, hd)
            row = attention_row(
                f"attention_bwd {case}", [rel_err(g, w) for g, w in zip(got, want)],
                tol, dtype,
                bound(7 * b * n * d * itm + 3 * b * n * h * 4, 10 * b * h * n * n * hd, dtype),
                lambda: attn._attention_backward_cuda(*args),
                lambda: attn.attention_backward_plain(*args),
                lambda: torch.autograd.grad(og, (qg, kg, vg), doh, retain_graph=True))
            report.setdefault("attention_bwd", {})[case] = dict(
                shape=[b, n, d], heads=h, dtype=dname, **row)

    # Attention at the edges of the kernel gate, which the main path does
    # not reach: N=1, N=512 with head_dim 128 (over 48 KB of shared memory),
    # D=2048, odd N, head_dim 16, 32 and 48, and N=16 (four heads per CTA
    # in the bf16 forward); q, k, v are strided views of one
    # (B, N, 3D) tensor as in the model. At N=1 the softmax over one key is
    # constant, so dq and dk are 0 in exact arithmetic and both sides return
    # the rounding noise of dO.v - dd: there only o, m, denom and dv are
    # compared.
    for b, n, d, h in [(2, 512, 256, 2), (3, 1, 64, 1), (2, 17, 96, 3),
                       (1, 33, 2048, 16), (2, 100, 96, 2), (2, 16, 64, 4)]:
        hd = d // h
        for dtype in (bf16, f32):
            tol = 2e-2 if dtype == bf16 else 1e-5
            qkv = torch.randn((b, n, 3 * d), device=dev, generator=gen).to(dtype)
            q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
            do = torch.randn((b, n, d), device=dev, generator=gen).to(dtype)
            got = attn._attention_forward_cuda(q, k, v, hd)
            want = attn.attention_forward_plain(q, k, v, hd)
            o, m, denom = want
            dd = (do.float() * o.float()).reshape(b, n, h, hd).sum(-1).contiguous()
            args = (q, k, v, do, m, denom, dd, hd)
            got += attn._attention_backward_cuda(*args)
            want += attn.attention_backward_plain(*args)
            torch.cuda.synchronize()
            compared = (0, 1, 2, 5) if n == 1 else range(6)
            worst = max(rel_err(got[i], want[i])[1] for i in compared)
            if not worst <= tol:
                raise AssertionError(
                    f"attention edge {(b, n, d, h)} {dtype}: rel err {worst} > {tol}")
            print(f"kernel attention edge B={b} N={n} D={d} H={h} "
                  f"{str(dtype).split('.')[-1]}: fwd+bwd rel err {worst:.3g} "
                  f"(tol {tol})")

    # K3 on the main path's own eigh inputs, recorded from one selector call
    # on this batch: the two Rayleigh-Ritz batches and the angle spectra.
    # The kernel runs the plain version's rotations, so their eigenvalues
    # agree to rounding: 1e-4 of max|w|; V stays orthogonal to 5e-5. The
    # sweeps=6 eigenvalue and reconstruction errors against float64 LAPACK
    # are the main path's convergence (off-diagonal mass left in clusters of
    # near-equal eigenvalues); they are reported, not checked.
    from basd_tpu_torch.losses import select_and_mix
    from basd_tpu_torch.models import extract_intermediates
    from basd_tpu_torch.spectral import ops as spectral_ops

    def jacobi_timing(a, sweeps=6, kernel=True):
        """The kernel (at sweeps=6 as the main path calls it), timed beside
        the plain version and torch.linalg.eigh, with its bound: `ms` by
        the event loop of wrapper calls, `device_ms` the raw launch's
        device time with the host held ahead (`kernel_ms`), and that per
        rotation step in us; on the packed_log route (n > 96) also K5's
        device time on the same input (`k5_device_ms`: the first launch's
        kernel without its log stores), so the rest is the V^T replay.
        kernel=False leaves the event-loop time to the tool that times it
        (phase 5b)."""
        bsz, nn_ = a.shape[0], a.shape[-1]
        n_even = nn_ + nn_ % 2
        steps = (n_even - 1) * sweeps
        # per step: the 2x2 block rotations of the symmetric A's upper block
        # triangle, h (h + 1) / 2 blocks of 24 flops (3 n (n + 2), as K5's
        # bound counts them), and of V^T's rows, h n column pairs of 6 (3 n^2)
        flops = bsz * steps * (3 * n_even * (n_even + 2) + 3 * n_even * n_even)
        nbytes = 4 * bsz * (2 * nn_ * nn_ + nn_)
        bnd, by = bound(nbytes, flops, f32)
        row = dict(
            plain_ms=timed_ms(lambda: jacobi.jacobi_eigh(a, sweeps=sweeps),
                              3 if nn_ <= 96 else 1),
            library_ms=timed_ms(lambda: torch.linalg.eigh(a), 5),
            bound_ms=bnd, bound_by=by,
        )
        raw = jacobi.symmetrize_pad(a)[0].contiguous()
        if kernel:
            row["ms"] = timed_ms(lambda: kernel_jacobi_eigh(a, sweeps=sweeps), 20)
        row["device_ms"] = kernel_ms(lambda: _jacobi_raw_cuda(raw, sweeps), dev)
        row["us_per_step"] = row["device_ms"] * 1e3 / steps
        if eigh_route(n_even) == "packed_log":
            row["k5_device_ms"] = kernel_ms(lambda: _jacobi_eigvals_raw_cuda(raw, sweeps), dev)
        return row

    def equals_k5(a, sweeps):
        """Whether K3's eigenvalues are K5's bits on the same input and
        sweeps (the packed_log route's first launch is K5's kernel with a
        rotation log)."""
        raw = jacobi.symmetrize_pad(a)[0].contiguous()
        return torch.equal(_jacobi_raw_cuda(raw, sweeps)[0],
                           _jacobi_eigvals_raw_cuda(raw, sweeps))

    def eig_residuals(w, vec, a):
        """Reconstruction ||A - V diag(w) V^T|| / ||A|| and orthogonality
        max |V^T V - I|, worst over the batch, in float64."""
        v64 = vec.double()
        recon = v64 @ torch.diag_embed(w.double()) @ v64.transpose(-1, -2)
        rec_err = (torch.linalg.matrix_norm(recon - a.double())
                   / torch.linalg.matrix_norm(a.double())).max().item()
        eye = torch.eye(a.shape[-1], dtype=torch.float64, device=dev)
        return rec_err, (v64.transpose(-1, -2) @ v64 - eye).abs().max().item()

    recorded = []
    solver = spectral_ops.kernel_jacobi_eigh

    def recording_solver(a, sweeps):
        recorded.append(a.detach().clone())
        return solver(a, sweeps=sweeps)

    with torch.no_grad():
        t_tok, t_imp = extract_intermediates(teacher, calib)
        s_out = student(eval_view(images, img, img / raw, *DATASET_STATS))
        spectral_ops.kernel_jacobi_eigh = recording_solver
        try:
            select_and_mix(selector, s_out.tokens, t_tok, t_imp, subspace_k=k_cal)
        finally:
            spectral_ops.kernel_jacobi_eigh = solver
    names = ["teacher Rayleigh-Ritz", "student Rayleigh-Ritz", "principal angles"]
    if len(recorded) != (3 if k3_on_path else 0):
        raise AssertionError(f"{len(recorded)} Jacobi eighs in one selector call")
    for what, a in zip(names, recorded):
        a = a.reshape(-1, a.shape[-1], a.shape[-1]).contiguous()
        bsz, nn_ = a.shape[0], a.shape[-1]
        w, vec = kernel_jacobi_eigh(a, sweeps=6)
        wp, _ = jacobi.jacobi_eigh(a, sweeps=6)
        w64 = torch.linalg.eigvalsh(a.double()).flip(-1)
        torch.cuda.synchronize()
        scale = w64.abs().amax(-1)
        plain_rel = ((w - wp).abs().amax(-1) / scale).max().item()
        eig6_err = ((w.double() - w64).abs().amax(-1) / scale).max().item()
        rec_err, orth_err = eig_residuals(w, vec, a)
        if not (plain_rel <= 1e-4 and orth_err <= 5e-5):
            raise AssertionError(
                f"jacobi_eigh {what}: vs plain {plain_rel} (tol 1e-4), orth "
                f"{orth_err} (tol 5e-5)")
        row = dict(max_abs_err=(w - wp).abs().max().item(), rel_err=plain_rel,
                   eig6_err=eig6_err, recon_err=rec_err, orth_err=orth_err,
                   route=eigh_route(nn_), **jacobi_timing(a))
        report.setdefault("jacobi_eigh", {})[f"{what} ({bsz}, {nn_}, {nn_})"] = row
        print(f"kernel jacobi_eigh {what} {(bsz, nn_, nn_)} (main-path input, "
              f"route {row['route']}): vs plain {plain_rel:.3g} (tol 1e-4); orth "
              f"{orth_err:.3g} (tol 5e-5); sweeps=6 eig vs LAPACK {eig6_err:.3g}, "
              f"recon {rec_err:.3g}; ms {row['ms']:.4f} (device "
              f"{row['device_ms']:.4f}, {row['us_per_step']:.3f} us per step) plain "
              f"{row['plain_ms']:.4f} linalg.eigh {row['library_ms']:.4f} bound "
              f"{row['bound_ms']:.5f} ({row['bound_by']})")

    # K3 accuracy on Grams with a wide (1e0..1e-6) spectrum, converged
    # (sweeps=12), against float64 LAPACK. Eigenvalues (of max|w|),
    # reconstruction and orthogonality within 5e-5, or 1e-4 above n=48: the
    # fp32 floor grows with the rotation count (560 steps at n=48, 1140 at
    # n=96) and sits above 1e-5. The kernel is held within 1e-4 of max|w|
    # of the plain version (on the ping-pong route, every case here, it
    # returns the plain version's bits; see below).
    for bsz, nn_ in [(12, 48), (48, 48), (8, 33), (4, 80), (4, 96), (3, 95),
                     (5, 16)]:
        tol = 5e-5 if nn_ <= 48 else 1e-4
        x = torch.randn((bsz, nn_, 2 * nn_), device=dev, generator=gen)
        x = x * torch.logspace(0, -3, 2 * nn_, device=dev)
        a = x @ x.transpose(-1, -2)
        w, _ = kernel_jacobi_eigh(a, sweeps=6)
        wp12, _ = jacobi.jacobi_eigh(a, sweeps=12)
        w12, vec = kernel_jacobi_eigh(a, sweeps=12)
        w64 = torch.linalg.eigvalsh(a.double()).flip(-1)
        torch.cuda.synchronize()
        scale = w64.abs().amax(-1)
        eig6_err = ((w.double() - w64).abs().amax(-1) / scale).max().item()
        eig_err = ((w12.double() - w64).abs().amax(-1) / scale).max().item()
        plain_rel = ((w12 - wp12).abs().amax(-1) / scale).max().item()
        rec_err, orth_err = eig_residuals(w12, vec, a)
        if not (plain_rel <= 1e-4 and eig_err <= tol and rec_err <= tol
                and orth_err <= tol):
            raise AssertionError(
                f"jacobi_eigh {(bsz, nn_, nn_)}: vs plain {plain_rel} eig "
                f"{eig_err} recon {rec_err} orth {orth_err} (tol {tol})")
        route = eigh_route(nn_ + nn_ % 2)
        report.setdefault("jacobi_eigh", {})[f"wide spectrum ({bsz}, {nn_}, {nn_})"] = dict(
            max_abs_err=(w12 - wp12).abs().max().item(), rel_err=plain_rel,
            eig6_err=eig6_err, eig_err=eig_err, recon_err=rec_err,
            orth_err=orth_err, route=route,
            **(jacobi_timing(a) if nn_ == 48 else {}))
        print(f"kernel jacobi_eigh wide spectrum {(bsz, nn_, nn_)} (route {route}): "
              f"sweeps=12 vs plain {plain_rel:.3g} (tol 1e-4), eig {eig_err:.3g} recon "
              f"{rec_err:.3g} orth {orth_err:.3g} (tol {tol}); sweeps=6 eig vs "
              f"LAPACK {eig6_err:.3g}")

    # K3's ping-pong route at every even n it takes (4..96: one, two and
    # three 2x2 blocks per thread, odd and even h) on random PSD Grams,
    # converged (sweeps=12): the plain version's eigenvalues and vectors bit
    # for bit (the route rounds every operation as the plain version's torch
    # ops do), and within 1e-4 of max|w|, V orthogonal within 1e-4 (the
    # wide-spectrum bound above n = 48)
    worst, us_by_n = (0.0, 0.0), {}
    for nn_ in range(4, 97, 2):
        x = torch.randn((4, nn_, nn_), device=dev, generator=gen)
        a = x @ x.transpose(-1, -2) / nn_
        us_by_n[nn_] = round(kernel_ms(lambda: _jacobi_raw_cuda(a, 6), dev)
                             * 1e3 / ((nn_ - 1) * 6), 4)
        w, vec = kernel_jacobi_eigh(a, sweeps=12)
        wp, vp = jacobi.jacobi_eigh(a, sweeps=12)
        torch.cuda.synchronize()
        exact = torch.equal(w, wp) and torch.equal(vec, vp)
        plain_rel = ((w - wp).abs().amax(-1) / wp.abs().amax(-1)).max().item()
        orth_err = eig_residuals(w, vec, a)[1]
        if not (eigh_route(nn_) == "pingpong" and exact and plain_rel <= 1e-4
                and orth_err <= 1e-4):
            raise AssertionError(
                f"jacobi_eigh n={nn_} route {eigh_route(nn_)}: bit for bit "
                f"{exact}, vs plain {plain_rel} orth {orth_err} (tol 1e-4)")
        worst = (max(worst[0], plain_rel), max(worst[1], orth_err))
    print(f"kernel jacobi_eigh ping-pong route at every even n 4..96 (4, n, n) "
          f"sweeps=12: bit for bit the plain version's, vs plain {worst[0]:.3g}, "
          f"orth {worst[1]:.3g} (tol 1e-4); "
          f"device us per rotation step at sweeps=6 by n {us_by_n}")

    # K3's packed_log route (96 < n <= 238: K5's packed kernel writing each
    # step's rotations to a log, then V^T replayed from it column by
    # column) on wide-spectrum Grams, converged (sweeps=12), odd n padded:
    # within 1e-4 of max|w| of the plain version, V orthogonal and
    # A = V diag(w) V^T within 1e-4 (about 1,500 and 2,000 rotation steps;
    # the fp32 floor grows with them, 3.4e-5 at n = 96); its eigenvalues
    # K5's bits on the same input; the eigenvalue error against float64
    # LAPACK is reported. Timed at (4, 128, 128).
    for bsz, nn_ in [(4, 128), (3, 167)]:
        x = torch.randn((bsz, nn_, 2 * nn_), device=dev, generator=gen)
        x = x * torch.logspace(0, -3, 2 * nn_, device=dev)
        a = x @ x.transpose(-1, -2)
        w, vec = kernel_jacobi_eigh(a, sweeps=12)
        wp, _ = jacobi.jacobi_eigh(a, sweeps=12)
        w64 = torch.linalg.eigvalsh(a.double()).flip(-1)
        torch.cuda.synchronize()
        scale = w64.abs().amax(-1)
        plain_rel = ((w - wp).abs().amax(-1) / scale).max().item()
        eig_err = ((w.double() - w64).abs().amax(-1) / scale).max().item()
        rec_err, orth_err = eig_residuals(w, vec, a)
        route = eigh_route(nn_ + nn_ % 2)
        same = equals_k5(a, 12)
        if not (route == "packed_log" and same and plain_rel <= 1e-4 and rec_err <= 1e-4
                and orth_err <= 1e-4):
            raise AssertionError(
                f"jacobi_eigh {(bsz, nn_, nn_)} route {route}: w equals K5's {same}, vs "
                f"plain {plain_rel} recon {rec_err} orth {orth_err} (tol 1e-4)")
        row = report["jacobi_eigh"][f"wide spectrum ({bsz}, {nn_}, {nn_})"] = dict(
            max_abs_err=(w - wp).abs().max().item(), rel_err=plain_rel,
            eig_err=eig_err, recon_err=rec_err, orth_err=orth_err, route=route,
            w_equals_k5=same, **(jacobi_timing(a) if nn_ == 128 else {}))
        timing = (f"; ms {row['ms']:.4f} (device {row['device_ms']:.4f}, "
                  f"{row['us_per_step']:.3f} us per step at sweeps=6; K5 alone "
                  f"{row['k5_device_ms']:.4f}) plain {row['plain_ms']:.4f} linalg.eigh "
                  f"{row['library_ms']:.4f} bound {row['bound_ms']:.5f} ({row['bound_by']})"
                  if "ms" in row else "")
        print(f"kernel jacobi_eigh wide spectrum {(bsz, nn_, nn_)} (route {route}, "
              f"packed A, rotation log, V^T replay): sweeps=12 w bit for bit K5's; vs "
              f"plain {plain_rel:.3g} (tol 1e-4), recon {rec_err:.3g} orth {orth_err:.3g} "
              f"(tol 1e-4), eig vs LAPACK {eig_err:.3g}{timing}")

    # K4 on fp32 (B, n, n, C) images with rows that cover every geometric
    # op at its extremes (`time_warp.edge_ops`: shear +-0.99, translate
    # +-32, rotate +-135 and +-45 degrees, exact quarter turns), a
    # fractional translation and identity, each with and without the hflip:
    # every route rounds as the plain version's torch ops, so every row is
    # bit-identical to it, and identity parameters give the input. The
    # quarter-turn picked on the card must be the CPU's (the +-135 degree
    # tie of angle / (pi/2)). Each case prints its route (`warp_route`).
    warp_ops = time_warp.edge_ops()

    def warp_check(b, n, c, ops):
        vals, flip = time_warp.edge_mix(b, ops)
        p_cpu = wk.warp_params(*vals, flip)
        params = wk.warp_params(*(v.to(dev) for v in vals), flip.to(dev))
        if not torch.equal(params[:, 5].cpu(), p_cpu[:, 5]):
            raise AssertionError(f"warp quarter-turns: card {params[:, 5].tolist()} "
                                 f"cpu {p_cpu[:, 5].tolist()}")
        x = torch.rand((b, n, n, c), device=dev, generator=gen)
        got = wk._warp_cuda(x, params)
        want = wk.geometric_warp_plain(x, params)
        z = torch.zeros(b, device=dev)
        ident = wk._warp_cuda(x, wk.warp_params(z, z, z, z, z))
        torch.cuda.synchronize()
        route = wk.warp_route(n, c)
        err = (got - want).abs().max().item()
        turns = int(((params[:, :5] == 0).all(dim=1) & (params[:, 5] != 0)).sum())
        if not (torch.equal(got, want) and torch.equal(ident, x)):
            raise AssertionError(
                f"warp {(b, n, n, c)} route {route}: max err {err} (bit-identical "
                f"required), identity exact {torch.equal(ident, x)}")
        bnd, by = bound(2 * x.numel() * 4, 9 * x.numel(), f32)
        print(f"kernel warp {(b, n, n, c)} route {route}: bit-identical to the plain "
              f"version ({b} rows, {turns} exact quarter-turns) and identity exact")
        return x, params, dict(max_abs_err=err, route=route, bound_ms=bnd, bound_by=by,
                               library_ms=None)

    report["warp"] = {}
    for label, b, n in (("main path", batch, img), ("reference default", 256, 224)):
        x, params, row = warp_check(b, n, 3, warp_ops)
        small = n == img
        row.update(ms=timed_ms(lambda: wk._warp_cuda(x, params), 200 if small else 20),
                   device_ms=kernel_ms(lambda: wk._warp_cuda(x, params), dev),
                   plain_ms=timed_ms(lambda: wk.geometric_warp_plain(x, params),
                                     5 if small else 1))
        report["warp"][f"{label} {(b, n, n, 3)}"] = row
        print(f"kernel warp {label} {(b, n, n, 3)} route {row['route']}: ms "
              f"{row['ms']:.4f} (device {row['device_ms']:.5f}) plain "
              f"{row['plain_ms']:.4f} bound {row['bound_ms']:.5f} ({row['bound_by']}); "
              "no PyTorch call computes the same three-shear warp")
        del x, params
    pick = lambda *keys: [op for op in warp_ops if op in keys]
    full = 2 * len(warp_ops)
    edges = [(4, 224, 3, pick(("shear_x", 0.99), ("angle", 135))),
             (4, 224, 3, pick(("trans_y", -32.0), ("angle", -45))),
             (full, 96, 3, warp_ops), (full, 33, 3, warp_ops), (full, 7, 1, warp_ops),
             (4, 1, 3, warp_ops), (2, 240, 1, pick(("angle", 90))),
             # each route's edges: one CTA per sample to n = 139 at C = 3; a
             # cluster above, with 16-byte DSMEM moves where n % 4 == 0 and
             # the aligned rows fit (140, 236), 4-byte ones at odd n and at
             # n = 240 (141, 240 with C = 8, the largest cluster); one CTA per
             # sample and channel beyond 8 channels
             (full, 139, 3, warp_ops), (full, 140, 3, warp_ops),
             (full, 141, 3, warp_ops), (full, 236, 3, warp_ops),
             (full, 240, 8, warp_ops), (full, 200, 9, warp_ops)]
    for b, n, c, ops in edges:
        _, _, row = warp_check(b, n, c, ops)
        report["warp"][f"edge {(b, n, n, c)} {ops[0][0]}"] = row

    # ---- slice 3: the tool paths' kernels (K5, K3 at n = 192, K6) ----
    # K5 on the spectral tuner's own token covariances, and at an odd n
    # (191, a principal submatrix): against its plain version at sweeps 9
    # within 1e-4 of max|w| (the same rotations; at fewer sweeps the
    # unconverged eigenvalues amplify rounding differences), against
    # float64 LAPACK (reported), and the Marchenko-Pastur ranks equal to
    # LAPACK's at sweeps 9. The tuner's covariances are staged once, here;
    # the tuner's run in phase 5b reuses them and times the kernel there.
    def eigvals_timing(a, sweeps, kernel):
        bsz, nn_ = a.shape[0], a.shape[-1]
        n_even = nn_ + nn_ % 2
        # per step: the 2x2 block rotations of A's upper block triangle (A is
        # symmetric), h (h + 1) / 2 blocks of 24 flops, h = n / 2: 3 n (n + 2)
        flops = bsz * (n_even - 1) * sweeps * 3 * n_even * (n_even + 2)
        bnd, by = bound(4 * bsz * (nn_ * nn_ + nn_), flops, f32)
        row = dict(
            plain_ms=timed_ms(lambda: jacobi.jacobi_eigvals(a, sweeps=sweeps), 1),
            library_ms=timed_ms(lambda: torch.linalg.eigvalsh(a), 5),
            bound_ms=bnd, bound_by=by,
        )
        if kernel:
            row["ms"] = timed_ms(lambda: kernel_jacobi_eigvals(a, sweeps=sweeps), 10)
        return row

    staged = tune_spectral.stage(device=dev)
    cov, m_tok = staged["cov"], staged["m"]
    for what, a in (("tune_spectral covariances", cov),
                    ("odd n", cov[:4, :191, :191].contiguous())):
        bsz, nn_ = a.shape[0], a.shape[-1]
        w = kernel_jacobi_eigvals(a, sweeps=9)
        w3 = kernel_jacobi_eigvals(a, sweeps=3)
        wp = jacobi.jacobi_eigvals(a, sweeps=9)
        w64 = torch.linalg.eigvalsh(a.double())
        torch.cuda.synchronize()
        scale = w64.abs().amax(-1)
        plain_rel = ((w - wp).abs().amax(-1) / scale).max().item()
        eig_err = ((w.double() - w64).abs().amax(-1) / scale).max().item()
        eig3_err = ((w3.double() - w64).abs().amax(-1) / scale).max().item()
        ranks = tune_spectral.mp_ranks(w.double().cpu().numpy(), m_tok)
        ranks64 = tune_spectral.mp_ranks(w64.cpu().numpy(), m_tok)
        route = eigvals_route(nn_ + nn_ % 2)
        if not (plain_rel <= 1e-4 and (ranks == ranks64).all()):
            raise AssertionError(
                f"jacobi_eigvals {what} {(bsz, nn_, nn_)} route {route}: vs plain "
                f"{plain_rel} (tol 1e-4), MP ranks {ranks.tolist()} vs LAPACK "
                f"{ranks64.tolist()}")
        a_even = jacobi.symmetrize_pad(a)[0].contiguous()
        row = dict(max_abs_err=(w - wp).abs().max().item(), rel_err=plain_rel,
                   eig_err=eig_err, eig3_err=eig3_err, mp_ranks=ranks.tolist(),
                   route=route,
                   device_ms=kernel_ms(lambda: _jacobi_eigvals_raw_cuda(a_even, 9), dev),
                   **eigvals_timing(a, 9, kernel=what == "odd n"))
        row["us_per_step"] = row["device_ms"] * 1e3 / ((a_even.shape[-1] - 1) * 9)
        report.setdefault("jacobi_eigvals", {})[f"{what} ({bsz}, {nn_}, {nn_})"] = row
        ms = f"{row['ms']:.4f}" if "ms" in row else "(phase 5b)"
        print(f"kernel jacobi_eigvals {what} {(bsz, nn_, nn_)} sweeps=9 (route {route}): "
              f"vs plain {plain_rel:.3g} (tol 1e-4); vs LAPACK {eig_err:.3g} (sweeps=3 "
              f"{eig3_err:.3g}); MP ranks {ranks.tolist()} equal LAPACK's; ms "
              f"{ms} (device {row['device_ms']:.4f}, {row['us_per_step']:.3f} us per "
              f"step) plain {row['plain_ms']:.4f} linalg.eigvalsh "
              f"{row['library_ms']:.4f} bound {row['bound_ms']:.5f} ({row['bound_by']})")
    # K5 at the smallest and largest n of each route on random PSD Grams at
    # sweeps 9: within 1e-4 of max|w| of the plain version (the packed
    # route rotates the upper block triangle, so it rounds otherwise than
    # the plain version's full matrix); n = 238 is the largest n whose two
    # buffers fit a CTA
    for nn_ in (4, 238, 192):
        x = torch.randn((4, nn_, nn_), device=dev, generator=gen)
        a = x @ x.transpose(-1, -2) / nn_
        w = kernel_jacobi_eigvals(a, sweeps=9)
        wp = jacobi.jacobi_eigvals(a, sweeps=9)
        torch.cuda.synchronize()
        plain_rel = ((w - wp).abs().amax(-1) / wp.abs().amax(-1)).max().item()
        route = eigvals_route(nn_)
        if not plain_rel <= 1e-4:
            raise AssertionError(f"jacobi_eigvals n={nn_} route {route}: vs plain "
                                 f"{plain_rel} (tol 1e-4)")
        report["jacobi_eigvals"][f"route edge (4, {nn_}, {nn_})"] = dict(
            max_abs_err=(w - wp).abs().max().item(), rel_err=plain_rel, route=route)
        print(f"kernel jacobi_eigvals route edge (4, {nn_}, {nn_}) sweeps=9 (route "
              f"{route}): vs plain {plain_rel:.3g} (tol 1e-4)")

    # K3 through its packed_log route at n = 192 on the sweeps probe's two
    # spectrum families: against its plain version at sweeps 12 within
    # 1e-4 of max|w|, V orthogonal and A = V diag(w) V^T within 2e-4 (about
    # 2,300 rotations in fp32; a log replayed a step off gives a
    # reconstruction error of order 1), its eigenvalues K5's bits at sweeps
    # 6 and 12; the eigenvalue errors against float64 LAPACK at sweeps 6 and
    # 12 are reported. Device time here; the sweeps probe reads its event
    # loop in phase 5b.
    cases = probe_jacobi_sweeps.make_cases(48, 192, np.random.default_rng(0))
    for family, a64 in cases.items():
        a = torch.from_numpy(a64.astype(np.float32)).to(dev)
        w6, _ = kernel_jacobi_eigh(a, sweeps=6)
        w, vec = kernel_jacobi_eigh(a, sweeps=12)
        wp, _ = jacobi.jacobi_eigh(a, sweeps=12)
        w64 = torch.from_numpy(np.linalg.eigvalsh(a64)).to(dev).flip(-1)
        torch.cuda.synchronize()
        scale = w64.abs().amax(-1)
        plain_rel = ((w - wp).abs().amax(-1) / scale).max().item()
        eig_err = ((w.double() - w64).abs().amax(-1) / scale).max().item()
        eig6_err = ((w6.double() - w64).abs().amax(-1) / scale).max().item()
        rec_err, orth_err = eig_residuals(w, vec, a)
        same = equals_k5(a, 6) and equals_k5(a, 12)
        if not (same and plain_rel <= 1e-4 and orth_err <= 2e-4 and rec_err <= 2e-4):
            raise AssertionError(
                f"jacobi_eigh n=192 {family}: w equals K5's {same}, vs plain {plain_rel} "
                f"(tol 1e-4), orth {orth_err} recon {rec_err} (tol 2e-4)")
        row = dict(max_abs_err=(w - wp).abs().max().item(), rel_err=plain_rel,
                   eig6_err=eig6_err, eig_err=eig_err, recon_err=rec_err,
                   orth_err=orth_err, route=eigh_route(192), w_equals_k5=same)
        for sw in (6, 12):
            row.update({f"{k}_sweeps{sw}": v
                        for k, v in jacobi_timing(a, sw, kernel=False).items()})
        report["jacobi_eigh"][f"{family} (48, 192, 192)"] = row
        print(f"kernel jacobi_eigh {family} (48, 192, 192) (route {row['route']}, "
              "packed A, rotation log, V^T replay): w bit for bit K5's at sweeps 6 and "
              f"12; sweeps=12 vs plain {plain_rel:.3g} (tol 1e-4), orth {orth_err:.3g} "
              f"recon {rec_err:.3g} (tol 2e-4), eig vs LAPACK {eig_err:.3g}; "
              f"sweeps=6 eig vs LAPACK {eig6_err:.3g}; device "
              f"{row['device_ms_sweeps6']:.4f} / {row['device_ms_sweeps12']:.4f} "
              f"({row['us_per_step_sweeps6']:.3f} us per step; K5 alone "
              f"{row['k5_device_ms_sweeps6']:.4f} / {row['k5_device_ms_sweeps12']:.4f}) "
              f"plain {row['plain_ms_sweeps6']:.4f} / {row['plain_ms_sweeps12']:.4f} "
              f"(sweeps 6 / 12) "
              f"linalg.eigh {row['library_ms_sweeps6']:.4f} bound "
              f"{row['bound_ms_sweeps6']:.5f} / {row['bound_ms_sweeps12']:.5f} "
              f"({row['bound_by_sweeps6']})")

    # K6 in all six variants at the teacher's attention shape, on the
    # attention probe's own inputs: each output element within one bf16 ulp of its row's max |o| of the
    # plain version's. The tensor cores sum s in another order than the
    # plain version's cuBLAS fp32 product, so a bf16 e may land on the
    # neighbouring value, and a change of one ulp of one e moves o by up to
    # that ulp times |v|: where o = e v cancels to much less than its terms,
    # that is more than one ulp of o's own value (1,205 of 50.5 M elements of
    # `full` on the card), so the count of such elements is printed beside
    # the check. Device time per variant by `kernel_ms` (tilemax's two launches together). No
    # PyTorch call computes these variants; SDPA, softmax attention on the
    # same q, k, v, is timed beside them as the reference. The attention
    # probe reads the kernel's and K1's event loops in phase 5b.
    pb, ph, pn, phd = 256, 12, 257, 64
    q6, k6, v6 = probe_attn_internals.make_inputs(pb, ph, pn, phd, dev)
    nbytes = 4 * q6.numel() * q6.element_size()
    bnd6, by6 = bound(nbytes, attn_probe.probe_flops(pb, ph, pn, phd), bf16)
    native = lambda x: x.transpose(1, 2).reshape(pb, pn, ph * phd).contiguous()
    q6s = q6 * phd**-0.5
    qn, kn, vn = native(q6s), native(k6), native(v6)
    k1_plain_ms = timed_ms(lambda: attn.attention_forward_plain(qn, kn, vn, phd), 2)
    k1_bnd, k1_by = bound(nbytes + 2 * pb * pn * ph * 4,
                          attn_probe.probe_flops(pb, ph, pn, phd), bf16)
    sdpa6 = lambda: F.scaled_dot_product_attention(q6s, k6, v6, scale=1.0)
    sdpa_ms = timed_ms(sdpa6, 10)
    # K1 on the probe's q, k, v: checked and timed on the device here, its
    # event-loop time is the probe's reading (phase 5b)
    t1_case = f"Table-1 teacher B={pb} N={pn} D={ph * phd} H={ph} bfloat16"
    got = attn._attention_forward_cuda(qn, kn, vn, phd)
    want = attn.attention_forward_plain(qn, kn, vn, phd)
    torch.cuda.synchronize()
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    worst = max(e[1] for e in errs)
    if not worst <= 2e-2:
        raise AssertionError(f"attention_fwd {t1_case}: rel err {worst} > 2e-2")
    row = report["attention_fwd"][t1_case] = dict(
        shape=[pb, pn, ph * phd], heads=ph, dtype="bfloat16",
        max_abs_err=max(e[0] for e in errs), rel_err=worst, tol=2e-2,
        plain_ms=k1_plain_ms, library_ms=sdpa_ms, bound_ms=k1_bnd, bound_by=k1_by,
        device_ms=kernel_ms(lambda: attn._attention_forward_cuda(qn, kn, vn, phd), dev),
        library_device_ms=kernel_ms(sdpa6, dev))
    del got, want
    print(f"kernel attention_fwd {t1_case}: rel err {worst:.3g} (tol 2e-2) device "
          f"{row['device_ms']:.4f} sdpa {sdpa_ms:.4f} (device "
          f"{row['library_device_ms']:.4f}) bound {k1_bnd:.4f} ({k1_by}); "
          "event-loop ms in phase 5b")
    def bf16_ulp(x):
        return torch.exp2(torch.floor(torch.log2(x.clamp(min=1e-30))) - 7)

    def probe_check(q, k, v, variant, what):
        """K6 against its plain version: every element within one bf16 ulp
        of its row's max |o|; returns the kernel's output and its errors,
        with the count of elements more than one ulp of their own value."""
        got = attn_probe.probe_attention(q, k, v, variant=variant)
        want = attn_probe.probe_attention_plain(q, k, v, variant=variant).float()
        torch.cuda.synchronize()
        diff = (got.float() - want).abs()
        row_ulp = bf16_ulp(want.abs().amax(-1, keepdim=True))
        if not bool((diff <= row_ulp).all()):
            raise AssertionError(
                f"attn_probe {variant} {what}: {int((diff > row_ulp).sum())} elements more "
                f"than one bf16 ulp of their row's max |o| from the plain version (max "
                f"{diff.max().item()})")
        return got, dict(max_abs_err=diff.max().item(), differing=int((diff > 0).sum()),
                         over_own_ulp=int((diff > bf16_ulp(want.abs())).sum()))

    for variant in attn_probe.VARIANTS:
        got, row = probe_check(q6, k6, v6, variant, (pb, ph, pn, phd))
        del got
        row.update(
            device_ms=kernel_ms(lambda: attn_probe._probe_cuda(q6, k6, v6, variant, 8), dev),
            plain_ms=timed_ms(lambda: attn_probe.probe_attention_plain(
                q6, k6, v6, variant=variant), 2),
            library_ms=None, k1_plain_ms=k1_plain_ms,
            k1_bound_ms=k1_bnd, sdpa_ms=sdpa_ms, bound_ms=bnd6, bound_by=by6,
        )
        report.setdefault("attn_probe", {})[f"{variant} {(pb, ph, pn, phd)}"] = row
        print(f"kernel attn_probe {variant} {(pb, ph, pn, phd)}: "
              f"max abs err {row['max_abs_err']:.3g} ({row['differing']} elements differ, "
              f"{row['over_own_ulp']} by more than one bf16 ulp of their own value; tol 1 "
              f"bf16 ulp of the row's max |o|); device {row['device_ms']:.4f} plain "
              f"{row['plain_ms']:.4f} bound {bnd6:.4f} ({by6}); K1 fwd plain "
              f"{k1_plain_ms:.4f}, bound {k1_bnd:.4f}; sdpa {sdpa_ms:.4f} at ({pb}, {pn}, "
              f"{ph * phd}) H={ph}")
    del cov, q6, k6, v6, q6s, qn, kn, vn
    # K6 at the largest N (1024) and at an N with a partial chunk of v and
    # of the last query block (300), every variant within the same tolerance
    for n in (1024, 300):
        qkv = probe_attn_internals.make_inputs(16, 2, n, phd, dev, seed=n)
        for variant in attn_probe.VARIANTS:
            _, row = probe_check(*qkv, variant, (16, 2, n, phd))
            report["attn_probe"][f"{variant} {(16, 2, n, phd)}"] = row
            print(f"kernel attn_probe {variant} {(16, 2, n, phd)}: "
                  f"max abs err {row['max_abs_err']:.3g}, {row['over_own_ulp']} elements by "
                  "more than one bf16 ulp of their own value (tol 1 bf16 ulp of the row's "
                  "max |o|)")
        del qkv

    # ---- 5. the main path: bench.py's augmented step, then augment=False ----
    def teacher_layers(tch) -> int:
        """Token layers a teacher gives: every block of a ViT, one for a CNN."""
        return tch.spec.depth if tch.spec.feature_format == "token" else 1

    def per_step_launches(scfg, tch, pts, k, augment) -> dict:
        """Each kernel's launches in one train step of a configuration: K1 in
        every block, teacher's and student's, of a ViT with a CLS token inside
        the kernel gate (a student block twice under remat: its forward runs
        again in the backward), K2 in every such student block, K3 in each of
        the selector's three eighs (teacher and student Rayleigh-Ritz, the
        principal angles) that the Jacobi gate takes, K4 once per augmented
        view."""
        def fused_blocks(c):
            ok = c.has_cls_token and attn.supports_fused(
                c.num_patches + 1, c.embed_dim, c.embed_dim // c.num_heads)
            return c.depth if ok else 0

        student_blocks = fused_blocks(scfg)
        teacher_blocks = fused_blocks(tch.module.config) if tch.spec.family == "vit" else 0
        l, p = teacher_layers(tch), len(pts)
        return {"attention_fwd": student_blocks * (2 if scfg.remat else 1) + teacher_blocks,
                "attention_bwd": student_blocks,
                "jacobi_eigh": sum(use_jacobi(sh) for sh in ((l, k, k), (p, k, k), (p, l, k, k))),
                "warp": int(augment), "jacobi_eigvals": 0, "attn_probe": 0}

    def run_steps(label, stu, tch, sel, pts, k, size, raw_size, ims, lbs, ncls, augment,
                  steps):
        """`steps` train steps of bench.py's step (augment=True) or the
        deterministic one, with the counters reset just before and read just
        after: every step checked (finite loss, (P, L) mixing weights whose
        rows sum to 1, MP ranks in [1, K], its exact launches)."""
        init_fn, step_fn = make_train_step(
            stu, tch,
            learning_rate=5e-4, weight_decay=0.05, warmup_steps=1000,
            label_smoothing=0.01, img_size=size, crop_ratio=size / raw_size,
            teacher_stats=TEACHER_STATS, dataset_stats=DATASET_STATS,
            num_classes=ncls, subspace_k=k, augment=augment,
        )
        state = init_fn(0, sel)
        per_step = per_step_launches(stu.config, tch, pts, k, augment)
        weights_shape = (len(pts), teacher_layers(tch))
        step_ms = []
        torch.cuda.synchronize()
        kernels.reset_launches()
        for i in range(steps):
            before = dict(kernels.LAUNCHES)
            t0 = time.perf_counter()
            state, met = step_fn(state, ims, lbs)
            loss = float(met["loss"])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            w = met["mixing_weights"]
            ranks = met["mp_ranks"]
            if not np.isfinite(loss):
                raise AssertionError(f"{label} step {i}: loss {loss}")
            if tuple(w.shape) != weights_shape or \
                    (w.sum(-1) - 1).abs().max().item() > 1e-5:
                raise AssertionError(f"{label} step {i}: mixing weights {w}")
            if ranks.min().item() < 1 or ranks.max().item() > k:
                raise AssertionError(f"{label} step {i}: mp_ranks {ranks.tolist()}")
            counts = {n: kernels.LAUNCHES[n] - before[n] for n in per_step}
            if counts != per_step:
                raise AssertionError(f"{label} step {i} (augment={augment}): launches "
                                     f"{counts}, expected {per_step}")
            print(f"{label} step {i} (augment={augment}): loss {loss:.6f} ce "
                  f"{float(met['ce_loss']):.6f} geo {float(met['geo_loss']):.6f} "
                  f"temps {[round(t, 6) for t in met['temperatures'].tolist()]} "
                  f"mp_ranks {ranks.tolist()} K {k} ms {step_ms[-1]:.2f}")
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        for name, want in per_step.items():
            if launches[name] != want * steps:
                raise AssertionError(
                    f"{label} {name}: {launches[name]} launches in {steps} steps "
                    f"(augment={augment}), expected {want} per step")
        print(f"{label} (augment={augment}): launches {launches} over {steps} "
              f"steps, per step {per_step}; step ms {step_ms} (median after the "
              f"first {np.median(step_ms[1:]):.2f}); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        return step_fn, state, launches, step_ms

    # Table-3's launches per step, as every earlier run counted them
    table3 = {"attention_fwd": 24, "attention_bwd": 12,
              "jacobi_eigh": 3 if k3_on_path else 0, "warp": 1,
              "jacobi_eigvals": 0, "attn_probe": 0}
    if per_step_launches(cfg, teacher, points, k_cal, True) != table3:
        raise AssertionError(f"Table-3 launches per step "
                             f"{per_step_launches(cfg, teacher, points, k_cal, True)}")
    if not k3_on_path:
        print(f"finding: calibrated K={k_cal} is outside the Jacobi gate, "
              "the eigh kernel is off the main path")
    # the deterministic path first: phase 7 profiles the augmented state
    main_args = (student, teacher, selector, points, k_cal, img, raw, images, labels,
                 num_classes)
    _, _, _, det_step_ms = run_steps("main path", *main_args, False, DETERMINISTIC_STEPS)
    step_fn, state, launches, step_ms = run_steps("main path", *main_args, True,
                                                  MAIN_STEPS)

    # ---- 5b. the tool paths at full size, each through its kernels ----
    def tool_path(name, run, needs):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        counts = dict(kernels.LAUNCHES)
        for kname in needs:
            if counts[kname] == 0:
                raise AssertionError(f"{name}: no {kname} launch in {counts}")
        print(f"path {name}: launches {counts}; "
              f"{time.perf_counter() - t0:.1f} s")
        return result, counts

    path_launches = {"train_step": launches}
    tune, path_launches["tune_spectral"] = tool_path(
        "tune_spectral", lambda: tune_spectral.main(device=dev, staged=staged),
        ("jacobi_eigvals", "jacobi_eigh"))
    if not {r["sweeps"]: r for r in tune["k5"]}[9]["ranks_equal"]:
        raise AssertionError(f"tune_spectral: K5 MP ranks at sweeps 9 {tune['k5']}")
    sweep_rows, path_launches["probe_jacobi_sweeps"] = tool_path(
        "probe_jacobi_sweeps", lambda: probe_jacobi_sweeps.main(device=dev),
        ("jacobi_eigh",))
    # converged (sweeps 12), the eigenvalues in [0, 1] sit at the fp32 floor
    worst12 = max(r["eig_err"] for r in sweep_rows if r["sweeps"] == 12)
    if not worst12 <= 2e-4:
        raise AssertionError(f"probe_jacobi_sweeps: sweeps 12 eig_err {worst12}")
    probe, path_launches["probe_attn_internals"] = tool_path(
        "probe_attn_internals", lambda: probe_attn_internals.main(device=dev),
        ("attn_probe", "attention_fwd"))
    # one check call and 2 + 10 timed calls per variant; tilemax launches twice
    want = 13 * (len(attn_probe.VARIANTS) + 1)
    if path_launches["probe_attn_internals"]["attn_probe"] != want:
        raise AssertionError(f"probe_attn_internals: attn_probe launches "
                             f"{path_launches['probe_attn_internals']} != {want}")
    # the kernels' times at the tools' shapes are the tools' own readings;
    # the sweeps probe times K3 on the uniform family
    report["jacobi_eigvals"]["tune_spectral covariances (12, 192, 192)"]["ms"] = \
        {r["sweeps"]: r["ms"] for r in tune["k5"]}[9]
    k3_ms = {r["sweeps"]: r["ms"] for r in sweep_rows}
    for sw in (6, 12):
        report["jacobi_eigh"]["uniform (48, 192, 192)"][f"ms_sweeps{sw}"] = k3_ms[sw]
    for variant, ms in probe["variants"].items():
        report["attn_probe"][f"{variant} {(pb, ph, pn, phd)}"].update(
            ms=ms, k1_ms=probe["attention_fwd"])
    report["attention_fwd"][t1_case]["ms"] = probe["attention_fwd"]

    # ---- 5c. the 224 px steps: Table-1 and Table-2 at full width ----
    # bench.py's `--imagenet --teacher dinov2_vitl14` and `--cross-arch`
    # arms, staged as it stages them: bf16 models from seeds, batch 256 of
    # 256 px uint8 images from default_rng(0) (crop ratio 224/256), 1000
    # classes, drop_path 0.05, no remat, K calibrated on the eval view; 1 + 2
    # augmented steps, the first carrying the one-off set-up. Staging time
    # is printed: the weights are drawn on a CPU generator (about 304 M
    # values for ViT-L) and copied to the card.
    def stage_224(label, teacher_name, student_name):
        size, bsz, ncls, spatch = 224, 256, 1000, 16
        raw_size = size + 2 * spatch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tch = load_teacher(teacher_name, img_size=size, dtype=bf16, device=dev)
        t_teacher = time.perf_counter() - t0
        pts = extraction_points(12, 4)
        t0 = time.perf_counter()
        stu, scfg = create_student(
            student_name, num_classes=ncls, drop_path_rate=0.05, img_size=size,
            capture_layers=pts, dtype=bf16, remat=False, device=dev)
        t_student = time.perf_counter() - t0
        sel = init_selector(1, len(pts), scfg.embed_dim, tch.spec.embed_dim, device=dev)
        r = np.random.default_rng(0)
        ims = torch.from_numpy(
            (r.random((bsz, raw_size, raw_size, 3)) * 255).astype(np.uint8)).to(dev)
        lbs = torch.from_numpy(r.integers(0, ncls, bsz, dtype=np.int64)).to(dev)
        t0 = time.perf_counter()
        cal = eval_view(ims, size, size / raw_size, *TEACHER_STATS)
        k = calibrate_subspace_k(tch, scfg.embed_dim, cal, seed=0,
                                 num_extraction_points=len(pts))
        torch.cuda.synchronize()
        t_k = time.perf_counter() - t0
        del cal
        per_step = per_step_launches(scfg, tch, pts, k, True)
        print(f"staging {label}: teacher {teacher_name} D={tch.spec.embed_dim} "
              f"layers={teacher_layers(tch)} tokens={tch.num_tokens}; student "
              f"{student_name} D={scfg.embed_dim} heads={scfg.num_heads} "
              f"tokens={scfg.num_patches + 1}; batch {bsz} at {size} px; K={k} "
              f"(Jacobi kernel gate 16 <= K <= 96: {use_jacobi((len(pts), k, k))}; K3 "
              f"{'on' if per_step['jacobi_eigh'] else 'off'} the path, "
              f"{per_step['jacobi_eigh']} launches per step); staging s: teacher "
              f"{t_teacher:.2f} student {t_student:.2f} calibration {t_k:.2f}")
        fn, st, counts, ms = run_steps(label, stu, tch, sel, pts, k, size, raw_size,
                                       ims, lbs, ncls, True, 1 + STEPS_224)
        if per_step["jacobi_eigh"]:
            # K3 at this step's (P, K, K) shape (the student Rayleigh-Ritz and
            # the principal angles: P = 4, one teacher layer) on a random PSD
            # Gram, timed beside the plain version and torch.linalg.eigh; the
            # ping-pong route's bit-for-bit check at every even n covers it
            x = torch.randn((len(pts), k, k), device=dev, generator=gen)
            a = x @ x.transpose(-1, -2) / k
            w, _ = kernel_jacobi_eigh(a, sweeps=6)
            wp, _ = jacobi.jacobi_eigh(a, sweeps=6)
            torch.cuda.synchronize()
            row = dict(max_abs_err=(w - wp).abs().max().item(),
                       rel_err=((w - wp).abs().amax(-1) / wp.abs().amax(-1)).max().item(),
                       route=eigh_route(k), **jacobi_timing(a))
            if not row["rel_err"] <= 1e-4:
                raise AssertionError(f"jacobi_eigh {label} (4, {k}, {k}): {row}")
            report["jacobi_eigh"][f"{label} ({len(pts)}, {k}, {k})"] = row
            print(f"kernel jacobi_eigh {label} ({len(pts)}, {k}, {k}) (route "
                  f"{row['route']}): vs plain {row['rel_err']:.3g} (tol 1e-4); ms "
                  f"{row['ms']:.4f} (device {row['device_ms']:.4f}, "
                  f"{row['us_per_step']:.3f} us per step) plain {row['plain_ms']:.4f} "
                  f"linalg.eigh {row['library_ms']:.4f} bound {row['bound_ms']:.5f} "
                  f"({row['bound_by']})")
        return dict(teacher=tch, images=ims, labels=lbs, step_fn=fn, state=st,
                    launches=counts, step_ms=ms, k=k, per_step=per_step,
                    peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                    staging_s=dict(teacher=t_teacher, student=t_student,
                                   calibration=t_k),
                    size=size, raw=raw_size, patch=spatch)

    table1 = stage_224("Table-1", "dinov2_vitl14", "vit_small_patch16")
    # the ViT-L teacher's intrinsic dimension on ceil(10 D / 196) eval-view
    # images, as the JAX trainer sizes its calibration set, and the student
    # it would derive (no arch_overrides)
    tch = table1["teacher"]
    n_cal = -(-10 * tch.spec.embed_dim // (table1["size"] // table1["patch"]) ** 2)
    t0 = time.perf_counter()
    idim = estimate_intrinsic_dim(tch, eval_view(
        table1["images"][:n_cal], table1["size"], table1["size"] / table1["raw"],
        tch.mean, tch.std))
    t_idim = time.perf_counter() - t0
    arch = derive_student_arch(tch.spec, idim)
    if not 1 <= idim <= tch.spec.embed_dim:
        raise AssertionError(f"Table-1 intrinsic dimension {idim}")
    print(f"Table-1 intrinsic dimension {idim} on {n_cal} eval-view images "
          f"({t_idim:.2f} s); derive_student_arch {arch}")
    table2 = stage_224("Table-2", "convnextv2_tiny", "vit_tiny_patch16")
    del table2["state"], table2["step_fn"], table2["teacher"]
    torch.cuda.empty_cache()
    path_launches["table1_step"] = table1["launches"]
    path_launches["table2_step"] = table2["launches"]

    # ---- 6. reference on a small input: card vs CPU plain versions ----
    # The card's and the CPU's generators give different numbers, so both
    # sides take one set of augmentation draws, sampled once on the CPU.
    def to_device(draws, device):
        if isinstance(draws, torch.Tensor):
            return draws.to(device)
        return type(draws)(*(to_device(d, device) for d in draws))

    small_gen = torch.Generator().manual_seed(7)
    small_draws = [train_step.sample_step_draws(small_gen, 8) for _ in range(2)]

    def small_run(device, teacher_name="vit_mini_patch4", size=16, remat=False,
                  drop_path=0.0):
        """Two augment=True steps of a micro student (vit_micro_patch4 at
        `size` px, batch 8, fp32) under `teacher_name`, the draws replayed
        from `small_draws`; (loss, MP ranks) per step, the augmented views
        before and after MixUp/CutMix with the soft targets, and the
        kernels' launches."""
        kernels.reset_launches()
        raw_size = size * 5 // 4
        view_kw = dict(img_size=size, crop_ratio=size / raw_size,
                       teacher_stats=TEACHER_STATS, dataset_stats=DATASET_STATS)
        t = load_teacher(teacher_name, img_size=size, dtype=f32, device=device)
        pts = extraction_points(4, 2)
        s, c = create_student("vit_micro_patch4", num_classes=10,
                              drop_path_rate=drop_path, img_size=size,
                              capture_layers=pts, dtype=f32, remat=remat,
                              device=device)
        sel = init_selector(1, len(pts), c.embed_dim, t.spec.embed_dim,
                            device=device)
        ini, stp = make_train_step(
            s, t, learning_rate=1e-3, weight_decay=0.05, warmup_steps=5,
            label_smoothing=0.1, num_classes=10, **view_kw,
        )
        st = ini(0, sel)
        r = np.random.default_rng(42)
        im = torch.from_numpy((r.random((8, raw_size, raw_size, 3)) * 255).astype(np.uint8))
        lb = torch.from_numpy(r.integers(0, 10, 8, dtype=np.int64))
        im, lb = im.to(device), lb.to(device)
        draws = [to_device(d, device) for d in small_draws]
        views = []
        for d in draws:
            _, aug = dual_view(im, d.view, **view_kw)
            views.append([aug.cpu(), *(v.cpu() for v in mixup_cutmix(
                aug, lb, d.mix, num_classes=10))])
        replay = iter(draws)
        sampler = train_step.sample_step_draws
        train_step.sample_step_draws = lambda generator, batch: next(replay)
        try:
            out = []
            for _ in draws:
                st, mt = stp(st, im, lb)
                out.append((float(mt["loss"]), mt["mp_ranks"].tolist()))
        finally:
            train_step.sample_step_draws = sampler
        if device.type == "cuda":
            torch.cuda.synchronize()
        return out, views, dict(kernels.LAUNCHES)

    quantizing = (augment_ops.OP_POSTERIZE, augment_ops.OP_SOLARIZE,
                  augment_ops.OP_AUTOCONTRAST, augment_ops.OP_EQUALIZE)

    def card_vs_cpu(what, tol=1e-5, ties=False, **kw):
        """The small run on the card and on the CPU: views and soft targets
        within `tol`, losses within rtol 1e-3, MP ranks equal. With `ties`,
        an image whose op quantizes (posterize, solarize, autocontrast,
        equalize: a floor or a threshold of a value that the card and the
        CPU round apart by an ulp) may differ by whole levels; so may a
        mixed image that holds its pixels (CutMix pastes sample i - 1 into
        sample i); the rest, and the targets, within `tol`."""
        on_card, card_views, card_launches = small_run(dev, **kw)
        on_cpu, cpu_views, _ = small_run(torch.device("cpu"), **kw)
        view_err, tie_elems, tie_err = 0.0, 0, 0.0
        for d, (aug_c, mix_c, tgt_c), (aug_p, mix_p, tgt_p) in zip(
                small_draws, card_views, cpu_views):
            q = torch.isin(d.view.augment.op, torch.tensor(quantizing))
            q_mix = q | torch.roll(q, 1) if ties else torch.zeros_like(q)
            q_aug = q if ties else torch.zeros_like(q)
            view_err = max(view_err, (tgt_c - tgt_p).abs().max().item())
            for got, want, tie in ((aug_c, aug_p, q_aug), (mix_c, mix_p, q_mix)):
                diff = (got - want).abs()
                view_err = max(view_err, diff[~tie].max().item() if (~tie).any() else 0.0)
                tie_elems += int((diff[tie] > tol).sum())
                tie_err = max(tie_err, diff[tie].max().item() if tie.any() else 0.0)
        if not view_err <= tol:
            raise AssertionError(f"reference {what}: student view / targets card vs "
                                 f"cpu {view_err} (tol {tol})")
        if ties:
            print(f"reference {what}: images whose op quantizes differ card vs cpu in "
                  f"{tie_elems} elements (max {tie_err:.3g}, normalized)")
        for (lc, rc), (lp, rp) in zip(on_card, on_cpu):
            if rc != rp or not abs(lc - lp) <= 1e-3 * abs(lp):
                raise AssertionError(f"reference {what}: card {on_card} vs cpu {on_cpu}")
        # one warp per dual_view: the views compared above, then the steps
        if card_launches["warp"] != 2 * len(small_draws):
            raise AssertionError(f"reference {what}: warp launches {card_launches}")
        ops = sorted(set(torch.cat([d.view.augment.op for d in small_draws]).tolist()))
        print(f"reference {what} (augment=True, ops {ops}): student views and targets "
              f"card vs cpu max err {view_err:.3g} (tol {tol}); loss card {on_card} vs "
              f"cpu {on_cpu} (loss rtol 1e-3, ranks equal); card launches "
              f"{card_launches}")
        return card_launches

    card_vs_cpu("vit_mini_patch4 teacher, 16 px")
    # L = 1: a micro ConvNeXt-V2 teacher's 2 x 2 tokens against 256 student
    # tokens; K1/K2 in the student only. At 64 px the views' fp32 sums run
    # over 80-tap crop resampling and 4,096-pixel contrast means, summed in
    # other orders on the card (2.4e-5 seen, normalized): 1e-4 here
    cnn_launches = card_vs_cpu("convnextv2_micro teacher, 64 px", tol=1e-4, ties=True,
                               teacher_name="convnextv2_micro", size=64)
    if cnn_launches["attention_fwd"] != 4 * len(small_draws):
        raise AssertionError(f"reference convnextv2_micro: {cnn_launches}")

    def rel(got, want) -> float:
        return ((got.detach().float().cpu() - want.detach().float().cpu()).abs().max()
                / want.detach().float().abs().max().clamp(min=1e-30)).item()

    # A ResNet teacher's forward (BasicBlocks, BatchNorm, asymmetric SAME
    # pads at 64 px) on the card and the CPU from the same weights: tokens
    # and pooled features within 1e-4 of scale (fp32 cuDNN convolutions,
    # TF32 off, summed in other orders)
    xr = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 64, 64, 3)).astype(np.float32))
    outs = []
    for device in (dev, torch.device("cpu")):
        t = load_teacher("resnet_micro", img_size=64, dtype=f32, device=device)
        with torch.no_grad():
            outs.append(t.module(xr.to(device)))
    err = max(rel(outs[0].tokens, outs[1].tokens), rel(outs[0].logits, outs[1].logits))
    if not (err <= 1e-4 and torch.equal(outs[0].importance.cpu(), outs[1].importance)):
        raise AssertionError(f"reference resnet_micro forward: card vs cpu {err}")
    print(f"reference resnet_micro forward (4, 64, 64, 3): tokens "
          f"{tuple(outs[0].tokens.shape)} and pooled features card vs cpu {err:.3g} "
          "(tol 1e-4 of scale); uniform importance equal")

    # A ViT without a CLS token, forward and backward: its attention takes
    # the einsum chain (the importance needs the normalized attention), so
    # K1 never runs; outputs, the input gradient and every parameter
    # gradient within 1e-4 of scale
    ncfg = ViTConfig(img_size=16, patch_size=4, embed_dim=64, depth=2, num_heads=2,
                     num_classes=10, has_cls_token=False, dtype=f32)
    xn = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, 16, 16, 3)).astype(np.float32))
    sides = []
    for device in (dev, torch.device("cpu")):
        m = VisionTransformer(ncfg, capture_layers=(0, 1))
        m.init_weights(3)
        m.to(device)
        xg = xn.to(device).requires_grad_(True)
        kernels.reset_launches()
        o = m(xg, train=True)
        sum((a * (i + 1)).sin().sum() for i, a in enumerate(o)).backward()
        sides.append((o, xg.grad, {n: p.grad for n, p in m.named_parameters()},
                      dict(kernels.LAUNCHES)))
    (oc, gc, pc, lc), (op, gp, pp, _) = sides
    err = max([rel(a, b) for a, b in zip(oc, op)] + [rel(gc, gp)]
              + [rel(pc[n], pp[n]) for n in pp])
    if not (err <= 1e-4 and lc["attention_fwd"] == 0 and lc["attention_bwd"] == 0):
        raise AssertionError(f"reference no-CLS ViT: card vs cpu {err}, launches {lc}")
    print(f"reference no-CLS ViT forward and backward (4, 16, 16, 3): outputs, input "
          f"and parameter gradients card vs cpu {err:.3g} (tol 1e-4 of scale); card "
          f"launches {lc}")

    # remat on the card: the same two steps (drop_path 0.1, draws replayed)
    # with and without it give the same losses and ranks; K1 runs once more
    # per student block and step (its forward again in the backward)
    plain_run, _, plain_launches = small_run(dev, drop_path=0.1)
    remat_run, _, remat_launches = small_run(dev, drop_path=0.1, remat=True)
    same = plain_run == remat_run
    extra = remat_launches["attention_fwd"] - plain_launches["attention_fwd"]
    if not (all(abs(a[0] - b[0]) <= 1e-6 * abs(a[0]) and a[1] == b[1]
                for a, b in zip(plain_run, remat_run)) and extra == 4 * len(small_draws)
            and remat_launches["attention_bwd"] == plain_launches["attention_bwd"]):
        raise AssertionError(f"reference remat: {remat_run} ({remat_launches}) vs "
                             f"{plain_run} ({plain_launches})")
    print(f"reference remat=True vs remat=False on the card (drop_path 0.1): losses "
          f"and ranks {remat_run} vs {plain_run} (rtol 1e-6; bit for bit: {same}); "
          f"K1 launches {remat_launches['attention_fwd']} vs "
          f"{plain_launches['attention_fwd']} (+1 per student block and step)")

    # ---- 7. one profiled step each: Table-3 (the main path) and Table-1 ----
    from torch.profiler import ProfilerActivity, profile

    # the port's own kernels (csrc/*.cu); PyTorch's softmax and arange
    # kernels also sit in anonymous namespaces
    own_kernel = re.compile(
        r"void \(anonymous namespace\)::(attn_\w+|jacobi_\w*kernel|warp_\w*kernel)[<(]")

    def profile_step(label, fn, st, ims, lbs, warp_row):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            st, met = fn(st, ims, lbs)
            float(met["loss"])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        dev_events = device_events(prof)
        busy_ms = sum(device_us(e) for e in dev_events) / 1e3
        print(f"profile {label}: step {wall_ms:.2f} ms wall, device busy {busy_ms:.2f} "
              f"ms ({100 * busy_ms / wall_ms:.1f}%), {sum(e.count for e in dev_events)} "
              "device kernels")
        for e in prof.key_averages():
            if e.key.startswith("basd:") and \
                    e.device_type == torch.autograd.DeviceType.CPU:
                print(f"  stage {e.key[5:]:<16s} host {e.cpu_time_total / 1e3:9.3f} ms")
        for e in sorted(dev_events, key=device_us, reverse=True)[:12]:
            print(f"  {device_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
        own = [e for e in dev_events if own_kernel.match(e.key)]
        print(f"profile {label}: the port's kernels "
              f"{sum(device_us(e) for e in own) / 1e3:.3f} ms of device time in the step")
        for e in sorted(own, key=device_us, reverse=True):
            print(f"  {device_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
        # torch.profiler has dropped K4's one launch in profiles before; its
        # device time per launch is phase 4's `kernel_ms` reading
        in_profile = any("warp_" in e.key for e in own)
        print(f"profile {label}: K4 (warp, route {warp_row['route']}) device "
              f"{warp_row['device_ms']:.5f} ms per launch by kernel_ms (phase 4); "
              f"{'recorded' if in_profile else 'no record'} in this profile")

    profile_step("Table-3", step_fn, state, images, labels,
                 report["warp"][f"main path {(batch, img, img, 3)}"])
    torch.cuda.reset_peak_memory_stats()
    profile_step("Table-1", table1["step_fn"], table1["state"], table1["images"],
                 table1["labels"], report["warp"]["reference default (256, 224, 224, 3)"])
    print(f"profile Table-1: peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          "GiB")

    # ---- 8. the trainer and evaluation entry points at Table-3 width ----
    # `python -m basd_tpu_torch.train` as a user runs it (through `main`):
    # the paper's Table-3 run at full width (DeiT-Tiny/4 at 32 px with the
    # DINOv2 ViT-B/14 teacher, random weights from the seed, batch 128, 100
    # classes, bf16, remat, K auto) on 1,024 synthetic images, one epoch of
    # 8 steps, `latest` saved every 4; then `python -m basd_tpu_torch.evaluate`
    # from the run's snapshot in a subprocess, and once more in this process
    # for its launch counts. The arch_overrides keep the student at DeiT-Tiny
    # width (a random teacher's intrinsic dimension would shrink it).
    del table1["state"], table1["step_fn"], table1["teacher"], table1["images"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    out_root = "chiprun_out/m7"
    shutil.rmtree(out_root, ignore_errors=True)
    m7_argv = [
        "experiment=basd_cifar100", "data.dataset=synthetic/cifar100-like-1024n",
        "training.num_epochs=1",
        "model.arch_overrides={embed_dim: 192, depth: 12, num_heads: 3, mlp_ratio: 4.0}",
        "checkpoint.save_every_steps=4", "evaluation.efficiency_warmup=5",
        "evaluation.efficiency_batches=20", f"run.output_dir={out_root}",
    ]
    kernels.reset_launches()
    t0 = time.perf_counter()
    m7_results, trainer = train_entry.main(m7_argv, device=dev)
    torch.cuda.synchronize()
    m7_wall_s = time.perf_counter() - t0
    m7_launches = dict(kernels.LAUNCHES)
    m7_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    m7_cfg = trainer.config
    m7_k = m7_cfg.basd.subspace_k
    m7_student = trainer.state.student.config
    m7_steps = trainer.state.step
    eval_cfg = m7_cfg.evaluation
    eval_batches = -(-128 // m7_cfg.data.batch_size)  # the 128-image test split
    # K1 in every student block of each forward outside the train steps: the
    # per-epoch and the final evaluation, the efficiency loop; 12 in the
    # teacher's forward of the K calibration; none for the FLOP count (a CPU
    # copy of the model)
    eval_forwards = 2 * eval_batches + eval_cfg.efficiency_warmup + eval_cfg.efficiency_batches
    per_step = per_step_launches(m7_student, trainer.teacher, trainer.extraction_points,
                                 m7_k, True)
    want = {name: per_step[name] * m7_steps for name in per_step}
    want["attention_fwd"] += m7_student.depth * eval_forwards + teacher_layers(trainer.teacher)
    if (m7_steps != 8 or not m7_student.remat or m7_student.embed_dim != 192
            or per_step["attention_fwd"] != 36 or m7_launches != want):
        raise AssertionError(f"train entry: {m7_steps} steps, remat {m7_student.remat}, "
                             f"launches {m7_launches}, expected {want} (per step "
                             f"{per_step}, K={m7_k})")
    primary = m7_results["primary"]
    if not all(np.isfinite(primary[key]) for key in ("val_acc", "val_acc_top5", "loss")):
        raise AssertionError(f"train entry: primary {primary}")
    print(f"train entry: K={m7_k} (Jacobi kernel gate 16 <= K <= 96: "
          f"{use_jacobi((len(trainer.extraction_points), m7_k, m7_k))}); {m7_steps} steps "
          f"of batch {m7_cfg.data.batch_size}, remat {m7_student.remat}; launches "
          f"{m7_launches} (per step {per_step}, plus K1 x {m7_student.depth} in "
          f"{eval_forwards} eval and efficiency forwards and the calibration's 12); "
          f"{m7_wall_s:.1f} s")
    trainer_ms = trainer.step_ms
    print(f"train entry: trainer step ms {[round(t, 2) for t in trainer_ms]} (CUDA events "
          f"between step ends): first {trainer_ms[0]:.2f}, median after the first "
          f"{np.median(trainer_ms[1:]):.2f}; the bare augmented step (phase 5, remat off) "
          f"median {np.median(step_ms[1:]):.2f}; the epoch loop blocked on each save "
          f"{[round(t, 2) for t in trainer.checkpoints.blocked_ms]} ms; eval throughput "
          f"{m7_results['efficiency']['throughput_img_per_sec']:.1f} img/s at batch "
          f"{eval_cfg.get('efficiency_batch_size', 64)}, gflops {m7_results['efficiency']['gflops']:.4f}; peak memory "
          f"{m7_peak_gib:.2f} GiB ({held_gib:.2f} held by earlier phases)")

    # the restored `latest` equals the live state bit for bit: every
    # parameter, z, v, the CUDA generator's state and the step; the fresh
    # trainer's student is drawn from another seed, so the restore must
    # overwrite it
    fresh_student, fresh_cfg = create_student(
        m7_cfg.model.student_preset, num_classes=m7_cfg.model.num_classes,
        drop_path_rate=m7_cfg.model.drop_path_rate, img_size=img,
        arch_overrides={**m7_cfg.model.arch_overrides, "patch_size": patch},
        capture_layers=trainer.extraction_points, dtype=bf16, remat=True, device=dev,
        seed=m7_cfg.run.seed + 7)
    fresh = Trainer(m7_cfg, student=fresh_student, student_cfg=fresh_cfg,
                    teacher=trainer.teacher,
                    teacher_stats=(trainer.teacher.mean, trainer.teacher.std),
                    dataset_stats=trainer._eval_stats)

    def state_tensors(tr):
        st = tr.state
        out = {f"param {k}": v for k, v in st.student.state_dict().items()}
        for i, p in enumerate(st.optimizer.param_groups[0]["params"]):
            out[f"z {i}"] = st.optimizer.state[p]["z"]
            out[f"v {i}"] = st.optimizer.state[p]["exp_avg_sq"]
        out["log_temperatures"] = st.selector.log_temperatures
        out["generator"] = st.generator.get_state()
        return out

    live_tensors = state_tensors(trainer)
    differs_before = sum(not torch.equal(v, state_tensors(fresh)[k])
                         for k, v in live_tensors.items())
    fresh.load_checkpoint("latest")
    restored = state_tensors(fresh)
    unequal = [k for k, v in live_tensors.items() if not torch.equal(v, restored[k])]
    if unequal or fresh.state.step != trainer.state.step or not differs_before:
        raise AssertionError(f"restore latest: {len(unequal)} tensors differ "
                             f"{unequal[:5]}, step {fresh.state.step} vs "
                             f"{trainer.state.step}")
    print(f"train entry: restore_state('latest') into a fresh Trainer equals the live "
          f"state bit for bit ({len(live_tensors)} tensors: parameters, z, v, "
          f"log-temperatures, the CUDA generator's state; {differs_before} differed "
          f"before), step {fresh.state.step}")
    del fresh, fresh_student

    snapshot = f"{out_root}/{m7_cfg.run.name}/config.yaml"
    final_npz = f"{out_root}/{m7_cfg.run.name}/checkpoints/final_model.npz"
    eval_argv = [f"config={snapshot}", f"checkpoint.path={final_npz}"]
    t0 = time.perf_counter()
    # the package is found from this script's directory, whatever the cwd
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.dirname(os.path.abspath(__file__)), env.get("PYTHONPATH"))
        if p)
    proc = subprocess.run([sys.executable, "-m", "basd_tpu_torch.evaluate", *eval_argv],
                          capture_output=True, text=True, timeout=600, env=env)
    eval_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"evaluate exited {proc.returncode}:\n{proc.stdout}"
                             f"\n{proc.stderr[-4000:]}")
    with open(f"{out_root}/{m7_cfg.run.name}/metrics.json") as f:
        sub_primary = json.load(f)["primary"]

    def same_primary(got):
        return (got["val_acc"] == primary["val_acc"]
                and got["val_acc_top5"] == primary["val_acc_top5"]
                and abs(got["loss"] - primary["loss"]) <= 1e-6 * abs(primary["loss"]))

    kernels.reset_launches()
    in_process = evaluate_entry.main(eval_argv, device=dev)
    torch.cuda.synchronize()
    eval_launches = dict(kernels.LAUNCHES)
    want_eval = {name: 0 for name in eval_launches}
    want_eval["attention_fwd"] = m7_student.depth * (
        eval_batches + eval_cfg.efficiency_warmup + eval_cfg.efficiency_batches)
    if not (same_primary(sub_primary) and same_primary(in_process["primary"])
            and eval_launches == want_eval):
        raise AssertionError(f"evaluate: {sub_primary} (subprocess), "
                             f"{in_process['primary']} (in process) vs the train run's "
                             f"{primary}; launches {eval_launches}, expected {want_eval}")
    print(f"evaluate: `python -m basd_tpu_torch.evaluate` from the snapshot reproduces "
          f"the train run's final eval (top1 {primary['val_acc']:.4f}, top5 "
          f"{primary['val_acc_top5']:.4f}: equal; loss {sub_primary['loss']:.8f} vs "
          f"{primary['loss']:.8f}, tol 1e-6 relative) in {eval_s:.1f} s; in process "
          f"launches {eval_launches}")
    path_launches["train_entry"] = m7_launches
    path_launches["evaluate"] = eval_launches
    # the run's checkpoints (about 180 MB) are not kept: config.yaml and
    # metrics.json stay in chiprun_out/m7
    trainer.checkpoints.close()
    shutil.rmtree(f"{out_root}/{m7_cfg.run.name}/checkpoints")
    m7 = {"k": m7_k, "trainer_step_ms": trainer_ms, "bare_step_median_ms":
          float(np.median(step_ms[1:])), "save_blocked_ms": trainer.checkpoints.blocked_ms,
          "eval_img_per_s": m7_results["efficiency"]["throughput_img_per_sec"],
          "peak_gib": m7_peak_gib, "held_gib": held_gib, "wall_s": m7_wall_s,
          "primary": primary}

    # ---- result lines ----
    meta = {
        "attention_fwd": ("basd_tpu_torch/csrc/attention.cu",
                          "basd_tpu/ops/attention.py:84",
                          "student B=128 N=65 D=192 H=3 bfloat16"),
        "attention_bwd": ("basd_tpu_torch/csrc/attention.cu",
                          "basd_tpu/ops/attention.py:114",
                          "student B=128 N=65 D=192 H=3 bfloat16"),
        "jacobi_eigh": ("basd_tpu_torch/csrc/jacobi_eigh.cu",
                        "basd_tpu/spectral/pallas_jacobi.py:33",
                        f"principal angles ({len(points) * 12}, {k_cal}, {k_cal})"
                        if k3_on_path else "wide spectrum (48, 48, 48)"),
        "warp": ("basd_tpu_torch/csrc/warp.cu", "basd_tpu/ops/warp_kernel.py:161",
                 f"main path {(batch, img, img, 3)}"),
        "jacobi_eigvals": ("basd_tpu_torch/csrc/jacobi_eigh.cu",
                           "basd_tpu/spectral/pallas_jacobi.py:69",
                           "tune_spectral covariances (12, 192, 192)"),
        "attn_probe": ("basd_tpu_torch/csrc/attn_probe.cu",
                       "tools/probe_attn_internals.py:25",
                       "full (256, 12, 257, 64)"),
    }
    # each kernel's launches on the path it serves: the train step for
    # K1-K4, the spectral tuner for K5, the attention probe for K6
    own_path = {"jacobi_eigvals": "tune_spectral",
                "attn_probe": "probe_attn_internals"}
    measured = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
                "bound_ms", "bound_by",
                "max_abs_err", "rel_err", "eig6_err", "eig_err", "recon_err",
                "orth_err", "eig3_err", "us_per_step", "route", "k1_ms",
                "k1_plain_ms", "k1_bound_ms", "sdpa_ms", "differing",
                "w_equals_k5", "k5_device_ms", "over_own_ulp",
                *(f"{k}_sweeps{sw}" for sw in (6, 12)
                  for k in ("ms", "plain_ms", "library_ms", "bound_ms", "device_ms",
                            "us_per_step", "k5_device_ms")))
    entries = []
    for name, (src, replaces, main_case) in meta.items():
        row = report[name][main_case]
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": path_launches[own_path.get(name, "train_step")][name],
            "launches_by_path": {p: c[name] for p, c in path_launches.items()},
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "status": "ok",
            "main_case": main_case,
            "cases": {case: {k: r[k] for k in measured if k in r}
                      for case, r in report[name].items()},
        })
    print(json.dumps({"kernels": entries, "step_ms": step_ms,
                      "deterministic_step_ms": det_step_ms,
                      **{f"{name}_{key}": t[key] for name, t in
                         (("table1", table1), ("table2", table2))
                         for key in ("step_ms", "k", "per_step", "peak_gib", "staging_s")},
                      "table1_intrinsic_dim": idim, "table1_derived_arch": arch,
                      "m7": m7,
                      "jacobi_eigh_us_per_step_by_n": us_by_n}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
