#!/usr/bin/env python3
"""Smoke run of the BASD PyTorch port (`basd_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is not 0:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every kernel of the port from basd_tpu_torch/csrc (nvcc,
     sm_90a, one process per source, all at once); `python -m
     basd_tpu_torch.tools.smoke_kernels` in a process of its own, exit 0
     and six PASS lines (K1, K2, K4, K3, the MP rank and the SwiGLU gate
     once at a tiny shape against their plain versions: the trainer's
     start-up check); the
     HMMA (tensor-core)
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
     K1 and K2 at the gate's edges and at phase 9's rank-local shapes
     ((64|128, 257, 1024) H=16 K1, (64, 197, 384) H=6 and (128, 197, 192)
     H=3 K1 and K2), bf16 K1/K2 and
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
     each route's edges, each case printed with its route, its params
     (`warp_params`) equal to the CPU's in all eight columns, as they are
     at TrivialAugment's 62 rotate angles;
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
     steps of `make_train_step(augment=True)`, each with the kernels'
     launch counters reset just before and read just after;
     both are the graph route (the first step eager, then one CUDA graph
     captured and replayed);
  5b. tools: one full-size run of each tool path
     (`basd_tpu_torch.tools.tune_spectral`, `probe_jacobi_sweeps`,
     `probe_attn_internals`), counters reset just before and read just
     after each;
  5c. the 224 px steps at full width, batch 256: Table-1 (DINOv2
     ViT-L/14 teacher, ViT-S/16 student) and Table-2 (ConvNeXt-V2-Tiny
     teacher, DeiT-Tiny/16 student), 1 + 2 augmented steps each with the
     exact launches per step, counters reset just before and read just
     after; K3 at Table-2's (4, K, K); the ViT-L
     teacher's intrinsic dimension and the student it derives;
  5d. the float64 oracle: the selector on the card against
     `spectral/reference.py:selector_d2_np` on the host, fed the same
     bf16-rounded operands, on Table-3's real tokens (phase 4's selector
     inputs, K3 in its eighs), Table-1's real tokens (5c's ViT-L/14 teacher
     and student, a selector of seed 1, K = 192: cuSOLVER's eighs) and a
     planted input at Table-1's widths (`planted_selector_inputs`): MP ranks
     equal (or differing only by eigenvalues at the MP edge), mixing
     weights and d^2 within the bounds stated at ORACLE_WEIGHTS_ATOL, with
     the oracle's host seconds; the selector's launches counted;
  5e. the Table-3 step as one CUDA graph (`training.train_step.TrainStep`):
     two states from the same seeds, 6 eager steps of one (the second under
     `torch.cuda.set_sync_debug_mode("error")`, so a host round-trip
     raises) and 6 calls of the other's graph route (an eager warm-up, the
     capture and its replay, 4 replays), bit for bit equal in every loss and
     metric, the parameters, temperatures, optimizer state and generator
     state; K1 24, K2 12, K3 3, K4 1, MP rank 1 per replay by the counters and by
     kernel name in a torch.profiler trace of one replay; the eager and
     replay step medians, the replay's device-busy share, the capture's
     seconds and the graph pool's bytes; Table-1's and Table-2's routes
     (eager, with the eigh shape that goes to cuSOLVER);
  5f. the MP-rank kernel (`mp_rank_check()` in a process of its own): its
     ranks equal to the plain version's (`mp_rank_sturm`, op by op on the
     card) and to the float64 oracle's (or off only by eigenvalues at the
     edge) on planted covariances (designed spectra and spiked noise) at
     the cells' (12, 192, 192) and (24, 384, 384), at n = 8, 33, the
     one-CTA route's last n (238), the two-CTA route's first (239), 512 and
     640 (eight CTAs), every cluster that holds n = 384 giving the same
     ranks, and on the benchmark cells' own teacher Grams from their first
     three (eager) steps; its tridiagonal and the plain version's within
     MP_TRIDIAG_RTOL of the float64 reduction; then the kernel's device
     time beside the plain version's replayed graph and `eigvalsh`
  5g. the SwiGLU gate and DINOv2 ViT-g (`swiglu_check()` in a process of
     its own): the gate kernel against its plain version at the ViT-g
     teacher's (65,792, 8,192) bf16, both routes and g odd, timed beside
     `F.silu(a) * b` and its bound; one ViT-g teacher forward at batch 256
     (`load_teacher("dinov2_vitg14")`, LayerScale 1) against the plain
     float32 reference (`basd_tpu_torch/reference/vit_swiglu.py`) computed
     in blocks of the batch; and the Table-1 step with the ViT-g teacher
     through `make_train_step`: its route, 40 gate launches a replay, its
     peak memory and step time
     (`tools/time_mp_rank.py`);
  5h. the erf GELU kernels (`gelu_check()` in a process of its own): the
     forward bit for bit F.gelu(x.float()).to(x.dtype) and the backward
     against the composite's autograd (the elements that differ counted,
     at most one ulp of the dtype) at Table-1's teacher (65,792 x 4,096)
     and student (50,432 x 1,536) MLP widths, Table-3's, in fp32, on a
     tail of n % 8 = 7 and an unaligned view (the scalar route), each timed
     beside the composite, torch's own GELU and its bound; then each
     benchmark cell staged as the benchmark stages it, its GELU launches a
     replay equal to `benchmark/costs/gelu.py`'s calls;
  5i. the selector's teacher projection (`projection_check()` in a
     process of its own): `losses/selector.py:_project` on bf16 tokens, one
     tensor-core product with fp32 accumulation and output, at t1's
     (24 x 65,536, 1,024) and vg's (40 x 65,536, 1,536) stacks times
     (1,024 | 1,536, 384): its error against a float64 product of the same
     bf16 operands at most twice the fp32 form's (`_project_f32`), its bits
     with `allow_bf16_reduced_precision_reduction` flipped, its cuBLAS
     kernels and compute type (the libraries' API logs), timed beside the
     fp32 form and its bound; `oracle_check` of one `select_and_mix` on
     planted inputs at t1's and vg's token shapes, MP ranks equal, one
     projection counted (`selector.TENSOR_CORE_PROJECTIONS`); and the
     t1 cell's program counting 1, 1, 0 in its warm-up, capture and replay;
  5j. the RoPE rotation (`rope_check()` in a process of its own): the
     kernel bit for bit its plain version at DINOv3 ViT-7B's teacher
     (256, 201, 12,288) bf16, in fp32, at the micro teacher's shape, on an
     unaligned qkv and at head_dim 12 (the scalar routes), timed beside the
     plain version, torch's own ops on the published formula and its bound;
     K1 at head_dim 128 at the same teacher shape against its plain version
     and SDPA, timed; one `dinov3_vit7b16` forward at batch 256 (wall ms,
     40 rotations, 40 K1 and 40 gates, peak memory); the Table-1 step with
     that teacher: route graph, a replay's launches (40 rotations, 40
     gates, K1 64, 81 LayerNorms), peak memory and stage spans;
  5k. the LayerNorm kernel (`layernorm_check()` in a process of its own) at
     the four benchmark teachers' rows (640 x 768, 65,792 x 1,024,
     65,792 x 1,536, 51,456 x 4,096) bf16, t1's in fp32, an odd width and
     unaligned rows (the scalar route): within one ulp of the composite
     (a few fp32 ulps of the row's scale near zero), the share of values
     that differ, timed beside the composite, F.layer_norm and its bound;
  6. reference: small configurations stepped with augment=True on the
     card and on the CPU (plain versions) from one set of draws, student
     views, losses and ranks compared, with a ViT and a ConvNeXt-V2
     teacher; a ResNet teacher's forward and a no-CLS ViT's forward and
     backward on both; a remat=True step against remat=False on the card;
  7. profile: one main-path step op by op, one replay of its CUDA graph
     and one Table-1 step under torch.profiler, device time by kernel and
     host time by stage, and K4's device time from phase 4 (profiles have
     dropped its one launch);
  8. entry points (`trainer_phase`; alone `trainer_graph_check()`):
     `basd_tpu_torch.train.main` at Table-3 width (the basd_cifar100
     experiment on 1,024 synthetic images, one epoch of 8 steps, bf16,
     remat, K auto, `latest` every 4 steps) on the graph route (K1 36, K2
     12, K3 3, K4 1 a replay) with its exact launches (the trainer's kernel
     start-up check's among them); a twin Trainer's `TrainStep.eager`
     steps on the same batches, bit for bit; the restored `latest` against
     the live state bit for bit; the graph evaluation against the eager
     one (sums bit for bit, eval and efficiency img/s both ways); `latest`
     restored into the live Trainer after its capture and 2 steps against
     a fresh Trainer's; timed and profiled remat replays (busy share,
     kernels by name); and `python -m basd_tpu_torch.evaluate` from the
     run's snapshot reproducing its final eval; the trainer's step times
     beside the bare step's, each save's blocking time, peak memory;
  9. data and tensor parallelism, 4 ranks sharing the card over gloo
     (`parallel/mesh.py`; the backend is printed): 9a, Table-1 at full
     width, one augmented step of a fresh one-process step (run and freed
     first), then the ranks (spawned here) on data=4 (64 a rank) and on
     data=2 x model=2 (128 a rank, the student's 6 heads 3 a rank), each
     held against the one-process step (losses rtol 1e-3, MP ranks equal,
     mixing weights 2e-3, temperatures 1e-5, the update's relative
     difference within 0.5), the data replicas' parameters bit-identical
     and every rank's launches exact; a second, timed step per mesh prints
     each rank's step ms, the ms of each collective and the peak memory;
     9b, `python -m torch.distributed.run --nproc_per_node=4 -m
     basd_tpu_torch.train` on phase 8's run with hardware.mesh.data=4: the
     same K on every rank, exact launches per rank (each rank's start-up
     check's among them), every rank's state
     bit-identical and equal to `latest` restored in one process, and a
     one-process `evaluate` reproducing the run's final eval (top-1/top-5
     equal, loss within 1e-5); 9c, K1/K2 at the ranks' shapes, in phase 4;
  10. measurement entry points: `tools.profile_step` (Table-3 and
     `--imagenet`), `probe_selector_internals` (`--t3`, and `--teacher
     dinov2_vitl14 --model-tokens`: the selector's components at K = 192 on
     cuSOLVER, on the models' own tokens), `probe_loss_tail` and
     `probe_step_gap`, each with the counters reset just before and read
     just after, with the phase's seconds;
  11. the last tools and the entry check: `probe_ns_mixed` (the Newton-
     Schulz square root by per-step precision), `probe_warp_kernel` (K4
     against the tap sweep at (256, 224, 224, 3): parity within 1e-5) and
     `probe_warp_parity8` (card against CPU: every difference 0.0) at full
     size, each in a process of its own with its launches; `entry()`'s
     forward on the card (K1 12 launches, logits and tokens against the
     CPU's within 8 bf16 ulps of their scale) and `dryrun_multichip(4)` on
     2 x 2 ranks sharing the card over gloo (rank 0's loss within 1e-3 of
     the one-process step on the same batch, its launches that step's),
     with the phase's seconds;
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


# bench.py's step hyper-parameters (phases 5, 5c and 9)
STEP_HPARAMS = dict(learning_rate=5e-4, weight_decay=0.05, warmup_steps=1000,
                    label_smoothing=0.01)
MESHES = {"dp4": (4, 1), "tp22": (2, 2)}  # phase 9a's (data, model)
# phase 10's tool runs: timed calls per stage (--n), lowered from the tools'
# defaults to keep the whole run in its time (widths unchanged); the
# step-gap probe keeps its slope of 20 steps (a 4-step slope read a negative
# Procrustes delta on the host-bound step)
MEASURE_ARGS = {"profile_step": ["--n", "10"], "profile_step_imagenet": ["--n", "4"],
                "probe_selector_internals": ["--n", "4"], "probe_loss_tail": ["--n", "4"],
                "probe_step_gap": []}
# phase 11's bound on the entry forward, card against cpu: both bf16 (2^-8
# relative spacing), rounded in other places over twelve blocks
BF16_ULPS_8 = 8 * 2.0**-8
# the launches of the kernel start-up check (`utils/kernel_smoke.py`) in a
# process that has not checked its card yet: K1 in the attention check and
# in the backward check's forward, K2, K4, K3, the MP-rank kernel, the
# SwiGLU gate and the RoPE rotation on each of their two routes, the
# LayerNorm on its three; no GELU kernel
KERNEL_CHECK_LAUNCHES = {"attention_fwd": 2, "attention_bwd": 1, "jacobi_eigh": 1,
                         "warp": 1, "jacobi_eigvals": 0, "attn_probe": 0, "mp_rank": 1,
                         "swiglu_gate": 2, "gelu_fwd": 0, "gelu_bwd": 0, "rope_qk": 2,
                         "layernorm": 3}


def table1_inputs(dev):
    """Table-1's staging as phase 5c does it: the DINOv2 ViT-L/14 teacher,
    batch 256 of 256 px uint8 images and labels from default_rng(0), the
    extraction points."""
    import torch

    from basd_tpu_torch.losses import extraction_points
    from basd_tpu_torch.models import load_teacher

    tch = load_teacher("dinov2_vitl14", img_size=224, dtype=torch.bfloat16, device=dev)
    r = np.random.default_rng(0)
    ims = torch.from_numpy((r.random((256, 256, 256, 3)) * 255).astype(np.uint8)).to(dev)
    lbs = torch.from_numpy(r.integers(0, 1000, 256, dtype=np.int64)).to(dev)
    return tch, ims, lbs, extraction_points(12, 4)


def table1_step(dev, tch, pts, k, mesh=None):
    """A fresh Table-1 ViT-S/16 student (seed 0; this rank's shards over a
    model axis), selector (seed 1) and augmented train step, as phase 5c
    builds them; returns (init state, step_fn, the full student's initial
    state dict on the CPU)."""
    import torch

    from basd_tpu_torch.losses import init_selector
    from basd_tpu_torch.models import create_student
    from basd_tpu_torch.parallel.sharding_rules import shard_module
    from basd_tpu_torch.training.train_step import make_train_step

    stu, scfg = create_student(
        "vit_small_patch16", num_classes=1000, drop_path_rate=0.05, img_size=224,
        capture_layers=pts, dtype=torch.bfloat16, remat=False, device=dev)
    theta0 = {n: v.detach().float().cpu() for n, v in stu.state_dict().items()}
    stu = shard_module(stu, mesh)
    sel = init_selector(1, len(pts), scfg.embed_dim, tch.spec.embed_dim, device=dev)
    init_fn, step_fn = make_train_step(
        stu, tch, **STEP_HPARAMS, img_size=224, crop_ratio=224 / 256,
        teacher_stats=TEACHER_STATS, dataset_stats=DATASET_STATS, num_classes=1000,
        subspace_k=k, mesh=mesh, augment=True)
    return init_fn(0, sel), step_fn, theta0


def mesh_rank(rank: int, world: int, port: int, out_dir: str, k: int) -> None:
    """Phase 9a's rank: Table-1 at full width, one checked augmented step on
    each mesh of MESHES (this rank's shard of the global batch 256), one
    more timed as a whole, and one with its collectives synchronized and
    timed; writes what it found to `out_dir` (rank 0 also the parameters
    after the checked step, gathered)."""
    import hashlib

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    import torch
    import torch.nn.functional as F

    from basd_tpu_torch import kernels
    from basd_tpu_torch.parallel.mesh import batch_shard, create_mesh, shutdown
    from basd_tpu_torch.parallel.sharding_rules import gather_state_dict

    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    meshes = {name: create_mesh(d, m) for name, (d, m) in MESHES.items()}
    dev = meshes["dp4"].device
    tch, ims, lbs, pts = table1_inputs(dev)
    for name, mesh in meshes.items():
        state, step_fn, _ = table1_step(dev, tch, pts, k, mesh)
        x, y = batch_shard(mesh, ims, lbs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        state, met = step_fn(state, x, y)
        float(met["loss"])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(kernels.LAUNCHES)
        local = state.student.state_dict()
        digest = hashlib.sha256()
        for v in local.values():
            digest.update(v.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
        full = gather_state_dict(dict(local), mesh, state.student.config.num_heads)
        if rank == 0:
            torch.save({n: v.detach().float().cpu() for n, v in full.items()},
                       f"{out_dir}/{name}-params.pt")
        temps = F.softplus(state.selector.log_temperatures).tolist()
        result = dict(
            rank=rank, data_index=mesh.data_index, model_index=mesh.model_index,
            backend=mesh.backend, batch=x.shape[0], loss=float(met["loss"]),
            ce=float(met["ce_loss"]), geo=float(met["geo_loss"]),
            weights=met["mixing_weights"].tolist(), ranks=met["mp_ranks"].tolist(),
            temps_after=temps, launches=launches, step_ms=step_ms,
            digest=digest.hexdigest(), generator=hashlib.sha256(
                state.generator.get_state().numpy().tobytes()).hexdigest())
        t0 = time.perf_counter()
        state, met = step_fn(state, x, y)
        float(met["loss"])
        torch.cuda.synchronize()
        result.update(second_step_ms=(time.perf_counter() - t0) * 1e3)
        mesh.timings = {}
        t0 = time.perf_counter()
        state, met = step_fn(state, x, y)
        float(met["loss"])
        torch.cuda.synchronize()
        result.update(timed_step_ms=(time.perf_counter() - t0) * 1e3,
                      collective_ms={n: sum(v) for n, v in mesh.timings.items()},
                      collective_calls={n: len(v) for n, v in mesh.timings.items()},
                      peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        mesh.timings = None
        with open(f"{out_dir}/{name}-rank{rank}.json", "w") as f:
            json.dump(result, f)
        del state, step_fn, met, full, local
        torch.cuda.empty_cache()
    shutdown()


# Phase 5d's planted input: teacher layers with these planted ranks, and
# extraction point p sharing the planted subspace of layer PLANTED_PAIRS[p]
PLANTED_RANKS = (40, 80, 120, 170)
PLANTED_PAIRS = (1, 3, 0, 2)
PLANTED_K = 192
# Phase 5d's bounds against the float64 oracle: the mixing weights within
# an absolute bound, each d^2 within d2_atol + d2_rtol |d^2_oracle|. Real
# tokens: weights 2e-2 (the JAX package's own bound for its selector
# against the oracle, tests/test_losses.py:262) and d^2 0.15 relative. The
# K-capped subspace iteration is not the oracle's exact SVD: on random
# tokens at Table-3's selector widths both packages read 1.9e-3 in the
# weights and 1.2e-2 in d^2 (tests/test_torch_reference.py), and where a
# rank cuts a flat spectrum the two pick different directions. The planted
# input ends every compared subspace at a spectral gap
# (`planted_selector_inputs`), so only
# fp32 arithmetic separates the selector from the oracle: up to 8.6e-7 in
# the weights and 6.8e-6 in d^2 on the CPU (tests/test_torch_reference.py,
# the same construction at D_s = 48, also with Table-1's token counts, and
# at Table-1's widths with fewer tokens, held to these bounds), 9.9e-6 and
# 1.3e-4 on an H100 at Table-1's widths and token counts (cuSOLVER's eighs,
# fp32 Gram sums over 65,536 tokens). A matched pair's d^2 is 5e-5 there,
# so d^2 is bounded absolutely: relative to it, the fp32 floor reads O(1).
ORACLE_WEIGHTS_ATOL = 2e-2
ORACLE_D2 = (0.0, 0.15)  # (atol, rtol)
PLANTED_WEIGHTS_ATOL = 1e-4
PLANTED_D2 = (1e-3, 0.0)
MP_EDGE_RTOL = 1e-4  # a rank may differ only by eigenvalues this close to the edge


def planted_selector_inputs(proj_s, proj_t, teacher_shape, student_shape, seed,
                            ranks=PLANTED_RANKS, pairs=PLANTED_PAIRS):
    """bf16 teacher tokens (L, B, N_t, D_t) with a planted rank per layer
    (`ranks`) and student tokens (P, B, N_s, D_s) whose point p carries the
    planted subspace of layer `pairs[p]` as the selector sees it; made on
    the projections' device from `seed`. Each is a signal u h plus noise
    0.3 (the construction of `tests/test_torch_helpers.py:planted_tokens`,
    with orthonormal directions h, so that the column scales of u are the
    signal's spectrum). Layer l's h is a random orthonormal r_l-frame of
    the selector's space, lifted into the teacher's by proj_t (h proj_t
    projects back onto h), at scales in [2, 5). Point p's signal has
    max(ranks) directions: its layer's frame, lifted by proj_s, then
    directions orthogonal to it, at scales in [2, 5) that fall by tiers:
    index i of the signal, in tier t = #{r in ranks : r <= i}, has a scale
    in (5 - (t + 2/3) s, 5 - t s], s = 3 / len(ranks). So every subspace the selector
    compares (a layer's top r_l, and the point's top r_l for each l) ends
    at a spectral gap, and the comparison reads the selector's arithmetic,
    not the conditioning of a cut inside a continuous spectrum or the
    noise bulk (where the K-capped subspace iteration and the oracle's
    exact SVD pick different directions: the flat-spectrum reading)."""
    import torch

    dev = proj_t.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    uniform = lambda n, lo, hi: lo + (hi - lo) * torch.rand(n, generator=gen, device=dev)
    (b, n_t, d_t), (b_s, n_s, d_s) = teacher_shape, student_shape
    frame = lambda x: torch.linalg.qr(x)[0].T  # orthonormal rows spanning x's columns

    def tokens(m, h, scales, lift):
        x = (randn(m, h.shape[0]) * scales) @ h @ lift
        return (x + 0.3 * randn(m, lift.shape[1])).to(torch.bfloat16)

    hs = [frame(randn(d_s, r)) for r in ranks]
    teacher = torch.stack([tokens(b * n_t, h, uniform(h.shape[0], 2.0, 5.0),
                                  proj_t.float()).reshape(b, n_t, d_t) for h in hs])
    top, step = max(ranks), 3.0 / len(ranks)
    tier = torch.tensor([sum(r <= i for r in ranks) for i in range(top)], device=dev)
    student = []
    for l in pairs:
        extra = randn(d_s, top - ranks[l])
        extra = frame(extra - hs[l].T @ (hs[l] @ extra))
        scales = 5.0 - step * tier - uniform(top, 0.0, 2.0 * step / 3.0)
        student.append(tokens(b_s * n_s, torch.cat([hs[l], extra]), scales,
                              proj_s.float()).reshape(b_s, n_s, d_s))
    return teacher, torch.stack(student)


class HostLayers:
    """(L, ...) tokens on the card read by the float64 oracle one layer at
    a time: `layers[l]` is layer l on the host, widened to float64."""

    def __init__(self, tokens):
        self.tokens = tokens

    def __len__(self) -> int:
        return self.tokens.shape[0]

    def __getitem__(self, l: int) -> np.ndarray:
        return self.tokens[l].cpu().double().numpy()


def oracle_check(what, selector, student_tokens, teacher_tokens, importance, k,
                 weights_atol, d2_tol) -> dict:
    """One `select_and_mix` call on the tokens' device against the float64
    oracle (`spectral/reference.py:selector_d2_np`, on the host) fed the
    same bf16-rounded operands: the tokens as stored, proj_t rounded to
    the teacher tokens' dtype (`losses/selector.py:_project`), proj_s in
    fp32, the ranks capped at the selector's own k (`select_and_mix`'s
    min(subspace_k, D_s - 1, B N_s, B N_t)). MP ranks must be equal, unless
    every eigenvalue between the two ranks lies within MP_EDGE_RTOL of the
    MP edge (float64 eigenvalues of that layer's projected covariance); the
    mixing weights within `weights_atol` and each d^2 within atol + rtol
    |d^2_oracle|, (atol, rtol) = `d2_tol`. Raises AssertionError otherwise;
    returns the readings."""
    import torch

    from basd_tpu_torch.losses import select_and_mix
    from basd_tpu_torch.spectral.reference import selector_d2_np

    _, b, n_s, d_s = student_tokens.shape
    k = min(k, d_s - 1, b * n_s, b * teacher_tokens.shape[2])
    t0 = time.perf_counter()
    with torch.no_grad():
        _, _, aux = select_and_mix(selector, student_tokens, teacher_tokens, importance,
                                   subspace_k=k)
    host = lambda x: x.detach().cpu().double().numpy()
    ranks = aux["mp_ranks"].cpu().numpy().astype(np.int64)
    d2, w, temps = (host(aux[n]) for n in ("grassmann_d2", "mixing_weights", "temperatures"))
    selector_s = time.perf_counter() - t0
    proj_t = host(selector.proj_t.to(teacher_tokens.dtype))
    layers = HostLayers(teacher_tokens)
    t0 = time.perf_counter()
    d2_ref, ranks_ref = selector_d2_np(host(student_tokens), layers,
                                       host(selector.proj_s), proj_t, k)
    host_s = time.perf_counter() - t0
    logits = -d2_ref / temps[:, None]
    w_ref = np.exp(logits - logits.max(-1, keepdims=True))
    w_ref /= w_ref.sum(-1, keepdims=True)
    margins = {}
    for l in np.flatnonzero(ranks != ranks_ref):
        z = layers[int(l)]
        z = z.reshape(-1, z.shape[-1]) @ proj_t.T
        m, d = z.shape
        ev = np.sort(np.linalg.eigvalsh(z.T @ z / m))[::-1]
        edge = float(np.median(ev)) * (1 + (d / m) ** 0.5) ** 2
        lo, hi = sorted((int(ranks[l]), int(ranks_ref[l])))
        margins[int(l)] = float(np.abs(ev[lo:hi] - edge).max() / edge)
    reading = dict(
        k=k, ranks=ranks.tolist(), ranks_ref=ranks_ref.tolist(),
        ranks_equal=bool((ranks == ranks_ref).all()), edge_margins=margins,
        max_abs_dweights=float(np.abs(w - w_ref).max()),
        max_rel_dd2=float((np.abs(d2 - d2_ref) / np.abs(d2_ref)).max()),
        max_abs_dd2=float(np.abs(d2 - d2_ref).max()),
        d2_range=[float(d2_ref.min()), float(d2_ref.max())],
        weights_range=[float(w_ref.min()), float(w_ref.max())],
        weights_atol=weights_atol, d2_tol=d2_tol, selector_s=selector_s,
        host_s=host_s)
    d2_atol, d2_rtol = d2_tol
    ok = (all(v <= MP_EDGE_RTOL for v in margins.values())
          and reading["max_abs_dweights"] <= weights_atol
          and bool((np.abs(d2 - d2_ref) <= d2_atol + d2_rtol * np.abs(d2_ref)).all()))
    edge = f"; edge margins {margins} (tol {MP_EDGE_RTOL})" if margins else ""
    print(f"oracle {what} (K={k}): MP ranks {ranks.tolist()} vs float64 "
          f"{ranks_ref.tolist()} (equal: {reading['ranks_equal']}{edge}); max |dweights| "
          f"{reading['max_abs_dweights']:.3g} (tol {weights_atol}), max relative dd2 "
          f"{reading['max_rel_dd2']:.3g}, max |dd2| {reading['max_abs_dd2']:.3g} (tol "
          f"{d2_atol} + {d2_rtol} |d2|); oracle d2 in "
          f"[{reading['d2_range'][0]:.4g}, {reading['d2_range'][1]:.4g}], weights in "
          f"[{reading['weights_range'][0]:.4g}, {reading['weights_range'][1]:.4g}]; "
          f"selector {selector_s:.2f} s, oracle on the host {host_s:.1f} s", flush=True)
    if not ok:
        raise AssertionError(f"oracle {what}: {reading}")
    return reading


def oracle_phase(dev, table3: dict, table1: dict) -> dict:
    """Phase 5d: the selector on the card against the float64 oracle on
    three inputs. Table-3's real tokens (`table3`: phase 4's selector call,
    its tokens and K); Table-1's real tokens (the ViT-L/14 teacher's 24
    layers on the eval view of 5c's images, the 5c student's four points,
    a fresh selector of seed 1, 5c's K: the selector's eighs at K = 192 go
    to cuSOLVER); and the planted input at Table-1's widths
    (`planted_selector_inputs`: teacher (4, 256, 256, 1024), student
    (4, 256, 196, 384), the token counts the selector gets there, K =
    PLANTED_K). The launches of the three selector calls are counted."""
    import torch

    from basd_tpu_torch import kernels
    from basd_tpu_torch.losses import init_selector
    from basd_tpu_torch.models import extract_intermediates
    from basd_tpu_torch.ops.preprocess import eval_view

    t_start = time.perf_counter()
    torch.cuda.synchronize()
    kernels.reset_launches()
    readings = {"table3": oracle_check(
        "Table-3 real tokens", table3["selector"], table3["student_tokens"],
        table3["teacher_tokens"], table3["importance"], table3["k"],
        ORACLE_WEIGHTS_ATOL, ORACLE_D2)}

    size, raw, ims = table1["size"], table1["raw"], table1["images"]
    with torch.no_grad():
        t_tok, t_imp = extract_intermediates(
            table1["teacher"], eval_view(ims, size, size / raw, *TEACHER_STATS))
        s_tok = table1["state"].student(eval_view(ims, size, size / raw,
                                                  *DATASET_STATS)).tokens
    sel = init_selector(1, s_tok.shape[0], s_tok.shape[-1], t_tok.shape[-1], device=dev)
    readings["table1"] = oracle_check(
        "Table-1 real tokens", sel, s_tok, t_tok, t_imp, table1["k"],
        ORACLE_WEIGHTS_ATOL, ORACLE_D2)
    del t_tok, t_imp, s_tok

    t_tok, s_tok = planted_selector_inputs(
        sel.proj_s, sel.proj_t, (256, 256, 1024), (256, 196, 384), seed=0)
    imp = torch.full(t_tok.shape[:3], 1.0 / t_tok.shape[2], device=dev)
    readings["planted"] = oracle_check(
        f"Table-1 widths, planted ranks {PLANTED_RANKS}, point p on layer "
        f"{PLANTED_PAIRS}[p]", sel, s_tok, t_tok, imp, PLANTED_K,
        PLANTED_WEIGHTS_ATOL, PLANTED_D2)
    del t_tok, s_tok, imp
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    readings["launches"] = dict(kernels.LAUNCHES)
    readings["phase_s"] = time.perf_counter() - t_start
    readings["host_s"] = sum(readings[n]["host_s"] for n in ("table3", "table1", "planted"))
    print(f"oracle: phase {readings['phase_s']:.1f} s, of it the float64 oracle on the "
          f"host {readings['host_s']:.1f} s; launches {readings['launches']}", flush=True)
    return readings


# phase 5e: the port's own kernels by name in a torch.profiler trace, one
# pattern per counter (K2 counts its dq launch, one a call; K3 its ping-pong
# kernel or, above n = 96, its V^T replay, one a call)
KERNEL_NAMES = {name: r"void \(anonymous namespace\)::" + pattern + r"[<(]" for name, pattern in
                (("attention_fwd", r"attn_fwd_(mma|kernel)"),
                 ("attention_bwd", r"attn_(bwd_)?dq_(mma|kernel)"),
                 ("jacobi_eigh", r"jacobi_(pingpong|vt_replay)_kernel"),
                 ("warp", r"warp_\w*kernel"),
                 ("mp_rank", r"mp_rank_kernel"),
                 ("gelu_fwd", r"basd_gelu_fwd_\w*kernel"),
                 ("gelu_bwd", r"basd_gelu_bwd_\w*kernel"))}


def teacher_layers(tch) -> int:
    """Token layers a teacher gives: every block of a ViT, one for a CNN."""
    return tch.spec.depth if tch.spec.feature_format == "token" else 1


def gelu_mlps(module) -> int:
    """The GELU MLPs of a model (a ViT's `Mlp`, a ConvNeXt's
    `ConvNeXtMlp`): each runs the GELU kernel once a forward."""
    from basd_tpu_torch.models.cnn import ConvNeXtMlp
    from basd_tpu_torch.models.vit import Mlp

    return sum(isinstance(m, (Mlp, ConvNeXtMlp)) for m in module.modules())


def layer_norms(module) -> int:
    """The LayerNorms of a model (a ViT's 2 depth + 1, a ConvNeXt's stem,
    downsample and block norms): each runs the LayerNorm kernel once a
    forward that autograd does not need."""
    import torch

    return sum(isinstance(m, torch.nn.LayerNorm) for m in module.modules())


def per_step_launches(scfg, tch, pts, k, augment) -> dict:
    """Each kernel's launches in one train step of a configuration: K1 in
    every block, teacher's and student's, of a ViT with a CLS token inside
    the kernel gate (a student block twice under remat: its forward runs
    again in the backward), K2 in every such student block, K3 in each of
    the selector's three eighs (teacher and student Rayleigh-Ritz, the
    principal angles) that the Jacobi gate takes, K4 once per augmented
    view, the MP-rank kernel once (the teacher layers' ranks at n = D_s)
    inside its gate, the SwiGLU gate in every block of a SwiGLU teacher,
    the GELU forward in every GELU MLP of the teacher and of the student (a
    student's twice under remat), the GELU backward in the student's, the
    RoPE rotation in every block of a RoPE teacher and the LayerNorm kernel
    in every LayerNorm of the teacher (the student's run under autograd, on
    the composite)."""
    from basd_tpu_torch.losses.selector import selector_eigh_shapes
    from basd_tpu_torch.ops import attention as attn
    from basd_tpu_torch.spectral.ops import use_jacobi, use_mp_kernel

    def fused_blocks(c):
        ok = c.has_cls_token and attn.supports_fused(
            c.num_patches + c.num_prefix, c.embed_dim, c.embed_dim // c.num_heads)
        return c.depth if ok else 0

    student_blocks = fused_blocks(scfg)
    teacher_blocks = fused_blocks(tch.module.config) if tch.spec.family == "vit" else 0
    student_gelu = scfg.depth if scfg.ffn == "gelu" else 0
    l, p = teacher_layers(tch), len(pts)
    return {"attention_fwd": student_blocks * (2 if scfg.remat else 1) + teacher_blocks,
            "attention_bwd": student_blocks,
            "jacobi_eigh": sum(map(use_jacobi, selector_eigh_shapes(p, l, k))),
            "warp": int(augment), "jacobi_eigvals": 0, "attn_probe": 0,
            "mp_rank": int(use_mp_kernel(scfg.embed_dim)),
            "swiglu_gate": tch.spec.depth if tch.spec.family == "vit"
            and tch.spec.ffn == "swiglu" else 0,
            "gelu_fwd": student_gelu * (2 if scfg.remat else 1) + gelu_mlps(tch.module),
            "gelu_bwd": student_gelu,
            "rope_qk": tch.spec.depth if tch.spec.family == "vit"
            and tch.spec.positions == "rope" else 0,
            "layernorm": layer_norms(tch.module)}


def stage_table3(dev) -> dict:
    """Phase 3: Table-3 at full width, as bench.py's default arm stages it
    (DeiT-Tiny/4 student at 32 px, DINOv2 ViT-B/14 teacher, bf16, random
    weights from seeds, batch 128 of 40 px images from default_rng(0), the
    selector of seed 1, K calibrated on the eval view)."""
    import torch

    from basd_tpu_torch.losses import calibrate_subspace_k, extraction_points, init_selector
    from basd_tpu_torch.models import create_student, load_teacher
    from basd_tpu_torch.ops.preprocess import eval_view

    img, batch, num_classes, patch = 32, 128, 100, 4
    raw = img + 2 * patch
    teacher = load_teacher("dinov2_vitb14", img_size=img, dtype=torch.bfloat16, device=dev)
    points = extraction_points(12, 4)
    student, cfg = create_student(
        "vit_tiny_patch16", num_classes=num_classes, drop_path_rate=0.05,
        img_size=img, arch_overrides={"patch_size": patch},
        capture_layers=points, dtype=torch.bfloat16, remat=False, device=dev,
    )
    selector = init_selector(1, len(points), cfg.embed_dim,
                             teacher.spec.embed_dim, device=dev)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(
        (rng.random((batch, raw, raw, 3)) * 255).astype(np.uint8)).to(dev)
    labels = torch.from_numpy(
        rng.integers(0, num_classes, batch, dtype=np.int64)).to(dev)
    calib = eval_view(images, img, img / raw, *TEACHER_STATS)
    k = calibrate_subspace_k(teacher, cfg.embed_dim, calib, seed=0,
                             num_extraction_points=len(points))
    return dict(img=img, batch=batch, num_classes=num_classes, patch=patch, raw=raw,
                teacher=teacher, points=points, student=student, cfg=cfg,
                selector=selector, images=images, labels=labels, calib=calib, k=k)


def graph_phase(dev, t3: dict, per_step: dict, steps: int) -> dict:
    """Phase 5e: the Table-3 step as one CUDA graph, on phase 3's staging
    `t3`. Two students, selectors and train states from the same seeds
    (`make_train_step(augment=True)`, bench.py's step); `steps` eager
    steps (`step_fn.eager`) of one, the second under
    `torch.cuda.set_sync_debug_mode("error")` (any host round-trip
    raises), and `steps` calls of the other's graph route (one
    eager warm-up, then the capture and its replay, then replays). Every
    step's loss and metrics, the student's parameters, the temperatures,
    the optimizer's z and exp_avg_sq and the generator's state must be
    equal bit for bit; each replay's launches must be `per_step` by the
    counters and, in a torch.profiler trace of one more replay after the
    comparison, by kernel name (`KERNEL_NAMES`). Returns the step medians,
    the replay's device busy share, the capture's seconds and the graph
    pool's bytes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from basd_tpu_torch import kernels
    from basd_tpu_torch.losses import init_selector
    from basd_tpu_torch.models import create_student
    from basd_tpu_torch.tools.timing import device_events, device_us
    from basd_tpu_torch.training.train_step import make_train_step

    teacher, images, labels, points = t3["teacher"], t3["images"], t3["labels"], t3["points"]
    img, raw, num_classes = t3["img"], t3["raw"], t3["num_classes"]

    def stage():
        stu, cfg = create_student(
            "vit_tiny_patch16", num_classes=num_classes, drop_path_rate=0.05,
            img_size=img, arch_overrides={"patch_size": t3["patch"]}, capture_layers=points,
            dtype=torch.bfloat16, remat=False, device=dev)
        sel = init_selector(1, len(points), cfg.embed_dim, teacher.spec.embed_dim,
                            device=dev)
        init_fn, step_fn = make_train_step(
            stu, teacher, **STEP_HPARAMS, img_size=img, crop_ratio=img / raw,
            teacher_stats=TEACHER_STATS, dataset_stats=DATASET_STATS,
            num_classes=num_classes, subspace_k=t3["k"], augment=True)
        return step_fn, init_fn(0, sel)

    def run(step, state, sync_checked=()):
        """`steps` calls of `step`; (metrics on the host, ms, launches) per
        step, the steps in `sync_checked` under sync debug mode "error"."""
        out = []
        for i in range(steps):
            torch.cuda.synchronize()
            before = dict(kernels.LAUNCHES)
            t0 = time.perf_counter()
            if i in sync_checked:
                torch.cuda.set_sync_debug_mode("error")
            try:
                state, met = step(state, images, labels)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = {n: kernels.LAUNCHES[n] - before[n] for n in per_step}
            out.append(({n: v.cpu() for n, v in met.items()}, ms, counts))
        return out

    def final_state(state) -> dict:
        opt = state.optimizer
        tensors = {f"student {n}": p for n, p in state.student.named_parameters()}
        tensors["log_temperatures"] = state.selector.log_temperatures
        for i, p in enumerate(opt.param_groups[0]["params"]):
            tensors[f"z {i}"] = opt.state[p]["z"]
            tensors[f"exp_avg_sq {i}"] = opt.state[p]["exp_avg_sq"]
        tensors["generator"] = state.generator.get_state()
        return {n: t.detach().cpu() for n, t in tensors.items()}

    t_phase = time.perf_counter()
    eager_fn, eager_state = stage()
    eager = run(eager_fn.eager, eager_state, sync_checked=(1,))
    print(f"graph: eager step 1 of {steps} ran under set_sync_debug_mode('error'): no "
          "host round-trip", flush=True)
    graph_fn, graph_state = stage()
    torch.cuda.synchronize()
    kernels.reset_launches()
    graph = run(graph_fn, graph_state)
    torch.cuda.synchronize()
    graph_launches = dict(kernels.LAUNCHES)
    if graph_fn.route != "graph" or graph_fn.launches != per_step:
        raise AssertionError(f"graph: route {graph_fn.route} ({graph_fn.reason}), "
                             f"launches per replay {graph_fn.launches}, expected {per_step}")
    for i, ((em, _, ec), (gm, _, gc)) in enumerate(zip(eager, graph)):
        if gc != per_step or ec != per_step:
            raise AssertionError(f"graph step {i}: launches graph {gc} eager {ec}, "
                                 f"expected {per_step}")
        differ = [n for n in em if not torch.equal(em[n], gm[n])]
        if differ or set(em) != set(gm):
            raise AssertionError(f"graph step {i}: metrics {differ} differ from the "
                                 f"eager step's ({em} vs {gm})")
    ef, gf = final_state(eager_state), final_state(graph_state)
    differ = [n for n in ef if not torch.equal(ef[n], gf[n])]
    if differ:
        raise AssertionError(f"graph: after {steps} steps {len(differ)} of {len(ef)} "
                             f"tensors differ from the eager run's: {differ[:8]}")
    eager_ms = float(np.median([ms for _, ms, _ in eager[1:]]))
    replay_ms = float(np.median([ms for _, ms, _ in graph[2:]]))
    print(f"graph: {steps} steps bit for bit equal to {steps} eager steps (losses "
          f"{[float(m['loss']) for m, _, _ in graph]}, every metric, {len(ef) - 1} "
          "parameter, temperature and optimizer tensors, the generator's state); "
          f"launches per replay {graph_fn.launches} by the counters", flush=True)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        graph_fn(graph_state, images, labels)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    busy_ms = sum(device_us(e) for e in events) / 1e3
    by_name = {n: sum(e.count for e in events if re.match(pat, e.key))
               for n, pat in KERNEL_NAMES.items()}
    if by_name != {n: per_step[n] for n in KERNEL_NAMES}:
        raise AssertionError(f"graph: kernels by name in a profiled replay {by_name}, "
                             f"expected {per_step}")
    readings = dict(
        eager_step_ms=[ms for _, ms, _ in eager], graph_step_ms=[ms for _, ms, _ in graph],
        eager_median_ms=eager_ms, replay_median_ms=replay_ms,
        capture_s=graph_fn.capture_s, pool_bytes=graph_fn.pool_bytes,
        launches_per_replay=graph_fn.launches, launches_by_name=by_name,
        profiled_replay_ms=wall_ms, replay_busy_ms=busy_ms,
        replay_kernels=sum(e.count for e in events),
        busy_share_profiled=busy_ms / wall_ms, busy_share_median=busy_ms / replay_ms,
        launches=graph_launches, reason=graph_fn.reason)
    print(f"graph: Table-3 step median eager {eager_ms:.3f} ms, graph replay "
          f"{replay_ms:.3f} ms (steps 2..{steps - 1}; eager steps {readings['eager_step_ms']}, "
          f"graph steps {readings['graph_step_ms']}); capture {graph_fn.capture_s:.3f} s, "
          f"graph pool {graph_fn.pool_bytes} bytes; a profiled replay: {wall_ms:.3f} ms "
          f"wall, device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}% of it, "
          f"{100 * busy_ms / replay_ms:.1f}% of the replay median), "
          f"{readings['replay_kernels']} device kernels, the port's by name {by_name}; "
          f"phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    del eager_fn, eager_state, graph_fn, graph_state
    torch.cuda.empty_cache()
    return readings


def graph_check() -> int:
    """Phase 5e alone, about two minutes on one card: the kernels built,
    Table-3 staged (phase 3), `graph_phase`; its readings as one JSON line,
    then the card's name and power limit. Run it as
    `python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.graph_check())"`."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check needs the card", file=sys.stderr)
        return 2
    from basd_tpu_torch import kernels
    from basd_tpu_torch.device import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build_all()
    dev = torch.device("cuda", 0)
    per_step = {"attention_fwd": 24, "attention_bwd": 12, "jacobi_eigh": 3, "warp": 1,
                "jacobi_eigvals": 0, "attn_probe": 0, "mp_rank": 1, "swiglu_gate": 0,
                "gelu_fwd": 24, "gelu_bwd": 12, "rope_qk": 0, "layernorm": 25}
    readings = graph_phase(dev, stage_table3(dev), per_step, MAIN_STEPS)
    print(json.dumps(readings))
    print(card_line(dev))
    return 0


# phase 5f: the MP-rank kernel (`csrc/mp_rank.cu`) against its plain version
# (`spectral/tridiag.py:mp_rank_sturm`, op by op on the card) and the float64
# oracle. Ranks equal to the plain version's; against the oracle equal, or
# differing only by eigenvalues within MP_EDGE_RTOL of the edge. The
# tridiagonal: the same reflectors with fp32 sums of x^T x, A v and p^T v
# in another order; after n - 2 steps two fp32 reductions of one matrix
# differ by far more than one rounding where a column's norm below the
# diagonal is small, as in the designed spectra's flat bulk. So the kernel's
# and the plain version's are each held against the float64 reduction
# (`householder_tridiag_np`) within MP_TRIDIAG_RTOL: the diagonal relative
# to max|diag|, the squared off-diagonal to max|diag|^2. The plain version
# reads up to 1.26e-3 and 2.06e-4 there (the designed (24, 384, 384)), the
# kernel 1.56e-3 and 3.12e-4; on the cells' Grams both stay below 2.5e-5
# and 1.1e-7 (an H100 at 700 W, PERF.md section 6).
MP_TRIDIAG_RTOL = (5e-3, 1e-3)
# (batch, n) of the planted covariances (m = 4 n): the cells' teacher Grams
# (192 on one CTA, 384 on four) and the edges of the cluster routes (n = 8,
# the one-CTA route's last n 238 and the two-CTA route's first 239, 512 and
# 640 on eight)
MP_PLANTED = ((12, 192), (24, 384), (4, 8), (4, 33), (4, 238), (4, 239), (4, 512),
              (2, 640))
# the cells whose teacher Grams the check reads from their first three steps
MP_CELLS = ("t3_cifar100_train", "t1_imagenet_train")


def planted_mp_features(rng, b: int, n: int, m: int, spiked: bool) -> tuple:
    """((b, m, n) float64 features, planted ranks). Designed: the
    covariance's eigenvalues are the planted rank's at 3 to 30 times the
    MP edge factor, the rest uniform within min(0.4, (edge - 1) / 2) of 1,
    so the median lies near 1 and no eigenvalue near the threshold. Spiked: Gaussian noise plus the planted
    rank's strong directions, so the noise's top eigenvalues crowd the
    edge, as tokens' do."""
    feats, ranks = [], []
    edge = (1.0 + (n / m) ** 0.5) ** 2
    for _ in range(b):
        r = int(rng.integers(1, max(2, n // 4)))
        if spiked:
            x = rng.standard_normal((m, n))
            u = rng.standard_normal((m, r)) / m ** 0.5
            w = np.linalg.qr(rng.standard_normal((n, r)))[0]
            x += (u * (edge * rng.uniform(3.0, 30.0, r)) ** 0.5 * m ** 0.5) @ w.T
        else:
            half = min(0.4, (edge - 1.0) / 2)
            lam = np.concatenate([edge * rng.uniform(3.0, 30.0, r),
                                  rng.uniform(1.0 - half, 1.0 + half, n - r)])
            q = np.linalg.qr(rng.standard_normal((m, n)))[0]
            v = np.linalg.qr(rng.standard_normal((n, n)))[0]
            x = (q * (m * lam) ** 0.5) @ v.T
        feats.append(x)
        ranks.append(r)
    return np.stack(feats), ranks


def householder_tridiag_np(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """`spectral.tridiag.householder_tridiag` in float64 numpy: (diag
    (b, n), off (b, n - 1)) of symmetric (b, n, n)."""
    a = (a + a.transpose(0, 2, 1)) * 0.5
    n = a.shape[-1]
    idx = np.arange(n)
    for k in range(n - 2):
        x = a[:, :, k] * (idx > k)
        xnorm = np.sqrt((x * x).sum(-1, keepdims=True))
        alpha = -np.where(a[:, k + 1, k][:, None] >= 0.0, 1.0, -1.0) * xnorm
        v = x - np.where(idx == k + 1, alpha, 0.0)
        vtv = (v * v).sum(-1, keepdims=True)
        tau = np.where(vtv > 0.0, 2.0 / np.where(vtv > 0.0, vtv, 1.0), 0.0)
        p = tau * np.einsum("bij,bj->bi", a, v)
        u = p - 0.5 * tau * (p * v).sum(-1, keepdims=True) * v
        a = a - v[:, :, None] * u[:, None, :] - u[:, :, None] * v[:, None, :]
    return np.diagonal(a, axis1=1, axis2=2), np.diagonal(a[:, 1:, :-1], axis1=1, axis2=2)


def cell_teacher_grams(cell: str, seed: int, dev) -> list:
    """The selector's teacher Grams and sample counts of a benchmark cell's
    first three steps, run eagerly from the cell's seeds."""
    import importlib

    import torch

    from basd_tpu_torch.losses import selector as selector_mod
    from benchmark.harness import Feed, cell_spec, derive_seeds

    spec = cell_spec(cell)
    cfg = spec.config
    seeds = derive_seeds(seed)
    prog = importlib.import_module(f"benchmark.stage.{cfg['family']}").Program(cfg, seeds, dev)
    feed = Feed(cfg, spec.traffic, seeds["data"], dev, keep=0)
    real = selector_mod.marchenko_pastur_rank_gram
    seen = []
    selector_mod.marchenko_pastur_rank_gram = (
        lambda g, m: seen.append((g.detach().clone(), m)) or real(g, m))
    try:
        for _ in range(3):
            prog.eager_step(*next(feed))
    finally:
        selector_mod.marchenko_pastur_rank_gram = real
    # one call a step on (layers, D_s, D_s): a selector that stopped calling
    # it by that name would leave the check nothing to compare
    want = (cfg["teacher"]["depth"], cfg["student"]["embed_dim"], cfg["student"]["embed_dim"])
    if len(seen) != 3 or any(tuple(g.shape) != want for g, _ in seen):
        raise AssertionError(f"mp_rank {cell}: caught {[tuple(g.shape) for g, _ in seen]} "
                             f"from three steps, want three {want}")
    torch.cuda.synchronize()
    del prog, feed
    torch.cuda.empty_cache()
    return seen


def mp_rank_phase(dev, seed: int = 20) -> dict:
    """Phase 5f: the MP-rank kernel on planted covariances (designed and
    spiked) and on the cells' own teacher Grams, against the plain version
    on the card and the float64 oracle; then `tools/time_mp_rank.py` (the kernel's device time beside the plain
    version's replayed graph and `eigvalsh`)."""
    import torch

    from basd_tpu_torch import kernels
    from basd_tpu_torch.spectral.mp_rank_kernel import (
        cluster_size,
        mp_covariance,
        mp_rank_raw_cuda,
    )
    from basd_tpu_torch.spectral.reference import marchenko_pastur_rank_np
    from basd_tpu_torch.spectral.tridiag import householder_tridiag, mp_rank_sturm
    from basd_tpu_torch.tools import time_mp_rank

    t_phase = time.perf_counter()
    kernels.library("mp_rank")
    readings = {"cases": {}}

    def compare(what, gram, m, oracle_eigs):
        """Kernel against plain (and the oracle's float64 eigenvalues of
        the same covariances): its reading, or raise."""
        n = gram.shape[-1]
        cov = mp_covariance(gram, m)
        want = mp_rank_sturm(cov, m).cpu()
        diag_p, off_p = householder_tridiag(cov)
        ranks, diag, off2 = mp_rank_raw_cuda(gram, m)
        ranks = ranks.cpu()
        diag64, off64 = householder_tridiag_np(cov.double().cpu().numpy())
        scale = float(np.abs(diag64).max())

        def dist(d, o2):
            return (float(np.abs(d.double().cpu().numpy() - diag64).max()) / scale,
                    float(np.abs(o2.double().cpu().numpy() - off64 ** 2).max()) / scale ** 2)

        kernel_err, plain_err = dist(diag, off2), dist(diag_p, off_p * off_p)
        tridiag_ok = all(e <= tol for errs in (kernel_err, plain_err)
                         for e, tol in zip(errs, MP_TRIDIAG_RTOL))
        oracle, edges = [], []
        for w in oracle_eigs:
            lam = float(np.median(w)) * (1 + (n / m) ** 0.5) ** 2
            oracle.append(int((w > lam).sum()))
            edges.append(float(np.abs(w / lam - 1.0).min()))
        row = dict(ranks=ranks.tolist(), plain=want.tolist(), oracle=oracle,
                   cluster=cluster_size(n), kernel_vs_f64=kernel_err, plain_vs_f64=plain_err,
                   kernel_vs_plain=((diag - diag_p).abs().amax().item() / scale,
                                    (off2 - off_p * off_p).abs().amax().item() / scale ** 2),
                   nearest_edge_rel=edges)
        readings["cases"][what] = row
        # a rank off the oracle's only where an eigenvalue sits at the edge
        off_oracle = [i for i, (r, o) in enumerate(zip(row["ranks"], oracle)) if r != o]
        ok = (torch.equal(ranks, want) and tridiag_ok
              and all(edges[i] <= MP_EDGE_RTOL for i in off_oracle))
        print(f"mp_rank {what}: cluster {row['cluster']}, ranks "
              f"{'equal' if torch.equal(ranks, want) else 'DIFFER'} to the plain version's, "
              f"{len(off_oracle)} off the oracle's (nearest eigenvalue {min(edges):.3g} of "
              f"the edge); from the float64 reduction diag, off^2: kernel "
              f"{kernel_err[0]:.3g}, {kernel_err[1]:.3g}, plain {plain_err[0]:.3g}, "
              f"{plain_err[1]:.3g}", flush=True)
        if not ok:
            raise AssertionError(f"mp_rank {what}: {row}")

    rng = np.random.default_rng(seed)
    for spiked in (False, True):
        for b, n in MP_PLANTED:
            m = 4 * n
            x, planted = planted_mp_features(rng, b, n, m, spiked)
            gram = torch.from_numpy(np.einsum("bmi,bmj->bij", x, x).astype(np.float32)).to(dev)
            eigs = [np.linalg.eigvalsh(f.T @ f / m) for f in x]
            oracle = [marchenko_pastur_rank_np(f) for f in x]
            if not spiked and oracle != planted:
                raise AssertionError(f"mp_rank planted {b, n}: oracle {oracle}, planted {planted}")
            compare(f"{'spiked' if spiked else 'designed'} ({b}, {n}, {n}) m {m}", gram, m,
                    eigs)
    for i, cell in enumerate(MP_CELLS):
        for step, (gram, m) in enumerate(cell_teacher_grams(cell, seed + i, dev)):
            cov = gram.double().cpu().numpy() / m
            eigs = [np.linalg.eigvalsh((c + c.T) * 0.5) for c in cov]
            compare(f"{cell} step {step} {tuple(gram.shape)} m {m}", gram.contiguous(), m, eigs)
    readings["timing"] = time_mp_rank.main()
    readings["phase_s"] = time.perf_counter() - t_phase
    print(f"mp_rank: phase {readings['phase_s']:.1f} s", flush=True)
    return readings


def mp_rank_check() -> int:
    """Phase 5f alone, a few minutes on one card: the kernels built and
    `mp_rank_phase`; its readings as JSON into MP_RANK_JSON, then the
    card's name and power limit. Run it
    as `python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.mp_rank_check())"`."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check needs the card", file=sys.stderr)
        return 2
    from basd_tpu_torch import kernels
    from basd_tpu_torch.device import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(kernels.build_all().get("mp_rank", ""), flush=True)  # registers, spills
    dev = torch.device("cuda", 0)
    readings = mp_rank_phase(dev)
    os.makedirs(os.path.dirname(MP_RANK_JSON), exist_ok=True)
    with open(MP_RANK_JSON, "w") as f:
        json.dump(readings, f)
    print(card_line(dev))
    return 0


# phase 5g: the SwiGLU gate at the ViT-g teacher's shape (batch 256 x 257
# tokens, g = 4096), the teacher forward's blocks for the float32
# reference, and the bounds of the forward's check, each layer's tokens
# against that layer's max |reference|: the port in float32 within 1e-4
# (the same math in another order: K1's CUDA-core kernel, split qkv); in
# bf16 within 0.25, the CLS importance within 5e-2: bf16's 2^-8 steps
# compound through 40 residual blocks at LayerScale 1 (an H100 reads 1.8e-2
# after block 1, rising steadily to 0.154 after block 40, and 1.5e-2 on the
# importance)
SWIGLU_JSON = os.path.join("chiprun_out", "swiglu.json")
VITG_ROWS, VITG_G = 256 * 257, 4096
VITG_REF_CHUNK = 16
VITG_FP32_RTOL, VITG_BF16_RTOL, VITG_IMPORTANCE_ATOL = 1e-4, 0.25, 5e-2
VITG_STEPS = 6
VITG_SPAN_STEPS = 5


def swiglu_gate_case(dev, rows: int, g: int, dtype, seed: int) -> dict:
    """The gate kernel on seeded (rows, 2g) values against its plain
    version (within one ulp of the output dtype, `kernel_smoke.GATE_ULP`),
    timed by an event loop and by device time alone beside the plain
    version and `F.silu(a) * b`, with its bound (3 rows g elements over the
    memory bandwidth)."""
    import torch
    import torch.nn.functional as F

    from basd_tpu_torch.ops.activations import gate_route, swiglu_gate, swiglu_gate_plain
    from basd_tpu_torch.tools.timing import device_ms, kernel_ms
    from basd_tpu_torch.utils.kernel_smoke import GATE_ULP

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (3.0 * torch.randn((rows, 2 * g), generator=gen, device=dev)).to(dtype)
    got, want = swiglu_gate(x), swiglu_gate_plain(x)
    gap = (got.float() - want.float()).abs()
    over = int((gap > GATE_ULP[dtype] * want.float().abs()).sum())
    if over:
        raise AssertionError(f"swiglu_gate ({rows}, {2 * g}) {dtype}: {over} values more "
                             f"than one ulp from the plain version, max err {gap.max():.3g}")
    a, b = x[:, :g], x[:, g:]
    bound_ms = 3 * rows * g * x.element_size() / HBM_BYTES_PER_S * 1e3
    row = dict(route=gate_route(x, got), differing=int((got != want).sum()),
               max_abs_err=float(gap.max()),
               ms=device_ms(lambda: swiglu_gate(x), dev),
               device_ms=kernel_ms(lambda: swiglu_gate(x), dev),
               plain_ms=device_ms(lambda: swiglu_gate_plain(x), dev),
               library_ms=device_ms(lambda: F.silu(a) * b, dev),
               library_device_ms=kernel_ms(lambda: F.silu(a) * b, dev),
               bound_ms=bound_ms, bound_by="bytes")
    row["roofline_pct"] = 100.0 * bound_ms / row["device_ms"]
    return row


def vitg14_forward_check(dev, tch) -> dict:
    """One forward of the ViT-g teacher at batch 256, in float32 and in the
    teacher's bf16, against the plain float32 reference (TF32 off),
    computed in blocks of VITG_REF_CHUNK images: each layer's largest token
    gap over that layer's largest reference value, and the importance's
    largest gap. The float32 forward (the same parameters in a module that
    computes in float32) is held to VITG_FP32_RTOL, the bf16 one to
    VITG_BF16_RTOL and VITG_IMPORTANCE_ATOL."""
    import torch

    from basd_tpu_torch import kernels
    from basd_tpu_torch.models.teacher import build_teacher_module, extract_intermediates
    from basd_tpu_torch.reference import vit_swiglu

    spec = tch.spec
    with torch.device("meta"):
        fp32 = build_teacher_module(spec, tch.img_size, dtype=torch.float32)
    fp32.load_state_dict(tch.module.state_dict(), assign=True)
    fp32 = tch._replace(module=fp32.eval())
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((256, tch.img_size, tch.img_size, 3), generator=gen, device=dev)
    before = kernels.LAUNCHES["swiglu_gate"]
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    tokens, importance = extract_intermediates(tch, x)
    torch.cuda.synchronize(dev)
    forward_s = time.perf_counter() - t0
    launches = kernels.LAUNCHES["swiglu_gate"] - before
    tokens32, importance32 = extract_intermediates(fp32, x)
    weights = tch.module.state_dict()
    depth = spec.depth
    zeros = lambda: torch.zeros(depth, device=dev)
    gap, gap32, scale = zeros(), zeros(), zeros()
    imp_gap, imp_gap32 = 0.0, 0.0
    for lo in range(0, x.shape[0], VITG_REF_CHUNK):
        hi = lo + VITG_REF_CHUNK
        with torch.no_grad():
            ref_tok, ref_imp = vit_swiglu.forward(weights, x[lo:hi], patch_size=spec.patch_size,
                                                  depth=depth, heads=spec.num_heads)
        gap = torch.maximum(gap, (tokens[:, lo:hi].float() - ref_tok).abs().amax((1, 2, 3)))
        gap32 = torch.maximum(gap32, (tokens32[:, lo:hi] - ref_tok).abs().amax((1, 2, 3)))
        scale = torch.maximum(scale, ref_tok.abs().amax((1, 2, 3)))
        imp_gap = max(imp_gap, float((importance[:, lo:hi] - ref_imp).abs().max()))
        imp_gap32 = max(imp_gap32, float((importance32[:, lo:hi] - ref_imp).abs().max()))
    rel, rel32 = (gap / scale).tolist(), (gap32 / scale).tolist()
    out = dict(tokens_rel_by_layer=rel, tokens_rel=max(rel), importance_abs=imp_gap,
               fp32_tokens_rel_by_layer=rel32, fp32_tokens_rel=max(rel32),
               fp32_importance_abs=imp_gap32, gate_launches=launches, forward_s=forward_s,
               tokens_shape=list(tokens.shape), layer_max=scale.tolist())
    if (max(rel32) > VITG_FP32_RTOL or imp_gap32 > VITG_FP32_RTOL
            or max(rel) > VITG_BF16_RTOL or imp_gap > VITG_IMPORTANCE_ATOL
            or launches != depth or list(tokens.shape) != [depth, 256, 256, spec.embed_dim]):
        raise AssertionError(f"ViT-g forward against the float32 reference: {out}; bounds "
                             f"{VITG_FP32_RTOL} (float32), {VITG_BF16_RTOL} / "
                             f"{VITG_IMPORTANCE_ATOL} (bf16), {depth} gates")
    return out


def teacher_step_check(dev, tch) -> dict:
    """The Table-1 step (ViT-S/16 student at 224 px, batch 256 from 256 px,
    K = 96, augment, remat) with a 40-block SwiGLU teacher (ViT-g/14 or
    DINOv3 ViT-7B/16) through `make_train_step`: its route (`graph`), the
    launches of each call and of one replay (`per_step_launches`: K1 in
    the student's 12 blocks twice and in each teacher block, a gate a
    teacher block, a rotation a block of a RoPE teacher, the LayerNorm
    kernel 2 depth + 1 times, the teacher's LayerNorms), the step's peak
    memory, the wall ms of the replays and the median of each stage's span
    over VITG_SPAN_STEPS more replays (`step_fn.spans`, unprofiled)."""
    import torch

    from basd_tpu_torch import kernels
    from basd_tpu_torch.losses import extraction_points, init_selector
    from basd_tpu_torch.losses.selector import selector_k
    from basd_tpu_torch.models import create_student
    from basd_tpu_torch.training.train_step import make_train_step

    points = extraction_points(12, 4)
    student, scfg = create_student("vit_small_patch16", num_classes=1000, drop_path_rate=0.1,
                                   img_size=224, capture_layers=points, remat=True, device=dev)
    sel = init_selector(1, len(points), scfg.embed_dim, tch.spec.embed_dim, device=dev)
    init_fn, step_fn = make_train_step(
        student, tch, learning_rate=1e-3, weight_decay=0.05, warmup_steps=1000,
        label_smoothing=0.001, img_size=224, crop_ratio=0.875,
        teacher_stats=(tch.mean, tch.std),
        dataset_stats=((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)), num_classes=1000,
        subspace_k=None, augment=True)
    state = init_fn(0, sel)
    gen = torch.Generator(device=dev).manual_seed(3)
    images = torch.randint(0, 256, (256, 256, 256, 3), generator=gen, device=dev,
                           dtype=torch.uint8)
    labels = torch.randint(0, 1000, (256,), generator=gen, device=dev)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    calls, wall_ms = [], []
    for _ in range(VITG_STEPS):
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, images, labels)
        torch.cuda.synchronize(dev)
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        calls.append({n: kernels.LAUNCHES[n] - before[n] for n in before})
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    rec = step_fn.spans
    rec.on()
    for _ in range(VITG_SPAN_STEPS):
        state, _ = step_fn(state, images, labels)
    rec.off()
    by_name = {}
    for sp in rec.read():
        by_name.setdefault(sp.name, []).append((sp.end - sp.start) / 1e6)
    span_ms = {name: float(np.median(v)) for name, v in by_name.items()}
    k = selector_k(None, scfg.embed_dim, 256 * 196, 256 * 256)
    want = per_step_launches(scfg, tch, points, k, True)
    out = dict(route=step_fn.route, reason=step_fn.reason, k=k, per_step=want,
               replay_launches=step_fn.launches, call_launches=calls,
               launches={n: sum(c[n] for c in calls) for n in calls[0]},
               wall_ms=wall_ms, replay_ms=float(np.median(wall_ms[2:])),
               peak_gib=peak_gib, span_ms=span_ms,
               loss=float(metrics["loss"]), mp_ranks=metrics["mp_ranks"].tolist())
    depth = tch.spec.depth
    rope = depth if tch.spec.positions == "rope" else 0
    if (step_fn.route != "graph" or step_fn.launches != want or want["swiglu_gate"] != depth
            or want["rope_qk"] != rope or want["attention_fwd"] != 2 * scfg.depth + depth
            or want["layernorm"] != 2 * depth + 1
            or any(c != want for c in calls[2:]) or not np.isfinite(out["loss"])):
        raise AssertionError(f"{tch.spec.name} train step: {out}")
    return out


def swiglu_check() -> int:
    """Phase 5g alone, a few minutes on one card: the kernels built, the
    gate's cases, the ViT-g teacher forward and the ViT-g Table-1 step; its
    readings as JSON into SWIGLU_JSON, then the card's name and power
    limit. Run it as `python3 -c "import chip_smoke, sys;
    sys.exit(chip_smoke.swiglu_check())"`."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check needs the card", file=sys.stderr)
        return 2
    from basd_tpu_torch import kernels
    from basd_tpu_torch.device import card_line
    from basd_tpu_torch.models import load_teacher

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(kernels.build_all().get("swiglu", ""), flush=True)  # registers, spills
    dev = torch.device("cuda", 0)
    readings = {"gate": {}}
    for rows, g, dtype in ((VITG_ROWS, VITG_G, torch.bfloat16), (VITG_ROWS, VITG_G, torch.float32),
                           (4096, 170, torch.bfloat16), (4096, 4100, torch.bfloat16)):
        case = f"({rows}, {2 * g}) {str(dtype).split('.')[-1]}"
        row = swiglu_gate_case(dev, rows, g, dtype, seed=len(readings["gate"]))
        readings["gate"][case] = row
        print(f"kernel swiglu_gate {case}: route {row['route']}, {row['differing']} values "
              f"differ from the plain version (max err {row['max_abs_err']:.3g}); ms "
              f"{row['ms']:.4f} (device {row['device_ms']:.4f}), bound {row['bound_ms']:.4f} "
              f"({row['roofline_pct']:.1f}%), plain {row['plain_ms']:.4f}, F.silu(a) * b "
              f"{row['library_ms']:.4f} (device {row['library_device_ms']:.4f})", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tch = load_teacher("dinov2_vitg14", 224, seed=0, device=dev)
    readings["load_teacher_s"] = time.perf_counter() - t0
    with torch.no_grad():
        for blk in tch.module.blocks:
            blk.ls1.gamma.fill_(1.0)
            blk.ls2.gamma.fill_(1.0)
    readings["forward"] = vitg14_forward_check(dev, tch)
    fwd = readings["forward"]
    print(f"ViT-g forward at batch 256: {fwd['forward_s']:.3f} s; against the float32 "
          f"reference, of each layer's max: float32 tokens {fwd['fp32_tokens_rel']:.3g} "
          f"(bound {VITG_FP32_RTOL}), importance {fwd['fp32_importance_abs']:.3g}; bf16 "
          f"tokens {fwd['tokens_rel']:.3g} (bound {VITG_BF16_RTOL}), importance "
          f"{fwd['importance_abs']:.3g} (bound {VITG_IMPORTANCE_ATOL}); "
          f"{fwd['gate_launches']} gates; teacher loaded in {readings['load_teacher_s']:.1f} s",
          flush=True)
    torch.cuda.empty_cache()
    readings["step"] = teacher_step_check(dev, tch)
    step = readings["step"]
    print(f"ViT-g Table-1 step: route {step['route']} ({step['reason']}); launches a replay "
          f"{step['replay_launches']}; replays {step['replay_ms']:.1f} ms (wall, median); "
          f"peak {step['peak_gib']:.2f} GiB; loss {step['loss']:.5f}; stage spans (median ms "
          f"of {VITG_SPAN_STEPS} replays) {step['span_ms']}", flush=True)
    readings["card"] = card_line(dev)
    os.makedirs(os.path.dirname(SWIGLU_JSON), exist_ok=True)
    with open(SWIGLU_JSON, "w") as f:
        json.dump(readings, f)
    print(readings["card"])
    return 0


# phase 5h: the erf GELU kernels (`csrc/gelu.cu`) at the MLP widths of the
# benchmark's cells, each case (label, rows, width, dtype); the tail case
# holds n % 8 = 7 values past its last whole vector, the unaligned one is a
# view one element into its buffer (the scalar route)
GELU_JSON = os.path.join("chiprun_out", "gelu.json")
GELU_CASES = (("t1 teacher", 65792, 4096, "bfloat16"), ("t1 student", 50432, 1536, "bfloat16"),
              ("t3 teacher", 640, 3072, "bfloat16"), ("t3 student", 8320, 768, "bfloat16"),
              ("t1 student fp32", 50432, 1536, "float32"), ("tail", 4099, 13, "bfloat16"),
              ("unaligned", 4096, 1536, "bfloat16"))
GELU_CELLS = ("t3_cifar100_train", "t1_imagenet_train", "t1_vitg14_imagenet_train")
GELU_SEED = 3000000019


def ulp_gap(got, want) -> tuple[int, float]:
    """(elements that differ, the largest difference in units of the last
    place of `want`'s dtype at each differing value)."""
    import torch

    differ = got != want
    count = int(differ.sum())
    if not count:
        return 0, 0.0
    g, w = got[differ].double(), want[differ].double()
    bits = 7 if want.dtype == torch.bfloat16 else 23
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), (e - 1).clamp(min=-126) - bits)
    return count, float(((g - w).abs() / ulp).max())


def gelu_case(dev, label: str, rows: int, width: int, dtype_name: str, seed: int) -> dict:
    """The GELU kernels on seeded (rows, width) values x and upstream
    gradients dy: the forward bit for bit F.gelu(x.float()).to(x.dtype); the
    backward, alone and through `Gelu`'s autograd, against the composite's
    autograd (at most one ulp, the differing elements counted); each timed
    by device time alone (`kernel_ms`) beside the composite (the backward's:
    dy widened, aten's gelu_backward on the saved fp32 x, rounded), torch's
    own GELU in the dtype and its bound (2 and 3 n element-size bytes over
    the memory bandwidth)."""
    import torch
    import torch.nn.functional as F

    from basd_tpu_torch.ops.activations import (Gelu, gelu_backward_cuda, gelu_cuda,
                                                gelu_plain, gelu_route)
    from basd_tpu_torch.tools.timing import device_ms, kernel_ms

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = rows * width
    draw = lambda: 3.0 * torch.randn((rows, width), generator=gen, device=dev)
    if label == "unaligned":
        x = torch.empty(n + 1, dtype=dtype, device=dev)[1:].view(rows, width)
        dy = torch.empty(n + 1, dtype=dtype, device=dev)[1:].view(rows, width)
        x.copy_(draw())
        dy.copy_(draw())
    else:
        x, dy = draw().to(dtype), draw().to(dtype)
    y = gelu_cuda(x)
    want = gelu_plain(x)
    fwd_differ = int((y != want).sum())
    dx = gelu_backward_cuda(dy, x)
    xg = x.clone().requires_grad_(True)
    F.gelu(xg.float()).to(dtype).backward(dy)
    composite_dx = xg.grad
    xf = xg.detach().clone().requires_grad_(True)
    Gelu.apply(xf).backward(dy)
    bwd_differ, bwd_ulps = ulp_gap(dx, composite_dx)
    route = gelu_route(x, y)
    if fwd_differ or bwd_ulps > 1.0 or not torch.equal(xf.grad, dx):
        raise AssertionError(f"gelu {label} ({rows}, {width}) {dtype_name}: forward "
                             f"{fwd_differ} values differ from the composite; backward "
                             f"{bwd_differ} differ by up to {bwd_ulps} ulps (1 allowed); "
                             f"through Gelu equal to the kernel's: "
                             f"{torch.equal(xf.grad, dx)}")
    del xg, xf
    el = x.element_size()
    saved = x.float()
    composite_bwd = lambda: torch.ops.aten.gelu_backward(dy.float(), saved).to(dtype)
    fwd = dict(route=route, differing=fwd_differ, max_abs_err=0.0,
               ms=device_ms(lambda: gelu_cuda(x), dev),
               device_ms=kernel_ms(lambda: gelu_cuda(x), dev),
               plain_ms=kernel_ms(lambda: gelu_plain(x), dev),
               library_ms=kernel_ms(lambda: F.gelu(x), dev),
               bound_ms=2 * n * el / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    bwd = dict(route=route, differing=bwd_differ, max_ulps=bwd_ulps,
               max_abs_err=float((dx.float() - composite_dx.float()).abs().max()),
               ms=device_ms(lambda: gelu_backward_cuda(dy, x), dev),
               device_ms=kernel_ms(lambda: gelu_backward_cuda(dy, x), dev),
               plain_ms=kernel_ms(composite_bwd, dev),
               library_ms=kernel_ms(lambda: torch.ops.aten.gelu_backward(dy, x), dev),
               bound_ms=3 * n * el / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    for row in (fwd, bwd):
        row["roofline_pct"] = 100.0 * row["bound_ms"] / row["device_ms"]
    return {"fwd": fwd, "bwd": bwd}


def stage_cell(dev, cell: str, seed: int) -> tuple:
    """The cell's program staged as the benchmark stages it
    (`benchmark/stage/<family>.py`, full size) and one seeded batch:
    (program, configuration, images, labels)."""
    import importlib

    import torch

    from benchmark import harness

    cfg = harness.cell_spec(cell).config
    stage = importlib.import_module(f"benchmark.stage.{cfg['family']}")
    prog = stage.Program(cfg, harness.derive_seeds(seed), dev)
    b, raw = cfg["data"]["batch_size"], cfg["data"]["raw_size"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    images = torch.randint(0, 256, (b, raw, raw, 3), generator=gen, device=dev,
                           dtype=torch.uint8)
    labels = torch.randint(0, cfg["student"]["num_classes"], (b,), generator=gen, device=dev)
    return prog, cfg, images, labels


def gelu_cell_launches(dev, cell: str, seed: int) -> dict:
    """The cell's program (`stage_cell`), three steps (warm-up, capture,
    replay) on one seeded batch: its route and one replay's launches, the
    GELU's against `benchmark/costs/gelu.py`'s calls."""
    import torch

    from benchmark.costs.gelu import gelu_calls

    prog, cfg, images, labels = stage_cell(dev, cell, seed)
    for _ in range(3):
        metrics = prog.step(images, labels)
    torch.cuda.synchronize(dev)
    want = {"gelu_fwd": len(gelu_calls(cfg, backward=False)),
            "gelu_bwd": len(gelu_calls(cfg, backward=True))}
    got = {name: prog.step_fn.launches[name] for name in want}
    out = dict(route=prog.route[0], replay_launches=prog.step_fn.launches, gelu=got,
               costs_calls=want, loss=float(metrics["loss"]))
    del prog
    torch.cuda.empty_cache()
    if out["route"] != "graph" or got != want or not np.isfinite(out["loss"]):
        raise AssertionError(f"{cell}: {out}")
    return out


def gelu_check() -> int:
    """Phase 5h alone, a few minutes on one card: the kernels built, the
    GELU cases, the benchmark cells' GELU launches a replay; its readings as
    JSON into GELU_JSON, then the card's name and power limit. Run it as
    `python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.gelu_check())"`."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check needs the card", file=sys.stderr)
        return 2
    from basd_tpu_torch import kernels
    from basd_tpu_torch.device import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(kernels.build_all().get("gelu", ""), flush=True)  # registers, spills
    dev = torch.device("cuda", 0)
    readings = {"cases": {}, "cells": {}}
    for i, (label, rows, width, dtype) in enumerate(GELU_CASES):
        case = f"{label} ({rows}, {width}) {dtype}"
        row = readings["cases"][case] = gelu_case(dev, label, rows, width, dtype, GELU_SEED + i)
        f, b = row["fwd"], row["bwd"]
        print(f"kernel gelu {case}: route {f['route']}; forward bit for bit, device "
              f"{f['device_ms']:.4f} ms (event loop {f['ms']:.4f}), bound {f['bound_ms']:.4f} "
              f"({f['roofline_pct']:.1f}%), composite {f['plain_ms']:.4f}, F.gelu "
              f"{f['library_ms']:.4f}; backward {b['differing']} values differ from the "
              f"composite's autograd (max {b['max_ulps']:.3g} ulp), device "
              f"{b['device_ms']:.4f} ms, bound {b['bound_ms']:.4f} ({b['roofline_pct']:.1f}%), "
              f"composite {b['plain_ms']:.4f}, aten gelu_backward {b['library_ms']:.4f}",
              flush=True)
        torch.cuda.empty_cache()
    for cell in GELU_CELLS:
        row = readings["cells"][cell] = gelu_cell_launches(dev, cell, GELU_SEED)
        print(f"{cell}: route {row['route']}; GELU launches a replay {row['gelu']} "
              f"(costs/gelu.py {row['costs_calls']}); all {row['replay_launches']}", flush=True)
    readings["card"] = card_line(dev)
    os.makedirs(os.path.dirname(GELU_JSON), exist_ok=True)
    with open(GELU_JSON, "w") as f:
        json.dump(readings, f)
    print(readings["card"])
    return 0


# phase 5i: the selector's teacher projection (`losses/selector.py:_project`)
# at the main path's stacks, t1's ViT-L/14 (24 layers) and vg's ViT-g/14 (40
# layers), each layer 256 images x 256 patch tokens, projected to the
# student's 384: the tensor-core product (bf16 operands, fp32 accumulation
# and output) against the fp32 form it replaced (`_project_f32`, its plain
# version) and a float64 product of the same bf16 operands. An element's
# error is |z - z64| over sum_k |t_k p_k| (the scale a dot product's
# rounding grows with); the product's largest may be at most
# PROJECTION_ERR_RATIO times the fp32 form's
PROJECTION_JSON = os.path.join("chiprun_out", "projection.json")
PROJECTION_CASES = (("t1", 24, 1024), ("vg", 40, 1536))
PROJECTION_ROWS, PROJECTION_D_S = 256 * 256, 384
PROJECTION_ERR_RATIO = 2.0
PROJECTION_CHUNK = 1 << 17  # rows of the float64 product at a time
PROJECTION_CELL = "t1_imagenet_train"
PROJECTION_SEED = 3000000029


def projection_case(dev, label: str, layers: int, d_t: int, seed: int) -> dict:
    """The projection of seeded bf16 tokens (layers, PROJECTION_ROWS, d_t)
    by a selector's proj_t: the tensor-core route counted once a call, its
    error and the fp32 form's against the float64 product, its bits with
    `allow_bf16_reduced_precision_reduction` off, the cuBLAS kernels it
    runs, and both timed by device time alone beside the bound (max of
    2 M d_t D_s FLOPs over 989 TFLOP/s and the bf16 tokens' read plus the
    fp32 output's write over 3.35 TB/s)."""
    import torch

    from basd_tpu_torch.losses import init_selector, selector
    from basd_tpu_torch.tools.timing import device_events, device_ms, device_us, kernel_ms

    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.empty((layers, PROJECTION_ROWS, d_t), dtype=torch.bfloat16, device=dev)
    for layer in tokens:
        layer.copy_(torch.randn((PROJECTION_ROWS, d_t), generator=gen, device=dev))
    proj = init_selector(seed, 4, PROJECTION_D_S, d_t, device=dev).proj_t
    count = selector.TENSOR_CORE_PROJECTIONS
    z = selector._project(tokens, proj)
    counted = selector.TENSOR_CORE_PROJECTIONS - count
    z_f32 = selector._project_f32(tokens, proj)
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = not flag
    flag_equal = torch.equal(selector._project(tokens, proj), z)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
    p64 = proj.to(torch.bfloat16).double().T
    err = {"tensor_cores": 0.0, "f32": 0.0}
    abs_err = {"tensor_cores": 0.0, "f32": 0.0}
    ref_max = 0.0
    flat, outs = tokens.reshape(-1, d_t), {"tensor_cores": z.reshape(-1, PROJECTION_D_S),
                                           "f32": z_f32.reshape(-1, PROJECTION_D_S)}
    for i in range(0, flat.shape[0], PROJECTION_CHUNK):
        a = flat[i:i + PROJECTION_CHUNK].double()
        ref, scale = a @ p64, a.abs() @ p64.abs()
        ref_max = max(ref_max, float(ref.abs().max()))
        for name, out in outs.items():
            diff = (out[i:i + PROJECTION_CHUNK].double() - ref).abs()
            err[name] = max(err[name], float((diff / scale).max()))
            abs_err[name] = max(abs_err[name], float(diff.max()))
        del a, ref, scale
    del z_f32, outs
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        selector._project(tokens, proj)
        torch.cuda.synchronize(dev)
    kernels_run = {e.key: device_us(e) / 1e3 for e in device_events(prof)}
    m = layers * PROJECTION_ROWS
    t_ops = 2 * m * d_t * PROJECTION_D_S / 989e12 * 1e3
    t_bytes = (2 * m * d_t + 4 * m * PROJECTION_D_S + 2 * PROJECTION_D_S * d_t) \
        / HBM_BYTES_PER_S * 1e3
    row = dict(
        shape=[layers, PROJECTION_ROWS, d_t, PROJECTION_D_S], counted=counted,
        rel_err=err["tensor_cores"], plain_rel_err=err["f32"],
        max_abs_err=abs_err["tensor_cores"], plain_max_abs_err=abs_err["f32"],
        ref_max=ref_max, reduced_precision_flag=flag, bits_equal_with_flag_flipped=flag_equal,
        cublas_kernels=kernels_run,
        ms=device_ms(lambda: selector._project(tokens, proj), dev, reps=5),
        device_ms=kernel_ms(lambda: selector._project(tokens, proj), dev, reps=10),
        plain_ms=kernel_ms(lambda: selector._project_f32(tokens, proj), dev, reps=5),
        bound_ms=max(t_ops, t_bytes), bound_by="bytes" if t_bytes >= t_ops else "operations")
    row["roofline_pct"] = 100.0 * row["bound_ms"] / row["device_ms"]
    del tokens, z
    torch.cuda.empty_cache()
    if counted != 1 or row["rel_err"] > PROJECTION_ERR_RATIO * row["plain_rel_err"]:
        raise AssertionError(f"projection {label}: {row}")
    return row


def projection_cublas_log(dev) -> dict:
    """One tensor-core projection in a process of its own with cuBLAS's and
    cuBLASLt's API logs on (they are read when the library loads): the
    lines that name the compute type, from whichever library ran it."""
    logs = {"cublas": os.path.join("chiprun_out", "projection_cublas.log"),
            "cublaslt": os.path.join("chiprun_out", "projection_cublaslt.log")}
    os.makedirs("chiprun_out", exist_ok=True)
    for path in logs.values():
        if os.path.exists(path):
            os.remove(path)
    env = {**package_env(), "CUBLAS_LOGINFO_DBG": "1", "CUBLAS_LOGDEST_DBG": logs["cublas"],
           "CUBLASLT_LOG_LEVEL": "5", "CUBLASLT_LOG_FILE": logs["cublaslt"]}
    code = ("import torch; from basd_tpu_torch.losses import selector; "
            f"t = torch.randn((2, 4096, 1024), device='{dev}').bfloat16(); "
            f"p = torch.randn((384, 1024), device='{dev}'); "
            "z = selector._project(t, p); torch.cuda.synchronize(); "
            "print(torch.__version__, torch.version.cuda, "
            "torch.backends.cuda.preferred_blas_library(), z.dtype)")
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"projection cuBLAS log: {proc.stderr[-4000:]}")
    out = {"process": proc.stdout.strip()}
    for name, path in logs.items():
        out[name] = []
        if os.path.exists(path):
            with open(path, errors="replace") as f:
                out[name] = [line[:400] for line in f if "ompute" in line][:12]
    return out


def projection_oracle(dev, label: str, layers: int, d_t: int, seed: int) -> dict:
    """`oracle_check` of one `select_and_mix` call on planted inputs at the
    cell's token shapes (teacher (layers, 256, 256, d_t), student (4, 256,
    196, 384); PLANTED_RANKS repeated over the layers, K = PLANTED_K): MP
    ranks equal to the float64 oracle's, one tensor-core projection."""
    import torch

    from basd_tpu_torch.losses import init_selector, selector

    sel = init_selector(1, len(PLANTED_PAIRS), PROJECTION_D_S, d_t, device=dev)
    ranks = PLANTED_RANKS * (layers // len(PLANTED_RANKS))
    t_tok, s_tok = planted_selector_inputs(sel.proj_s, sel.proj_t, (256, 256, d_t),
                                           (256, 196, PROJECTION_D_S), seed, ranks=ranks)
    imp = torch.full(t_tok.shape[:3], 1.0 / t_tok.shape[2], device=dev)
    count = selector.TENSOR_CORE_PROJECTIONS
    reading = oracle_check(f"{label} shapes {tuple(t_tok.shape)}, planted ranks "
                           f"{PLANTED_RANKS} x {layers // len(PLANTED_RANKS)}", sel,
                           s_tok, t_tok, imp, PLANTED_K, PLANTED_WEIGHTS_ATOL, PLANTED_D2)
    reading["tensor_core_projections"] = selector.TENSOR_CORE_PROJECTIONS - count
    del t_tok, s_tok, imp
    torch.cuda.empty_cache()
    if not reading["ranks_equal"] or reading["tensor_core_projections"] != 1:
        raise AssertionError(f"projection oracle {label}: {reading}")
    return reading


def projection_cell_count(dev, cell: str, seed: int) -> dict:
    """The cell's program (`stage_cell`): the tensor-core projections
    counted in its eager warm-up step, in the step that captures its graph
    (and replays it) and in one more replay (no Python runs there)."""
    import torch

    from basd_tpu_torch.losses import selector

    prog, _, images, labels = stage_cell(dev, cell, seed)
    counts = []
    for _ in range(3):
        selector.TENSOR_CORE_PROJECTIONS = 0
        metrics = prog.step(images, labels)
        counts.append(selector.TENSOR_CORE_PROJECTIONS)
    torch.cuda.synchronize(dev)
    out = dict(route=prog.route[0], counts=counts, loss=float(metrics["loss"]))
    del prog
    torch.cuda.empty_cache()
    if out["route"] != "graph" or counts != [1, 1, 0] or not np.isfinite(out["loss"]):
        raise AssertionError(f"projection {cell}: {out}")
    return out


def projection_check() -> int:
    """Phase 5i alone, a few minutes on one card: the projection's cases,
    its cuBLAS compute type, the oracle at t1's and vg's token shapes and
    the count in a captured t1 step; its readings as JSON into
    PROJECTION_JSON, then the card's name and power limit. Run it as
    `python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.projection_check())"`."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check needs the card", file=sys.stderr)
        return 2
    from basd_tpu_torch.device import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    readings = {"cublas_log": projection_cublas_log(dev), "cases": {}, "oracle": {}}
    print(f"projection cuBLAS log: {readings['cublas_log']}", flush=True)
    for i, (label, layers, d_t) in enumerate(PROJECTION_CASES):
        row = readings["cases"][label] = projection_case(dev, label, layers, d_t,
                                                         PROJECTION_SEED + i)
        print(f"projection {label} {tuple(row['shape'])}: counted {row['counted']}; rel err "
              f"{row['rel_err']:.3g} (fp32 form {row['plain_rel_err']:.3g}, at most "
              f"{PROJECTION_ERR_RATIO}x), max |err| {row['max_abs_err']:.3g} (fp32 form "
              f"{row['plain_max_abs_err']:.3g}) of max |z| {row['ref_max']:.4g}; bits equal with "
              f"allow_bf16_reduced_precision_reduction={not row['reduced_precision_flag']}: "
              f"{row['bits_equal_with_flag_flipped']}; device {row['device_ms']:.4f} ms (event "
              f"loop {row['ms']:.4f}), bound {row['bound_ms']:.4f} ({row['bound_by']}, "
              f"{row['roofline_pct']:.1f}%), fp32 form {row['plain_ms']:.4f}; kernels "
              f"{row['cublas_kernels']}", flush=True)
    for i, (label, layers, d_t) in enumerate(PROJECTION_CASES):
        readings["oracle"][label] = projection_oracle(dev, label, layers, d_t,
                                                      PROJECTION_SEED + 10 + i)
    row = readings["cell"] = projection_cell_count(dev, PROJECTION_CELL, PROJECTION_SEED)
    print(f"{PROJECTION_CELL}: route {row['route']}; tensor-core projections in the warm-up, "
          f"the capture and a replay {row['counts']}", flush=True)
    readings["card"] = card_line(dev)
    os.makedirs(os.path.dirname(PROJECTION_JSON), exist_ok=True)
    with open(PROJECTION_JSON, "w") as f:
        json.dump(readings, f)
    print(readings["card"])
    return 0


# phase 5j: the RoPE rotation (`csrc/rope.cu`) and K1 at head_dim 128, at
# DINOv3 ViT-7B's teacher shape (256 images, 201 rows: 196 patches, CLS
# and 4 registers, D 4096, 32 heads of 128); each RoPE case (label, batch,
# rows, heads, head_dim, dtype, offset): `offset` elements into its buffer
# (1: an unaligned qkv, the scalar route)
ROPE_JSON = os.path.join("chiprun_out", "rope.json")
ROPE_PREFIX = 5
ROPE_CASES = (("ViT-7B teacher", 256, 201, 32, 128, "bfloat16", 0),
              ("ViT-7B teacher fp32", 64, 201, 32, 128, "float32", 0),
              ("micro teacher", 256, 21, 2, 32, "bfloat16", 0),
              ("unaligned", 64, 201, 32, 128, "bfloat16", 1),
              ("head_dim 12 fp32", 64, 21, 4, 12, "float32", 0))
ROPE_SEED = 3000000047
ROPE_FORWARD_REPS = 3


def rope_case(dev, label, b, n, heads, hd, dtype_name, offset, seed) -> dict:
    """The kernel on a seeded packed qkv against its plain version (bit for
    bit: every op rounds as the plain version's), timed by an event loop and
    by device time alone beside the plain version and torch's own bf16 ops
    on the published formula, with its bound (q and k read and written, 4
    B N D elements, over the memory bandwidth)."""
    import torch

    from basd_tpu_torch.ops.rope import rope_qk, rope_qk_plain, rope_route, rope_table
    from basd_tpu_torch.tools.timing import device_ms, kernel_ms

    dtype = getattr(torch, dtype_name)
    d = heads * hd
    gen = torch.Generator(device=dev).manual_seed(seed)
    numel = b * n * 3 * d
    buf = (2.0 * torch.randn(numel + offset, generator=gen, device=dev)).to(dtype)
    qkv = buf[offset:].view(b, n, 3 * d)
    grid = int(round((n - ROPE_PREFIX) ** 0.5))
    table = rope_table(grid, grid, hd).to(dev)
    scale = hd ** -0.5
    got = rope_qk(qkv, table, heads, ROPE_PREFIX, scale)
    want = rope_qk_plain(qkv, table, heads, ROPE_PREFIX, scale)
    differing = sum(int((g != w).sum()) for g, w in zip(got, want))
    if differing:
        raise AssertionError(f"rope_qk {label}: {differing} values differ from the plain "
                             f"version (bit for bit required)")
    cos, sin = table.tile(1, 1, 2).to(dtype)

    def published():  # q cos + rotate_half(q) sin in the tensor's dtype, per head
        out = []
        for t in (qkv[..., :d], qkv[..., d:2 * d]):
            p = t[:, ROPE_PREFIX:].reshape(b, n - ROPE_PREFIX, heads, hd)
            half = torch.cat([-p[..., hd // 2:], p[..., :hd // 2]], dim=-1)
            out.append(p * cos[:, None] + half * sin[:, None])
        return out

    bound_ms = 4 * b * n * d * qkv.element_size() / HBM_BYTES_PER_S * 1e3
    row = dict(route=rope_route(qkv, heads, *got), differing=differing, max_abs_err=0.0,
               ms=device_ms(lambda: rope_qk(qkv, table, heads, ROPE_PREFIX, scale), dev),
               device_ms=kernel_ms(lambda: rope_qk(qkv, table, heads, ROPE_PREFIX, scale), dev),
               plain_ms=device_ms(lambda: rope_qk_plain(qkv, table, heads, ROPE_PREFIX, scale),
                                  dev),
               library_ms=device_ms(published, dev), library_device_ms=kernel_ms(published, dev),
               bound_ms=bound_ms, bound_by="bytes")
    row["roofline_pct"] = 100.0 * bound_ms / row["device_ms"]
    return row


def k1_hd128_case(dev, seed) -> dict:
    """K1 at the ViT-7B teacher's (256, 201, 4096), 32 heads of 128, bf16, on
    the RoPE kernel's q and k and a view of the packed qkv as v (the model's
    operands): against its plain version (bf16 attention tolerance) and
    against SDPA, timed beside both, with its bound (q, k, v read, o
    written, or 4 B H N^2 hd FLOPs at the bf16 peak)."""
    import torch
    import torch.nn.functional as F

    from basd_tpu_torch.ops.attention import attention_forward_plain, fused_attention
    from basd_tpu_torch.ops.rope import rope_qk, rope_table
    from basd_tpu_torch.tools.timing import device_ms, kernel_ms
    from basd_tpu_torch.utils.kernel_smoke import BF16_ATTENTION_TOL

    b, n, heads, hd = 256, 201, 32, 128
    d = heads * hd
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((b, n, 3 * d), generator=gen, device=dev).to(torch.bfloat16)
    q, k = rope_qk(qkv, rope_table(14, 14, hd).to(dev), heads, ROPE_PREFIX, hd ** -0.5)
    v = qkv[..., 2 * d:]
    o = fused_attention(q, k, v, hd)
    want = attention_forward_plain(q, k, v, hd)[0]
    split = lambda x: x.reshape(b, n, heads, hd).transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(split(q), split(k), split(v), scale=1.0)
    ref = sdpa().transpose(1, 2).reshape(b, n, d)
    rel = lambda got, w: float((got.float() - w.float()).abs().max() / w.float().abs().max())
    row = dict(rel_err=rel(o, want), sdpa_rel_err=rel(o, ref), tol=BF16_ATTENTION_TOL,
               max_abs_err=float((o.float() - want.float()).abs().max()))
    if not row["rel_err"] <= BF16_ATTENTION_TOL:
        raise AssertionError(f"K1 at head_dim 128: {row}")
    flops = 4 * b * heads * n * n * hd
    nbytes = 4 * b * n * d * 2
    bound_ms = max(flops / 989e12, nbytes / HBM_BYTES_PER_S) * 1e3
    row.update(ms=device_ms(lambda: fused_attention(q, k, v, hd), dev),
               device_ms=kernel_ms(lambda: fused_attention(q, k, v, hd), dev),
               plain_ms=device_ms(lambda: attention_forward_plain(q, k, v, hd), dev, reps=3),
               library_ms=device_ms(sdpa, dev), library_device_ms=kernel_ms(sdpa, dev),
               bound_ms=bound_ms,
               bound_by="FLOPs" if flops / 989e12 > nbytes / HBM_BYTES_PER_S else "bytes")
    row["roofline_pct"] = 100.0 * bound_ms / row["device_ms"]
    return row


def dinov3_forward_case(dev):
    """The `dinov3_vit7b16` teacher at batch 256 on seeded random weights
    (made on the card; LayerScale 1): its forward's wall ms (median of
    ROPE_FORWARD_REPS after a warm-up), the launches of one forward (40
    rotations, 40 K1 at head_dim 128, 40 gates) and the peak memory of the
    weights and one forward. Returns the readings and the teacher."""
    import torch

    from basd_tpu_torch import kernels
    from basd_tpu_torch.models.specs import resolve_preset
    from basd_tpu_torch.models.teacher import Teacher, build_teacher_module, extract_intermediates

    spec = resolve_preset("dinov3_vit7b16")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.device("meta"):
        module = build_teacher_module(spec, 224)
    module = module.to_empty(device=dev).eval().requires_grad_(False)
    gen = torch.Generator(device=dev).manual_seed(5)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim >= 2:
                p.normal_(0.0, (2.0 / p[0].numel()) ** 0.5, generator=gen)
            elif name.endswith(("norm1.weight", "norm2.weight", "norm.weight", "gamma")):
                p.fill_(1.0)
            else:
                p.zero_()
    tch = Teacher(spec=spec, module=module, img_size=224, num_tokens=196,
                  mean=spec.norm_mean, std=spec.norm_std)
    x = torch.randn((256, 224, 224, 3), generator=gen, device=dev)
    extract_intermediates(tch, x)  # warm-up
    wall, launches = [], None
    for _ in range(ROPE_FORWARD_REPS):
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        tokens, importance = extract_intermediates(tch, x)
        torch.cuda.synchronize(dev)
        wall.append((time.perf_counter() - t0) * 1e3)
        launches = {k: kernels.LAUNCHES[k] - before[k] for k in before
                    if kernels.LAUNCHES[k] > before[k]}
        del tokens, importance
    out = dict(wall_ms=wall, forward_ms=float(np.median(wall)), launches=launches,
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
               weights_gib=sum(p.numel() * 4 for p in module.parameters()) / 2**30)
    want = {"rope_qk": 40, "attention_fwd": 40, "swiglu_gate": 40, "layernorm": 81}
    if {k: launches.get(k, 0) for k in want} != want:
        raise AssertionError(f"ViT-7B forward launches {launches}, want {want}")
    torch.cuda.empty_cache()
    return out, tch


def rope_check() -> int:
    """Phase 5j alone, a few minutes on one card: the kernels built, the
    RoPE cases, K1 at head_dim 128 at the ViT-7B teacher's shape, one
    `dinov3_vit7b16` forward at batch 256 and the Table-1 step with that
    teacher (`teacher_step_check`); its readings as JSON into
    ROPE_JSON, then the card's name and power limit. Run it as
    `python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.rope_check())"`."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check needs the card", file=sys.stderr)
        return 2
    from basd_tpu_torch import kernels
    from basd_tpu_torch.device import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(kernels.build_all().get("rope", ""), flush=True)  # registers, spills
    dev = torch.device("cuda", 0)
    before = dict(kernels.LAUNCHES)
    readings = {"rope": {}}
    for i, (label, b, n, heads, hd, dtype_name, offset) in enumerate(ROPE_CASES):
        case = f"{label} ({b}, {n}, {3 * heads * hd}) {dtype_name}"
        row = rope_case(dev, label, b, n, heads, hd, dtype_name, offset, ROPE_SEED + i)
        readings["rope"][case] = row
        print(f"kernel rope_qk {case}: route {row['route']}, bit for bit the plain version; "
              f"ms {row['ms']:.4f} (device {row['device_ms']:.4f}), bound {row['bound_ms']:.4f} "
              f"({row['roofline_pct']:.1f}%), plain {row['plain_ms']:.4f}, torch's ops "
              f"{row['library_ms']:.4f} (device {row['library_device_ms']:.4f})", flush=True)
        torch.cuda.empty_cache()
    row = readings["k1_hd128"] = k1_hd128_case(dev, ROPE_SEED)
    print(f"kernel attention_fwd ViT-7B teacher B=256 N=201 D=4096 H=32 bfloat16: rel err "
          f"{row['rel_err']:.3g} (tol {row['tol']}), against SDPA {row['sdpa_rel_err']:.3g}; ms "
          f"{row['ms']:.4f} (device {row['device_ms']:.4f}), bound {row['bound_ms']:.4f} "
          f"({row['bound_by']}, {row['roofline_pct']:.1f}%), plain {row['plain_ms']:.4f}, sdpa "
          f"{row['library_ms']:.4f} (device {row['library_device_ms']:.4f})", flush=True)
    torch.cuda.empty_cache()
    readings["launches"] = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    fwd, tch = dinov3_forward_case(dev)
    readings["forward"] = fwd
    print(f"dinov3_vit7b16 forward at batch 256: {fwd['forward_ms']:.1f} ms (wall, median of "
          f"{ROPE_FORWARD_REPS}); launches {fwd['launches']}; peak {fwd['peak_gib']:.2f} GiB "
          f"(weights {fwd['weights_gib']:.2f})", flush=True)
    step = readings["step"] = teacher_step_check(dev, tch)
    print(f"DINOv3 ViT-7B Table-1 step: route {step['route']} ({step['reason']}); launches a "
          f"replay {step['replay_launches']}; replays {step['replay_ms']:.1f} ms (wall, median); "
          f"peak {step['peak_gib']:.2f} GiB; loss {step['loss']:.5f}; stage spans (median ms "
          f"of {VITG_SPAN_STEPS} replays) {step['span_ms']}", flush=True)
    del tch
    torch.cuda.empty_cache()
    readings["card"] = card_line(dev)
    os.makedirs(os.path.dirname(ROPE_JSON), exist_ok=True)
    with open(ROPE_JSON, "w") as f:
        json.dump(readings, f)
    print(readings["card"])
    return 0


M7_OUT = "chiprun_out/m7"
MP_RANK_JSON = os.path.join(os.path.dirname(M7_OUT), "mp_rank.json")  # phase 5f's readings
# phase 5k: the LayerNorm kernel (`csrc/layernorm.cu`) at the four benchmark
# teachers' shapes (t3, t1, vg, dv: batch x (patches + CLS + registers)
# rows of the teacher's width), each case (label, rows, width, dtype,
# offset): t1's in fp32, an odd width and a view one element into its
# buffer (both the scalar route)
LAYERNORM_JSON = os.path.join("chiprun_out", "layernorm.json")
LAYERNORM_CASES = (("t3 teacher", 640, 768, "bfloat16", 0),
                   ("t1 teacher", 65792, 1024, "bfloat16", 0),
                   ("vg teacher", 65792, 1536, "bfloat16", 0),
                   ("dv teacher", 51456, 4096, "bfloat16", 0),
                   ("t1 teacher fp32", 65792, 1024, "float32", 0),
                   ("odd width", 4099, 13, "bfloat16", 0),
                   ("unaligned", 4096, 1024, "bfloat16", 1))
LAYERNORM_SEED = 3000000061
# the per-value allowance cannot see an error smaller than one ulp made
# systematically, so two readings over each case's values bound it: the
# share of bf16 values that differ from the composite (an H100 at 700 W
# read 1.1e-5 to 2.6e-5 on every bf16 case), and the drift, the sum of the
# differences signed by the composite's values over the sum of their
# magnitudes. Emulated in torch on these cases' rows, a correct two-pass
# LayerNorm reads a share of 3.1e-5 to 3.8e-5 and a drift within 3e-8; one
# that truncates in place of rounding 0.5 and -2.8e-3; one that divides the
# variance by D - 1 2.8% and -1.2e-4 at D 4,096 (13.5% and -6.4e-4 at 768)
LAYERNORM_BF16_SHARE_LIMIT = 5e-4
LAYERNORM_DRIFT_LIMIT = 1e-5


def layernorm_case(dev, label, rows, d, dtype_name, offset, seed) -> dict:
    """The kernel on seeded rows (mean 0.5, scale 2; weight near 1, a small
    bias) against the plain composite on the card: every value within the
    start-up check's allowance (`kernel_smoke.layernorm_excess`: one ulp of
    the dtype, or a few fp32 ulps of the row's scale near zero), the share
    that differs (bf16) and the drift within their limits; timed by device
    time alone beside the composite, F.layer_norm in the rows' dtype and
    the bound (x read and y written once over the memory bandwidth)."""
    import torch
    import torch.nn.functional as F

    from basd_tpu_torch.ops.layernorm import layer_norm_cuda, layer_norm_plain, layernorm_route
    from basd_tpu_torch.tools.timing import device_ms, kernel_ms
    from basd_tpu_torch.utils.kernel_smoke import layernorm_excess

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device=dev).manual_seed(seed)
    buf = (2.0 * torch.randn(rows * d + offset, generator=gen, device=dev) + 0.5).to(dtype)
    x = buf[offset:].view(rows, d)
    w = 1.0 + 0.2 * torch.randn(d, generator=gen, device=dev)
    b = 0.1 * torch.randn(d, generator=gen, device=dev)
    y = layer_norm_cuda(x, w, b, 1e-6)
    want = layer_norm_plain(x, w, b, 1e-6)
    excess = float(layernorm_excess(y, want).max())
    differing = int((y != want).sum())
    share = differing / y.numel()
    drift = float(torch.sum((y.float() - want.float()) * want.float().sign(),
                            dtype=torch.float64)
                  / torch.sum(want.float().abs(), dtype=torch.float64))
    if not (excess <= 1.0 and abs(drift) <= LAYERNORM_DRIFT_LIMIT
            and (dtype != torch.bfloat16 or share <= LAYERNORM_BF16_SHARE_LIMIT)):
        raise AssertionError(
            f"layernorm {label} ({rows}, {d}) {dtype_name}: {excess:.3g} times the allowance "
            f"against the plain version; {share:.3g} of values differ (bf16 limit "
            f"{LAYERNORM_BF16_SHARE_LIMIT}); drift {drift:.3g} (limit {LAYERNORM_DRIFT_LIMIT})")
    wl, bl = w.to(dtype), b.to(dtype)
    row = dict(route=layernorm_route(x, y, w, b), differing=differing,
               differing_share=share, drift=drift, max_excess=excess,
               max_abs_err=float((y.float() - want.float()).abs().max()),
               ms=device_ms(lambda: layer_norm_cuda(x, w, b, 1e-6), dev),
               device_ms=kernel_ms(lambda: layer_norm_cuda(x, w, b, 1e-6), dev),
               plain_ms=kernel_ms(lambda: layer_norm_plain(x, w, b, 1e-6), dev),
               library_ms=kernel_ms(lambda: F.layer_norm(x, (d,), wl, bl, 1e-6), dev),
               bound_ms=2 * rows * d * x.element_size() / HBM_BYTES_PER_S * 1e3,
               bound_by="bytes")
    row["roofline_pct"] = 100.0 * row["bound_ms"] / row["device_ms"]
    return row


def layernorm_check() -> int:
    """Phase 5k alone, about a minute on one card: the kernels built, the
    LayerNorm cases; its readings as JSON into LAYERNORM_JSON, then the
    card's name and power limit. Run it as
    `python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.layernorm_check())"`."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check needs the card", file=sys.stderr)
        return 2
    from basd_tpu_torch import kernels
    from basd_tpu_torch.device import card_line

    print(kernels.build_all().get("layernorm", ""), flush=True)  # registers, spills
    dev = torch.device("cuda", 0)
    readings = {"cases": {}}
    for i, (label, rows, d, dtype_name, offset) in enumerate(LAYERNORM_CASES):
        case = f"{label} ({rows}, {d}) {dtype_name}"
        row = layernorm_case(dev, label, rows, d, dtype_name, offset, LAYERNORM_SEED + i)
        readings["cases"][case] = row
        print(f"kernel layernorm {case}: route {row['route']}; {row['differing_share']:.3%} "
              f"of values differ from the composite (at most {row['max_excess']:.3g} of the "
              f"allowance, drift {row['drift']:.3g}); device {row['device_ms']:.4f} ms (event loop {row['ms']:.4f}), "
              f"bound {row['bound_ms']:.4f} ({row['roofline_pct']:.1f}%), composite "
              f"{row['plain_ms']:.4f}, F.layer_norm {row['library_ms']:.4f}", flush=True)
        torch.cuda.empty_cache()
    readings["card"] = card_line(dev)
    os.makedirs(os.path.dirname(LAYERNORM_JSON), exist_ok=True)
    with open(LAYERNORM_JSON, "w") as f:
        json.dump(readings, f)
    print(readings["card"])
    return 0


# phase 8's run: `python -m basd_tpu_torch.train` as a user runs it, at
# Table-3 width on 1,024 synthetic images, one epoch of 8 steps, `latest`
# every 4; the arch_overrides keep the student at DeiT-Tiny width (a random
# teacher's intrinsic dimension would shrink it)
M7_ARGV = [
    "experiment=basd_cifar100", "data.dataset=synthetic/cifar100-like-1024n",
    "training.num_epochs=1",
    "model.arch_overrides={embed_dim: 192, depth: 12, num_heads: 3, mlp_ratio: 4.0}",
    "checkpoint.save_every_steps=4", "evaluation.efficiency_warmup=5",
    "evaluation.efficiency_batches=20", f"run.output_dir={M7_OUT}",
]
# phase 8's replays timed alone after the run, and its eval comparison's
# images (the first 1,000 of the 1,024: 7 full batches and a tail of 104)
M7_TIMED_REPLAYS = 5
M7_EVAL_IMAGES = 1000


def trainer_phase(dev, env, bare_step_median_ms: float | None) -> dict:
    """Phase 8: the trainer and evaluation entry points at Table-3 width.
    `train.main(M7_ARGV)` (basd_cifar100: DeiT-Tiny/4 at 32 px with the
    DINOv2 ViT-B/14 teacher, random weights from the seed, batch 128, 100
    classes, bf16, remat, K auto) on the graph route: its exact launches,
    one replay's K1 36, K2 12, K3 3, K4 1; (a) a twin Trainer from the same
    seed and config driven through `TrainStep.eager` on the same 8 batches
    (its second step under `torch.cuda.set_sync_debug_mode("error")`), bit
    for bit in every metric of every step, every parameter, z, v, the
    log-temperatures, the generator and the step; `latest` restored into a
    fresh Trainer equals the live state bit for bit; (d) the graph
    evaluation against the eager one on the same params (sums bit for bit;
    eval and efficiency img/s both ways); (b) `latest` restored into the
    live Trainer after its capture, then 2 steps, against the fresh Trainer
    after the same 2 steps, bit for bit; (c) `M7_TIMED_REPLAYS` timed
    replays and one profiled replay (busy ms and share, kernels by name),
    and a save right after one more replay holding that replay's state; then `python -m basd_tpu_torch.evaluate` from the run's snapshot in a
    subprocess and in this process, reproducing the run's final eval.
    Returns the readings, the config, the trainer and the launches by path
    (`train_entry`, `evaluate`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from basd_tpu_torch import evaluate as evaluate_entry
    from basd_tpu_torch import kernels
    from basd_tpu_torch import train as train_entry
    from basd_tpu_torch.data import load_split_arrays
    from basd_tpu_torch.data.datasets import dataset_info
    from basd_tpu_torch.evaluation import metrics
    from basd_tpu_torch.models import create_student
    from basd_tpu_torch.spectral.ops import use_jacobi
    from basd_tpu_torch.tools.timing import device_events, device_us
    from basd_tpu_torch.training import train_step
    from basd_tpu_torch.training.trainer import Trainer

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    shutil.rmtree(M7_OUT, ignore_errors=True)
    # every call of the trainer's step: its batch and metrics (references
    # only: the step returns fresh tensors, so recording adds no device work)
    recorded = []
    real_call = train_step.TrainStep.__call__

    def recording_call(self, state, images_u8, labels):
        state, met = real_call(self, state, images_u8, labels)
        recorded.append((images_u8, labels, met))
        return state, met

    kernels.reset_launches()
    train_step.TrainStep.__call__ = recording_call
    try:
        t0 = time.perf_counter()
        m7_results, trainer = train_entry.main(M7_ARGV, device=dev)
        torch.cuda.synchronize()
        m7_wall_s = time.perf_counter() - t0
    finally:
        train_step.TrainStep.__call__ = real_call
    m7_launches = dict(kernels.LAUNCHES)
    m7_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    cfg = trainer.config
    k = cfg.basd.subspace_k
    scfg = trainer.state.student.config
    steps = trainer.state.step
    step = trainer._step
    eval_cfg = cfg.evaluation
    img, patch = cfg.model.vit.img_size, cfg.model.vit.patch_size
    eval_batches = -(-128 // cfg.data.batch_size)  # the 128-image test split
    # K1 in every student block of each forward outside the train steps: the
    # per-epoch and the final evaluation, the efficiency loop; 12 in the
    # teacher's forward of the K calibration and one MP-rank launch in its
    # ranks; none for the FLOP count (a CPU copy of the model)
    eval_forwards = 2 * eval_batches + eval_cfg.efficiency_warmup + eval_cfg.efficiency_batches
    per_step = per_step_launches(scfg, trainer.teacher, trainer.extraction_points, k, True)
    want = {name: per_step[name] * steps for name in per_step}
    want["attention_fwd"] += scfg.depth * eval_forwards + teacher_layers(trainer.teacher)
    want["gelu_fwd"] += scfg.depth * eval_forwards + gelu_mlps(trainer.teacher.module)
    want["layernorm"] += (2 * scfg.depth + 1) * eval_forwards + layer_norms(
        trainer.teacher.module)
    want["mp_rank"] += 1
    # the trainer's kernel start-up check: this process's first Trainer
    check_launches = trainer.kernel_check_launches
    want = {name: n + check_launches[name] for name, n in want.items()}
    if (steps != 8 or not scfg.remat or scfg.embed_dim != 192
            or per_step["attention_fwd"] != 36 or m7_launches != want
            or check_launches != KERNEL_CHECK_LAUNCHES):
        raise AssertionError(f"train entry: {steps} steps, remat {scfg.remat}, "
                             f"launches {m7_launches}, expected {want} (per step "
                             f"{per_step}, K={k}; the start-up check's "
                             f"{check_launches}, expected {KERNEL_CHECK_LAUNCHES})")
    if step.route != "graph" or step.launches != per_step or len(recorded) != steps:
        raise AssertionError(f"train entry: route {step.route} ({step.reason}), "
                             f"launches per replay {step.launches}, expected {per_step}; "
                             f"{len(recorded)} recorded steps")
    primary = m7_results["primary"]
    if not all(np.isfinite(primary[key]) for key in ("val_acc", "val_acc_top5", "loss")):
        raise AssertionError(f"train entry: primary {primary}")
    capture_s, pool_bytes = step.capture_s, step.pool_bytes  # the run's own capture
    print(f"train entry: route {step.route} ({step.reason}); K={k} (Jacobi kernel gate "
          f"16 <= K <= 96: {use_jacobi((len(trainer.extraction_points), k, k))}); "
          f"{steps} steps of batch {cfg.data.batch_size}, remat {scfg.remat}; launches "
          f"{m7_launches} (per step {per_step}, one replay's by the counters "
          f"{step.launches}; plus K1 x {scfg.depth} in {eval_forwards} eval and "
          f"efficiency forwards, the calibration's 12 and the kernel start-up check's "
          f"{check_launches} in {trainer.kernel_check_s:.2f} s); capture "
          f"{capture_s:.3f} s, graph pool {pool_bytes} bytes; {m7_wall_s:.1f} s",
          flush=True)
    trainer_ms = trainer.step_ms
    bare = "not run" if bare_step_median_ms is None else f"{bare_step_median_ms:.2f}"
    print(f"train entry: trainer step ms {[round(t, 2) for t in trainer_ms]} (CUDA events "
          f"between step ends; 1 the eager warm-up, 2 the capture and its replay): "
          f"replay median (steps 3..{steps}) {np.median(trainer_ms[2:]):.2f}; the bare "
          f"augmented step (phase 5, remat off, graph) median {bare}; the epoch loop "
          f"blocked on each save {[round(t, 2) for t in trainer.checkpoints.blocked_ms]} "
          f"ms; efficiency throughput (replays) "
          f"{m7_results['efficiency']['throughput_img_per_sec']:.1f} img/s at batch "
          f"{eval_cfg.get('efficiency_batch_size', 64)}, gflops "
          f"{m7_results['efficiency']['gflops']:.4f}; peak memory {m7_peak_gib:.2f} GiB "
          f"({held_gib:.2f} held by earlier phases)", flush=True)

    def state_tensors(tr):
        st = tr.state
        out = {f"param {n}": v for n, v in st.student.state_dict().items()}
        for i, p in enumerate(st.optimizer.param_groups[0]["params"]):
            out[f"z {i}"] = st.optimizer.state[p]["z"]
            out[f"v {i}"] = st.optimizer.state[p]["exp_avg_sq"]
        out["log_temperatures"] = st.selector.log_temperatures
        out["generator"] = st.generator.get_state()
        return {n: v.detach().clone() for n, v in out.items()}

    def unequal(a, b) -> list:
        return [n for n in a if not torch.equal(a[n], b[n])]

    def trainer_of(seed):
        stu, stu_cfg = create_student(
            cfg.model.student_preset, num_classes=cfg.model.num_classes,
            drop_path_rate=cfg.model.drop_path_rate, img_size=img,
            arch_overrides={**cfg.model.arch_overrides, "patch_size": patch},
            capture_layers=trainer.extraction_points, dtype=torch.bfloat16,
            remat=cfg.hardware.remat, device=dev, seed=seed)
        return Trainer(cfg, student=stu, student_cfg=stu_cfg, teacher=trainer.teacher,
                       teacher_stats=(trainer.teacher.mean, trainer.teacher.std),
                       dataset_stats=trainer._eval_stats)

    # (a) the twin: the same seeds (train.run draws the student from
    # run.seed) and config, op by op on the same 8 batches
    twin = trainer_of(cfg.run.seed)
    twin_metrics = []
    for i, (imgs, labs, _) in enumerate(recorded):
        if i == 1:  # after the first step built the constants
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            twin.state, met = twin._step.eager(twin.state, imgs, labs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        twin_metrics.append(met)
    differ = [(i, n) for i, ((_, _, gm), em) in enumerate(zip(recorded, twin_metrics))
              for n in em if not torch.equal(em[n], gm[n])]
    live_tensors = state_tensors(trainer)
    differ_state = unequal(live_tensors, state_tensors(twin))
    if differ or differ_state or twin.state.step != steps:
        raise AssertionError(f"train entry: the graph route differs from the twin's eager "
                             f"steps: metrics {differ[:8]}, state {differ_state[:8]}, "
                             f"steps {twin.state.step}")
    print(f"train entry: {steps} graph-route steps bit for bit equal to a twin Trainer's "
          f"{steps} TrainStep.eager steps on the same batches (losses "
          f"{[float(m['loss']) for _, _, m in recorded]}; every metric of every step, "
          f"{len(live_tensors) - 1} parameter, z, v and temperature tensors, the "
          f"generator's state, the step); twin step 2 ran under "
          f"set_sync_debug_mode('error'): no host round-trip", flush=True)
    del twin, twin_metrics

    # the restored `latest` equals the live state bit for bit; the fresh
    # trainer's student is drawn from another seed, so the restore must
    # overwrite it
    fresh = trainer_of(cfg.run.seed + 7)
    differs_before = len(unequal(live_tensors, state_tensors(fresh)))
    fresh.load_checkpoint("latest")
    bad = unequal(live_tensors, state_tensors(fresh))
    if bad or fresh.state.step != trainer.state.step or not differs_before:
        raise AssertionError(f"restore latest: {len(bad)} tensors differ {bad[:5]}, step "
                             f"{fresh.state.step} vs {trainer.state.step}")
    print(f"train entry: restore_state('latest') into a fresh Trainer equals the live "
          f"state bit for bit ({len(live_tensors)} tensors: parameters, z, v, "
          f"log-temperatures, the CUDA generator's state; {differs_before} differed "
          f"before), step {fresh.state.step}", flush=True)

    # (d) the evaluation: graph against eager on the same params (the
    # run's final x-point), the eager and replayed img/s side by side
    split = dataset_info(cfg.data.dataset)
    images, labels = load_split_arrays(cfg.data.dataset, split["train_split"], img)
    images, labels = images[:M7_EVAL_IMAGES], labels[:M7_EVAL_IMAGES]
    params = trainer.eval_model_params()
    eval_kw = dict(img_size=img, crop_ratio=cfg.data.eval_crop_ratio,
                   mean=trainer._eval_stats[0], std=trainer._eval_stats[1],
                   batch_size=cfg.data.batch_size)
    student = trainer.state.student
    sums, eval_s = {}, {}
    for route in ("eager", "graph", "graph", "eager"):
        fn = metrics.eager_eval_sums if route == "eager" else metrics.graph_eval_sums
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(student, params, images, labels, **eval_kw).cpu()
        eval_s.setdefault(route, []).append(time.perf_counter() - t0)
        if route in sums and not torch.equal(sums[route], got):
            raise AssertionError(f"evaluation: {route} gave {sums[route]}, then {got}")
        sums[route] = got
    val_images, val_labels = load_split_arrays(cfg.data.dataset, split["eval_split"], img)
    val_eager = metrics.eager_eval_sums(student, params, val_images, val_labels,
                                        **eval_kw).cpu()
    n_val = len(val_labels)
    if not torch.equal(sums["eager"], sums["graph"]) or {
            "val_acc": 100.0 * float(val_eager[1]) / n_val,
            "val_acc_top5": 100.0 * float(val_eager[2]) / n_val,
            "loss": float(val_eager[0]) / n_val} != {
                key: primary[key] for key in ("val_acc", "val_acc_top5", "loss")}:
        raise AssertionError(f"evaluation: graph sums {sums['graph']} vs eager "
                             f"{sums['eager']}; the run's final eval {primary} vs eager "
                             f"sums {val_eager}")
    forward_kw = dict(image_size=img, batch_size=eval_cfg.get("efficiency_batch_size", 64),
                      num_warmup=eval_cfg.efficiency_warmup,
                      num_batches=eval_cfg.efficiency_batches)
    replayed = metrics.measure_efficiency(student, params, **forward_kw)
    x = torch.zeros((forward_kw["batch_size"], img, img, 3), device=dev)
    with torch.no_grad():
        for _ in range(forward_kw["num_warmup"]):
            metrics._forward(student, params, x)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(forward_kw["num_batches"]):
            metrics._forward(student, params, x)
        end.record()
        end.synchronize()
    eager_fwd = forward_kw["batch_size"] * forward_kw["num_batches"] / (
        start.elapsed_time(end) / 1e3)
    m7_eval = {
        "sums": sums["graph"].tolist(), "images": len(labels),
        "eager_img_per_s": [len(labels) / t for t in eval_s["eager"]],
        "graph_img_per_s": [len(labels) / t for t in eval_s["graph"]],
        "efficiency_eager_img_per_s": eager_fwd,
        "efficiency_replay_img_per_s": replayed["throughput_img_per_sec"],
        "efficiency_run_img_per_s": m7_results["efficiency"]["throughput_img_per_sec"],
    }
    print(f"evaluation: graph route (a replay per full batch of "
          f"{cfg.data.batch_size}, the tail of {len(labels) % cfg.data.batch_size} eager) "
          f"equals the eager route on {len(labels)} images at the run's x-point: sums "
          f"(loss, top1, top5) {m7_eval['sums']} bit for bit; the run's final eval equals "
          f"the eager route's on the test split; eval img/s eager "
          f"{[round(v, 1) for v in m7_eval['eager_img_per_s']]}, graph "
          f"{[round(v, 1) for v in m7_eval['graph_img_per_s']]} (host clock, to the sums "
          f"on the host); efficiency forward img/s (CUDA events, batch "
          f"{forward_kw['batch_size']}) eager {eager_fwd:.1f}, replayed "
          f"{replayed['throughput_img_per_sec']:.1f} (the run's "
          f"{m7_eval['efficiency_run_img_per_s']:.1f})", flush=True)

    # (b) restore after the capture: the live trainer steps away from
    # `latest`, restores it and takes 2 steps; the fresh one (restored
    # above) takes the same 2 steps
    def two_steps(tr) -> list:
        out = []
        for imgs, labs, _ in recorded[:2]:
            tr.state, met = tr._step(tr.state, imgs, labs)
            out.append({n: v.cpu() for n, v in met.items()})
        return out

    kernels.reset_launches()
    away = two_steps(trainer)
    trainer.load_checkpoint("latest")
    if step.graph is not None or step.route is not None:
        raise AssertionError("restore: the step kept its capture")
    after = two_steps(trainer)
    again = two_steps(fresh)
    restore_launches = dict(kernels.LAUNCHES)
    bad = [(i, n) for i, (a, b, c) in enumerate(zip(away, after, again)) for n in a
           if not (torch.equal(a[n], b[n]) and torch.equal(b[n], c[n]))]
    bad_state = unequal(state_tensors(trainer), state_tensors(fresh))
    if (bad or bad_state or trainer.state.step != steps + 2
            or fresh.state.step != steps + 2 or step.route != "graph"
            or step.graph is None):
        raise AssertionError(f"restore after capture: metrics {bad[:8]}, state "
                             f"{bad_state[:8]}, steps {trainer.state.step} / "
                             f"{fresh.state.step}, route {step.route}")
    print(f"train entry: `latest` restored into the live Trainer after its capture (2 "
          f"replays away from it first) and 2 steps (warm-up, capture and replay) equal "
          f"the fresh Trainer's 2 steps from the same checkpoint and the 2 steps before "
          f"the restore, bit for bit (every metric, the state, step "
          f"{trainer.state.step}); recapture {step.capture_s:.3f} s; launches "
          f"{restore_launches}", flush=True)
    del fresh

    # (c) the remat graph's replays alone, then one of them profiled
    imgs, labs, _ = recorded[0]
    replay_ms = []
    for _ in range(M7_TIMED_REPLAYS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.state, _ = step(trainer.state, imgs, labs)
        torch.cuda.synchronize()
        replay_ms.append((time.perf_counter() - t0) * 1e3)
    replay_median = float(np.median(replay_ms))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.state, _ = step(trainer.state, imgs, labs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    busy_ms = sum(device_us(e) for e in events) / 1e3
    by_name = {n: sum(e.count for e in events if re.match(pat, e.key))
               for n, pat in KERNEL_NAMES.items()}
    if by_name != {n: per_step[n] for n in KERNEL_NAMES}:
        raise AssertionError(f"train entry: kernels by name in a profiled replay "
                             f"{by_name}, expected {per_step}")
    # a save right after a replay, as `save_every_steps` makes one: its host
    # copy reads the state that replay wrote (both on the current stream)
    trainer.state, _ = step(trainer.state, imgs, labs)
    saved_dir = trainer.checkpoints.save_state(
        "after_replay", trainer.state, epoch=0, best_val_acc=0.0, metrics_history={},
        block=True)
    saved = torch.load(saved_dir / "state.pt", map_location="cpu", weights_only=True)
    live = {n: v.cpu() for n, v in trainer.state.student.state_dict().items()}
    if (unequal(live, saved["student"]) or saved["step"] != trainer.state.step
            or not torch.equal(saved["generator"], trainer.state.generator.get_state())):
        raise AssertionError("train entry: a save right after a replay does not hold "
                             "that replay's state")
    print(f"train entry: the remat graph's replays {[round(t, 3) for t in replay_ms]} ms "
          f"(host clock, synchronized), median {replay_median:.3f}; a profiled replay "
          f"{wall_ms:.3f} ms wall, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}% of it, {100 * busy_ms / replay_median:.1f}% of "
          f"the replay median), {sum(e.count for e in events)} device kernels, the port's "
          f"by name {by_name}; a save right after a replay holds that replay's "
          f"parameters, generator and step", flush=True)

    # `python -m basd_tpu_torch.evaluate` from the snapshot, in a subprocess
    # and in this process
    snapshot = f"{M7_OUT}/{cfg.run.name}/config.yaml"
    final_npz = f"{M7_OUT}/{cfg.run.name}/checkpoints/final_model.npz"
    eval_argv = [f"config={snapshot}", f"checkpoint.path={final_npz}"]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "basd_tpu_torch.evaluate", *eval_argv],
                          capture_output=True, text=True, timeout=600, env=env)
    eval_s_sub = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"evaluate exited {proc.returncode}:\n{proc.stdout}"
                             f"\n{proc.stderr[-4000:]}")
    if "eval route=graph" not in proc.stdout:
        raise AssertionError(f"evaluate: no `eval route=graph` line:\n{proc.stdout}")
    with open(f"{M7_OUT}/{cfg.run.name}/metrics.json") as f:
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
    want_eval["attention_fwd"] = want_eval["gelu_fwd"] = scfg.depth * (
        eval_batches + eval_cfg.efficiency_warmup + eval_cfg.efficiency_batches)
    want_eval["layernorm"] = (2 * scfg.depth + 1) * (
        eval_batches + eval_cfg.efficiency_warmup + eval_cfg.efficiency_batches)
    if not (same_primary(sub_primary) and same_primary(in_process["primary"])
            and eval_launches == want_eval):
        raise AssertionError(f"evaluate: {sub_primary} (subprocess), "
                             f"{in_process['primary']} (in process) vs the train run's "
                             f"{primary}; launches {eval_launches}, expected {want_eval}")
    print(f"evaluate: `python -m basd_tpu_torch.evaluate` from the snapshot (eval route "
          f"graph) reproduces the train run's final eval (top1 {primary['val_acc']:.4f}, "
          f"top5 {primary['val_acc_top5']:.4f}: equal; loss {sub_primary['loss']:.8f} vs "
          f"{primary['loss']:.8f}, tol 1e-6 relative) in {eval_s_sub:.1f} s; in process "
          f"launches {eval_launches}, efficiency "
          f"{in_process['efficiency']['throughput_img_per_sec']:.1f} img/s", flush=True)
    # the run's checkpoints (about 180 MB) are not kept: config.yaml and
    # metrics.json stay in chiprun_out/m7
    trainer.checkpoints.close()
    shutil.rmtree(f"{M7_OUT}/{cfg.run.name}/checkpoints")
    m7 = {"k": k, "route": step.route, "reason": step.reason, "trainer_step_ms": trainer_ms,
          "trainer_replay_median_ms": float(np.median(trainer_ms[2:])),
          "bare_step_median_ms": bare_step_median_ms,
          "capture_s": capture_s, "pool_bytes": pool_bytes,
          "recapture_s": step.capture_s, "recapture_pool_bytes": step.pool_bytes,
          "launches_per_replay": step.launches, "launches_by_name": by_name,
          "replay_ms": replay_ms, "replay_median_ms": replay_median,
          "profiled_replay_ms": wall_ms, "replay_busy_ms": busy_ms,
          "busy_share_median": busy_ms / replay_median,
          "replay_kernels": sum(e.count for e in events),
          "save_blocked_ms": trainer.checkpoints.blocked_ms,
          "eval_img_per_s": m7_results["efficiency"]["throughput_img_per_sec"],
          "eval": m7_eval, "peak_gib": m7_peak_gib, "held_gib": held_gib,
          "wall_s": m7_wall_s, "primary": primary, "kernel_check_s": trainer.kernel_check_s,
          "restore_launches": restore_launches,
          "phase_s": time.perf_counter() - t_phase}
    print(f"train entry: phase {m7['phase_s']:.1f} s", flush=True)
    return dict(m7=m7, cfg=cfg, trainer=trainer,
                launches={"train_entry": m7_launches, "evaluate": eval_launches})


def trainer_graph_check() -> int:
    """Phase 8 alone, a few minutes on one card: the kernels built,
    `trainer_phase`; its readings as one JSON line, then the card's name and
    power limit. Run it as `python3 -c "import chip_smoke, sys;
    sys.exit(chip_smoke.trainer_graph_check())"`."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check needs the card", file=sys.stderr)
        return 2
    from basd_tpu_torch import kernels
    from basd_tpu_torch.device import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build_all()
    dev = torch.device("cuda", 0)
    out = trainer_phase(dev, package_env(), None)
    print(json.dumps(out["m7"]))
    print(card_line(dev))
    return 0


def package_env() -> dict:
    """This process's environment with the repository first on PYTHONPATH,
    for the entry points it runs in processes of their own (the package is
    found from this script's directory, whatever the cwd)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.dirname(os.path.abspath(__file__)), env.get("PYTHONPATH"))
        if p)
    return env


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 2

    import torch.nn.functional as F

    from basd_tpu_torch import kernels
    from basd_tpu_torch.device import card_line
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
        time_mp_rank,
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
    card = card_line(dev)
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
    # the kernels' start-up check as a user runs it alone: one PASS line per
    # kernel of the train path (K1, K2, K4, K3, the MP rank, the SwiGLU gate,
    # the RoPE rotation at tiny shapes against their plain versions) in a
    # process of its own
    from basd_tpu_torch.utils.kernel_smoke import KERNEL_CHECKS

    env = package_env()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "basd_tpu_torch.tools.smoke_kernels"],
                          capture_output=True, text=True, timeout=300, env=env)
    passes = [line for line in proc.stdout.splitlines() if line.startswith("PASS ")]
    if (proc.returncode != 0 or len(passes) != len(KERNEL_CHECKS)
            or "ALL PASS" not in proc.stdout):
        raise AssertionError(f"smoke_kernels exited {proc.returncode}:\n{proc.stdout}"
                             f"\n{proc.stderr[-4000:]}")
    print(f"smoke_kernels: {time.perf_counter() - t0:.1f} s, {'; '.join(passes)}")
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
    t3 = stage_table3(dev)
    img, batch, num_classes = t3["img"], t3["batch"], t3["num_classes"]
    patch, raw, calib = t3["patch"], t3["raw"], t3["calib"]
    teacher, points, student, cfg = t3["teacher"], t3["points"], t3["student"], t3["cfg"]
    selector, images, labels, k_cal = t3["selector"], t3["images"], t3["labels"], t3["k"]
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
                 ("Table-1 ViT-L teacher", 256, 257, 1024, 16, (bf16,)),
                 # phase 9's rank-local shapes: Table-1 over data=4 (64 a
                 # rank) and over data=2 x model=2 (128 a rank; the
                 # student's 6 heads split 3 a rank)
                 ("data=4 ViT-L teacher", 64, 257, 1024, 16, (bf16,)),
                 ("2x2 ViT-L teacher", 128, 257, 1024, 16, (bf16,)),
                 ("data=4 Table-1 student", 64, 197, 384, 6, (bf16,)),
                 ("2x2 Table-1 student", 128, 197, 192, 3, (bf16,))]
    bwd_cases = ("student", "Table-1 student", "Table-2 student",
                 "data=4 Table-1 student", "2x2 Table-1 student")
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
    # card's params must be the CPU's in all eight columns, bit for bit: the
    # quarter-turn (the +-135 degree tie of angle / (pi/2)) and the shear
    # factors, whose tan and sin are taken in float64 and rounded once so
    # that no host's libm or the card's fp32 tanf/sinf enters. Each case
    # prints its route (`warp_route`).
    warp_ops = time_warp.edge_ops()

    def same_params(what, vals, flip):
        p_cpu = wk.warp_params(*vals, flip)
        params = wk.warp_params(*(v.to(dev) for v in vals), flip.to(dev))
        if not torch.equal(params.cpu(), p_cpu):
            rows, cols = torch.nonzero(params.cpu() != p_cpu, as_tuple=True)
            raise AssertionError(f"warp params {what}: card and cpu differ at (row, "
                                 f"column) {list(zip(rows.tolist(), cols.tolist()))}")
        return params

    # TrivialAugment's 62 rotate angles, +-m * 135 / 30 degrees, half flipped
    mags = torch.arange(31, dtype=f32) / 30.0
    ta_angle = torch.cat([mags, -mags]) * 135.0 * (np.pi / 180.0)
    z62 = torch.zeros_like(ta_angle)
    same_params("at TrivialAugment's 62 rotate angles", (ta_angle, z62, z62, z62, z62),
                torch.arange(62) % 2 == 1)
    print("warp params: card equals cpu bit for bit in all 8 columns at TrivialAugment's "
          "62 rotate angles")

    def warp_check(b, n, c, ops):
        vals, flip = time_warp.edge_mix(b, ops)
        params = same_params(f"edge_mix {(b, n, n, c)}", vals, flip)
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
              f"version ({b} rows, {turns} exact quarter-turns), identity exact, params "
              "equal to the cpu's")
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
    def run_steps(label, stu, tch, sel, pts, k, size, raw_size, ims, lbs, ncls, augment,
                  steps):
        """`steps` train steps of bench.py's step (augment=True) or the
        deterministic one, with the counters reset just before and read just
        after: every step checked (finite loss, (P, L) mixing weights whose
        rows sum to 1, MP ranks in [1, K], its exact launches)."""
        init_fn, step_fn = make_train_step(
            stu, tch, **STEP_HPARAMS, img_size=size, crop_ratio=size / raw_size,
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
              "jacobi_eigvals": 0, "attn_probe": 0, "mp_rank": 1, "swiglu_gate": 0,
              "gelu_fwd": 24, "gelu_bwd": 12, "rope_qk": 0, "layernorm": 25}
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
                    route=(fn.route, fn.reason),
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

    # ---- 5d. the selector against the float64 oracle ----
    # Table-3's real tokens are phase 4's selector inputs; K3 runs in its
    # three eighs there (K inside the gate), none at Table-1's K
    oracle = oracle_phase(dev, dict(selector=selector, student_tokens=s_out.tokens,
                                    teacher_tokens=t_tok, importance=t_imp, k=k_cal),
                          table1)
    if oracle["launches"]["jacobi_eigh"] != (3 if k3_on_path else 0):
        raise AssertionError(f"oracle: launches {oracle['launches']}")
    path_launches["oracle"] = oracle["launches"]

    # ---- 5e. the Table-3 step as one CUDA graph ----
    graph = graph_phase(dev, t3, table3, steps=MAIN_STEPS)
    path_launches["table3_graph"] = graph["launches"]
    # Table-1 and Table-2 stay eager: an eigh outside the Jacobi gate is
    # cuSOLVER's, which synchronizes with the host
    for label, t in (("Table-1", table1), ("Table-2", table2)):
        route, reason = t["route"]
        if route != "eager" or "cuSOLVER" not in reason:
            raise AssertionError(f"graph: {label} route {route} ({reason})")
        print(f"graph: {label} route={route}: {reason} (K={t['k']})")
        graph[f"{label.lower().replace('-', '')}_route"] = t["route"]
    print(f"graph: {card}")

    # ---- 5f. the MP-rank kernel against its plain version and the oracle ----
    # in a process of its own: staging the cells' programs runs the kernels'
    # start-up check, which phase 8 expects this process's first Trainer to run
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke, sys; sys.exit(chip_smoke.mp_rank_check())"],
        capture_output=True, text=True, timeout=900, env=package_env())
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"mp_rank_check exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    with open(MP_RANK_JSON) as f:
        mp = json.load(f)
    # ---- 5g. the SwiGLU gate and the ViT-g teacher, in a process of its own ----
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke, sys; sys.exit(chip_smoke.swiglu_check())"],
        capture_output=True, text=True, timeout=1200, env=package_env())
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"swiglu_check exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    with open(SWIGLU_JSON) as f:
        swiglu = json.load(f)
    report["swiglu_gate"] = {f"ViT-g teacher {case}": row
                             for case, row in swiglu["gate"].items()}
    path_launches["vitg14_step"] = swiglu["step"]["launches"]
    # ---- 5h. the GELU kernels and the cells' GELU launches, in a process of its own ----
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke, sys; sys.exit(chip_smoke.gelu_check())"],
        capture_output=True, text=True, timeout=1200, env=package_env())
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"gelu_check exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    with open(GELU_JSON) as f:
        gelu_readings = json.load(f)
    for name, part in (("gelu_fwd", "fwd"), ("gelu_bwd", "bwd")):
        report[name] = {case: row[part] for case, row in gelu_readings["cases"].items()}
    # ---- 5i. the selector's teacher projection on the tensor cores, in a process of its own ----
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke, sys; sys.exit(chip_smoke.projection_check())"],
        capture_output=True, text=True, timeout=1500, env=package_env())
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"projection_check exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    with open(PROJECTION_JSON) as f:
        projection = json.load(f)
    # ---- 5j. the RoPE rotation, K1 at head_dim 128 and a ViT-7B forward ----
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke, sys; sys.exit(chip_smoke.rope_check())"],
        capture_output=True, text=True, timeout=1200, env=package_env())
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"rope_check exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    with open(ROPE_JSON) as f:
        rope_readings = json.load(f)
    report["rope_qk"] = rope_readings["rope"]
    report["attention_fwd"]["ViT-7B teacher B=256 N=201 D=4096 H=32 bfloat16"] = \
        rope_readings["k1_hd128"]
    path_launches["rope_cases"] = rope_readings["launches"]
    path_launches["dinov3_step"] = rope_readings["step"]["launches"]
    # ---- 5k. the LayerNorm kernel at the teachers' shapes, in a process of its own ----
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke, sys; sys.exit(chip_smoke.layernorm_check())"],
        capture_output=True, text=True, timeout=600, env=package_env())
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"layernorm_check exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    with open(LAYERNORM_JSON) as f:
        report["layernorm"] = json.load(f)["cases"]
    timing = mp["timing"]["shapes"]
    report["mp_rank"] = {}
    for bsz, nn_, m_ in time_mp_rank.PLAIN_SHAPES:
        kern = next(r for name, r in timing.items()
                    if name.startswith(f"kernel ({bsz}, {nn_}, {nn_})"))
        # one read of the Grams and the outputs' writes; about 4/3 n^3 FLOPs a
        # matrix: at each step 2 j^2 for A v on the j x j trailing block and
        # 2 j^2 for the symmetric rank-2 update of its one triangle
        t_bytes = 4 * bsz * (nn_ * nn_ + 2 * nn_) / HBM_BYTES_PER_S * 1e3
        t_ops = bsz * sum(4 * j * j for j in range(2, nn_)) / peak_flops[f32] * 1e3
        report["mp_rank"][f"teacher Grams ({bsz}, {nn_}, {nn_})"] = dict(
            ms=kern["ms"], device_ms=kern["ms"], cluster=kern["cluster"],
            plain_ms=timing[f"plain ({bsz}, {nn_}, {nn_}) m {m_}"]["ms"],
            library_ms=timing[f"eigvalsh ({bsz}, {nn_}, {nn_})"]["ms"],
            bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
            max_abs_err=max(abs(a - b) for case in mp["cases"].values()
                            for a, b in zip(case["ranks"], case["plain"])))

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

    # the main path's step both ways: op by op (host time by stage), and
    # the replay of its CUDA graph (phase 5's)
    profile_step("Table-3 eager", step_fn.eager, state, images, labels,
                 report["warp"][f"main path {(batch, img, img, 3)}"])
    profile_step("Table-3 replay", step_fn, state, images, labels,
                 report["warp"][f"main path {(batch, img, img, 3)}"])
    torch.cuda.reset_peak_memory_stats()
    profile_step("Table-1", table1["step_fn"], table1["state"], table1["images"],
                 table1["labels"], report["warp"]["reference default (256, 224, 224, 3)"])
    print(f"profile Table-1: peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          "GiB")

    # ---- 8. the trainer and evaluation entry points at Table-3 width ----
    # `python -m basd_tpu_torch.train` as a user runs it (through `main`), on
    # the graph route, held against a twin's eager steps; restores; the
    # evaluation's graphs against eager; `python -m basd_tpu_torch.evaluate`
    # (`trainer_phase`)
    del table1["state"], table1["step_fn"], table1["teacher"], table1["images"]
    phase8 = trainer_phase(dev, env, float(np.median(step_ms[1:])))
    m7, m7_cfg, trainer = phase8["m7"], phase8["cfg"], phase8["trainer"]
    path_launches.update(phase8["launches"])
    m7_argv, out_root = M7_ARGV, M7_OUT
    m7_student = trainer.state.student.config
    eval_cfg = m7_cfg.evaluation

    # ---- 9. data and tensor parallelism, the ranks sharing this card ----
    # NCCL refuses two ranks on one card, so the ranks talk over gloo (the
    # backend `parallel.mesh.choose_backend` picks when ranks outnumber the
    # cards), which stages each collective through the host; every kernel
    # still runs on the card in every rank. What this reads is correctness
    # and the overhead of sharing one card, not scaling.
    from basd_tpu_torch.config import compose_from_snapshot
    from basd_tpu_torch.parallel.mesh import choose_backend
    from basd_tpu_torch.training.trainer import state_digest

    # logs beside phase 8's; parameters and checkpoints under outputs/m8,
    # deleted at the end (they exceed what the output directory may hold)
    m8_root, m8_big = os.path.join(os.path.dirname(out_root), "m8"), "outputs/m8"
    for d in (m8_root, m8_big):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(m8_root)
    os.makedirs(f"{m8_big}/ranks")
    os.environ["LOCAL_WORLD_SIZE"] = "4"
    backend = choose_backend(dev)  # gloo on one card
    del os.environ["LOCAL_WORLD_SIZE"]
    print(f"mesh: 4 ranks on {torch.cuda.device_count()} card(s): backend {backend}")

    # 9a. Table-1 at full width, one augmented step on one process (5c's
    # step, fresh), then on data=4 and data=2 x model=2
    k1 = table1["k"]
    per_step1 = table1["per_step"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tch1, ims1, lbs1, pts1 = table1_inputs(dev)
    state1, step1, theta0 = table1_step(dev, tch1, pts1, k1)
    kernels.reset_launches()
    t0 = time.perf_counter()
    state1, met1 = step1(state1, ims1, lbs1)
    float(met1["loss"])
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - t0) * 1e3
    ref_launches = dict(kernels.LAUNCHES)
    if ref_launches != per_step1:
        raise AssertionError(f"mesh reference: launches {ref_launches} != {per_step1}")
    ref = dict(loss=float(met1["loss"]), weights=met1["mixing_weights"].float().cpu(),
               ranks=met1["mp_ranks"].cpu(),
               temps_after=F.softplus(state1.selector.log_temperatures).detach().cpu(),
               theta=torch.cat([v.detach().float().cpu().reshape(-1) - theta0[n].reshape(-1)
                                for n, v in state1.student.state_dict().items()]))
    ref_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"mesh reference (one process, batch 256): loss {ref['loss']:.6f} step "
          f"{ref_ms:.2f} ms, peak {ref_peak:.2f} GiB; launches {ref_launches}")
    del state1, step1, met1, tch1, ims1, lbs1
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    ctx = torch.multiprocessing.start_processes(
        mesh_rank, args=(4, free_port(), f"{m8_big}/ranks", k1), nprocs=4,
        join=False, start_method="spawn")
    t0 = time.perf_counter()
    while not ctx.join(timeout=5):  # a rank's error raises here
        if time.perf_counter() - t0 > 420:
            for proc in ctx.processes:
                proc.kill()
            raise AssertionError("phase 9a: the ranks did not finish in 420 s")
    mesh_s = time.perf_counter() - t0
    mesh_report = {}
    for name, (data, model) in MESHES.items():
        rows = []
        for r in range(4):
            with open(f"{m8_big}/ranks/{name}-rank{r}.json") as f:
                rows.append(json.load(f))
        full = torch.load(f"{m8_big}/ranks/{name}-params.pt", weights_only=True)
        delta = torch.cat([full[n].reshape(-1) - theta0[n].reshape(-1) for n in theta0])
        rel_update = float((delta - ref["theta"]).norm() / ref["theta"].norm())
        flipped = float(((delta > 0) != (ref["theta"] > 0)).float().mean())
        for row in rows:
            what = f"mesh {name} rank {row['rank']}"
            if row["backend"] != backend or row["launches"] != per_step1:
                raise AssertionError(f"{what}: backend {row['backend']}, launches "
                                     f"{row['launches']} != {per_step1}")
            if not abs(row["loss"] - ref["loss"]) <= 1e-3 * abs(ref["loss"]):
                raise AssertionError(f"{what}: loss {row['loss']} vs {ref['loss']}")
            if row["ranks"] != ref["ranks"].tolist():
                raise AssertionError(f"{what}: mp_ranks differ")
            w_err = (torch.tensor(row["weights"]) - ref["weights"]).abs().max().item()
            t_err = (torch.tensor(row["temps_after"]) - ref["temps_after"]).abs().max().item()
            if not (w_err <= 2e-3 and t_err <= 1e-5):
                raise AssertionError(f"{what}: weights {w_err}, temperatures {t_err}")
            replica = rows[row["model_index"]]
            if row["digest"] != replica["digest"] or row["generator"] != rows[0]["generator"]:
                raise AssertionError(f"{what}: parameters or generator differ from "
                                     f"rank {replica['rank']}'s")
        # the first ScheduleFree update is about gamma sign(g), so this ratio
        # is about 2 sqrt(share of gradient entries whose sign differs): the
        # bound admits the bf16 sums' sign flips near zero (a few percent)
        # and refuses a wrong or partial gradient (about 1 and more)
        if not rel_update <= 0.5:
            raise AssertionError(f"mesh {name}: update differs by {rel_update}")
        mesh_report[name] = dict(
            data=data, model=model, loss=rows[0]["loss"], rel_update=rel_update,
            sign_flipped=flipped, step_ms=[r["step_ms"] for r in rows],
            second_step_ms=[r["second_step_ms"] for r in rows],
            timed_step_ms=[r["timed_step_ms"] for r in rows],
            collective_ms=[r["collective_ms"] for r in rows],
            collective_calls=rows[0]["collective_calls"],
            peak_gib=[r["peak_gib"] for r in rows], launches=rows[0]["launches"])
        print(f"mesh {name} (data={data} x model={model}, batch {rows[0]['batch']} a "
              f"rank): loss {rows[0]['loss']:.6f} vs one process {ref['loss']:.6f}, "
              f"MP ranks equal, weights and temperatures within 2e-3 / 1e-5; "
              f"||dtheta - dtheta_1|| / ||dtheta_1|| {rel_update:.4g} (bound 0.5; "
              f"{100 * flipped:.3f}% of entries moved the other way); data replicas "
              f"bit-identical; launches per rank {rows[0]['launches']}")
        for r in rows:
            print(f"  rank {r['rank']} (data {r['data_index']}, model "
                  f"{r['model_index']}): first step {r['step_ms']:.2f} ms, second "
                  f"{r['second_step_ms']:.2f} ms, third (collectives synchronized and "
                  f"timed) {r['timed_step_ms']:.2f} ms, collectives ms "
                  f"{ {n: round(v, 3) for n, v in r['collective_ms'].items()} }, "
                  f"peak {r['peak_gib']:.2f} GiB")
    print(f"mesh: phase 9a ranks {mesh_s:.1f} s; collective calls per step "
          f"{ {n: m['collective_calls'] for n, m in mesh_report.items()} }")

    # 9b. Table-3 through torchrun and `train.main`, data=4: phase 8's run
    train_dir = f"{m8_big}/train"
    argv = [a for a in m7_argv if not a.startswith("run.output_dir=")]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=4", "-m", "basd_tpu_torch.train", *argv,
           f"run.output_dir={train_dir}", "hardware.mesh.data=4", "hardware.mesh.model=1"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, env=env)
    torchrun_s = time.perf_counter() - t0
    with open(f"{m8_root}/torchrun.log", "w") as f:
        f.write(proc.stdout + "\n---- stderr ----\n" + proc.stderr)
    if proc.returncode != 0:
        raise AssertionError(f"torchrun train exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-4000:]}")
    decoder = json.JSONDecoder()
    summaries = sorted((decoder.raw_decode(proc.stdout, m.end())[0]
                        for m in re.finditer(r"rank_summary ", proc.stdout)),
                       key=lambda x: x["rank"])
    run_dir = f"{train_dir}/{m7_cfg.run.name}"
    with open(f"{run_dir}/metrics.json") as f:
        dp_primary = json.load(f)["primary"]
    cfg9 = compose_from_snapshot(f"{run_dir}/config.yaml", [])
    k9 = cfg9.basd.subspace_k
    per_step9 = per_step_launches(m7_student, trainer.teacher, trainer.extraction_points,
                                  k9, True)
    eval_fwd = 2 * m7_student.depth  # the epoch's and the suite's eval, one slice each
    for row in summaries:
        # each rank's first Trainer runs the kernel start-up check
        want = {n: v * 8 + KERNEL_CHECK_LAUNCHES[n] for n, v in per_step9.items()}
        want["attention_fwd"] += eval_fwd
        want["gelu_fwd"] += eval_fwd
        want["layernorm"] += 2 * (2 * m7_student.depth + 1)
        if row["rank"] == 0:  # the efficiency forwards and the K calibration
            efficiency = m7_student.depth * (
                eval_cfg.efficiency_warmup + eval_cfg.efficiency_batches)
            want["attention_fwd"] += efficiency + teacher_layers(trainer.teacher)
            want["gelu_fwd"] += efficiency + gelu_mlps(trainer.teacher.module)
            want["layernorm"] += (2 * m7_student.depth + 1) * (
                eval_cfg.efficiency_warmup + eval_cfg.efficiency_batches) + layer_norms(
                trainer.teacher.module)
            want["mp_rank"] += 1
        if (row["subspace_k"] != k9 or row["steps"] != 8 or row["launches"] != want
                or row["kernel_check_launches"] != KERNEL_CHECK_LAUNCHES
                or row["state_digest"] != summaries[0]["state_digest"]
                or row["backend"] != backend):
            raise AssertionError(f"torchrun rank {row['rank']}: {row}; expected K {k9}, "
                                 f"8 steps, launches {want}, rank 0's digest")
    if len(summaries) != 4:
        raise AssertionError(f"torchrun: {len(summaries)} rank summaries")
    # `latest` restored into a one-process trainer equals every rank's state
    fresh_student, fresh_cfg = create_student(
        cfg9.model.student_preset, num_classes=cfg9.model.num_classes,
        drop_path_rate=cfg9.model.drop_path_rate, img_size=img,
        arch_overrides={**cfg9.model.arch_overrides, "patch_size": patch},
        capture_layers=trainer.extraction_points, dtype=bf16, remat=True, device=dev,
        seed=cfg9.run.seed + 7)
    fresh = Trainer(cfg9, student=fresh_student, student_cfg=fresh_cfg,
                    teacher=trainer.teacher,
                    teacher_stats=(trainer.teacher.mean, trainer.teacher.std),
                    dataset_stats=trainer._eval_stats)
    fresh.load_checkpoint(os.path.abspath(f"{run_dir}/checkpoints/latest"))
    if state_digest(fresh.state) != summaries[0]["state_digest"]:
        raise AssertionError("torchrun: `latest` restored into one process differs "
                             "from the ranks' state")
    del fresh, fresh_student
    # one process at the ranks' batch (32): each of its batches is a rank's
    # slice, so the bf16 products have the ranks' shapes (cuBLAS picks its
    # kernels by shape: at batch 128 the loss moved by 2.1e-4 relative on
    # the H100, top-1/top-5 equal)
    eval9 = [f"config={run_dir}/config.yaml",
             f"checkpoint.path={run_dir}/checkpoints/final_model.npz",
             f"run.output_dir={m8_root}/evaluate", "data.batch_size=32"]
    proc = subprocess.run([sys.executable, "-m", "basd_tpu_torch.evaluate", *eval9],
                          capture_output=True, text=True, timeout=600, env=env)
    if proc.returncode != 0:
        raise AssertionError(f"evaluate exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    with open(f"{m8_root}/evaluate/{m7_cfg.run.name}/metrics.json") as f:
        one_primary = json.load(f)["primary"]
    if not (one_primary["val_acc"] == dp_primary["val_acc"]
            and one_primary["val_acc_top5"] == dp_primary["val_acc_top5"]
            and abs(one_primary["loss"] - dp_primary["loss"])
            <= 1e-5 * abs(dp_primary["loss"])):
        raise AssertionError(f"evaluate in one process {one_primary} vs the 4-rank "
                             f"run's {dp_primary}")
    print(f"torchrun train (data=4, 4 ranks, global batch 128): {torchrun_s:.1f} s; "
          f"log {m8_root}/torchrun.log; "
          f"K={k9} on every rank; launches per rank exact (rank 0 "
          f"{summaries[0]['launches']}, others {summaries[1]['launches']}); every rank's "
          f"state bit-identical, and `latest` restored into one process equals it; "
          f"one-process evaluate (batch 32, the ranks' slices): top1 "
          f"{one_primary['val_acc']:.4f} top5 "
          f"{one_primary['val_acc_top5']:.4f} equal, loss {one_primary['loss']:.8f} vs "
          f"{dp_primary['loss']:.8f} (tol 1e-5 relative)")
    for row in summaries:
        print(f"  rank {row['rank']}: trainer step ms "
              f"{[round(t, 2) for t in row['step_ms']]}, median after the first "
              f"{np.median(row['step_ms'][1:]):.2f}; peak {row['peak_gib']:.2f} GiB; "
              f"kernel start-up check {row['kernel_check_s']:.2f} s, launches "
              f"{row['kernel_check_launches']}")
    path_launches["mesh_dp4_rank0"] = mesh_report["dp4"]["launches"]
    path_launches["mesh_tp22_rank0"] = mesh_report["tp22"]["launches"]
    path_launches["torchrun_train_rank0"] = summaries[0]["launches"]
    # the run's config and metrics are kept; the ranks' parameter files and
    # the run's checkpoints are not
    shutil.copytree(run_dir, f"{m8_root}/train",
                    ignore=shutil.ignore_patterns("checkpoints"))
    shutil.rmtree(m8_big)
    m8 = {"reference": dict(loss=ref["loss"], step_ms=ref_ms, peak_gib=ref_peak),
          "meshes": mesh_report, "ranks_s": mesh_s, "torchrun_s": torchrun_s,
          "torchrun_ranks": [{k: r[k] for k in ("rank", "step_ms", "peak_gib",
                                                "kernel_check_s")}
                             for r in summaries],
          "primary_4_ranks": dp_primary, "primary_one_process": one_primary}

    # ---- 10. the measurement entry points ----
    # The stage profiler and three probes in this process at full width,
    # each with the counters reset just before and read just after
    # (`tool_path`), their timed calls per stage lowered to MEASURE_ARGS' to
    # keep the run in its time.
    from basd_tpu_torch.tools import probe_loss_tail, probe_selector_internals, probe_step_gap
    from basd_tpu_torch.tools import profile_step as profile_step_tool

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    measured_tools = {}
    for name, module, argv, needs in (
            ("profile_step", profile_step_tool, MEASURE_ARGS["profile_step"],
             ("attention_fwd", "attention_bwd", "jacobi_eigh", "warp")),
            ("profile_step_imagenet", profile_step_tool,
             ["--imagenet", *MEASURE_ARGS["profile_step_imagenet"]],
             ("attention_fwd", "attention_bwd", "jacobi_eigh", "warp")),
            ("probe_selector_internals_t3", probe_selector_internals,
             ["--t3", *MEASURE_ARGS["probe_selector_internals"]], ("jacobi_eigh",)),
            ("probe_selector_internals_vitl14", probe_selector_internals,
             ["--teacher", "dinov2_vitl14", "--model-tokens",
              *MEASURE_ARGS["probe_selector_internals"]], ()),
            ("probe_loss_tail", probe_loss_tail, MEASURE_ARGS["probe_loss_tail"], ()),
            ("probe_step_gap", probe_step_gap, MEASURE_ARGS["probe_step_gap"],
             ("attention_fwd", "attention_bwd", "warp"))):
        measured_tools[name], path_launches[name] = tool_path(
            name, lambda: module.main(argv, device=dev), needs)
        torch.cuda.empty_cache()
    sel_l = measured_tools["probe_selector_internals_vitl14"]
    print(f"selector at K = 192 on the models' tokens (ViT-L/14, Table-1): select {sel_l['select']:.3f} ms; "
          f"topk_t {sel_l['topk_t']:.3f}, topk_s {sel_l['topk_s']:.3f}, angles "
          f"{sel_l['angles']:.3f}, angles_g {sel_l['angles_g']:.3f}, ranks "
          f"{sel_l['ranks']:.3f}, proj_t {sel_l['proj_t']:.3f} ms; eigh routes "
          f"{ {k: r for k, (_, r) in sel_l['routes'].items()} }")
    measure_s = time.perf_counter() - t_phase
    print(f"measurement entry points: phase {measure_s:.1f} s")

    # ---- 11. the last tools and the entry check ----
    # probe_ns_mixed, probe_warp_kernel and probe_warp_parity8 at full size,
    # each in a process of its own that runs the tool's `main` as `python -m`
    # does and reads the kernels' counts just after; then
    # `entry()`'s forward on the card (its launches counted; its logits and
    # tokens against the same forward on the CPU within BF16_ULPS_8 of each
    # output's scale, on the entry's zero batch and a seeded one), and
    # `dryrun_multichip(4)`: 4 ranks sharing the card over gloo on a 2 x 2
    # mesh, rank 0's loss and the sketches of its gradient and update
    # against `dryrun_step` in this process on the same global batch
    # (`entry.DRYRUN_BOUNDS`) and its launches equal to that step's.
    from basd_tpu_torch import entry as entry_mod

    t_phase = time.perf_counter()
    runner = ("import json; from basd_tpu_torch import kernels; "
              "from basd_tpu_torch.tools import {name} as tool; kernels.reset_launches(); "
              "r = tool.main(); print('tool_result ' + json.dumps("
              "dict(result=r, launches=dict(kernels.LAUNCHES))), flush=True)")
    last_tools = {}
    for name, needs in (("probe_ns_mixed", ()), ("probe_warp_kernel", ("warp",)),
                        ("probe_warp_parity8", ("warp",))):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", runner.format(name=name)],
                              capture_output=True, text=True, timeout=600, env=env)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines or not lines[-1].startswith("tool_result "):
            raise AssertionError(f"{name} exited {proc.returncode}:\n{proc.stdout[-3000:]}"
                                 f"\n{proc.stderr[-3000:]}")
        out = json.loads(lines[-1][len("tool_result "):])
        for line in lines[:-1]:
            print(f"{name}: {line}")
        counts = out["launches"]
        for kname in needs:
            if counts[kname] == 0:
                raise AssertionError(f"{name}: no {kname} launch in {counts}")
        path_launches[name] = counts
        last_tools[name] = dict(out["result"], wall_s=time.perf_counter() - t0)
        print(f"path {name}: launches {counts}; {last_tools[name]['wall_s']:.1f} s")
    ns = last_tools["probe_ns_mixed"]["all-fp32 (shipping)"]
    if not ns["relerr_max"] < 1e-3:
        raise AssertionError(f"probe_ns_mixed: the shipping fp32 schedule {ns}")
    wp = last_tools["probe_warp_kernel"]
    if not (wp["parity_max_err"] <= 1e-5 and wp["fused_ms"] > 0 and wp["tap_sweep_ms"] > 0):
        raise AssertionError(f"probe_warp_kernel: {wp}")

    t0 = time.perf_counter()
    forward, (e_params, e_images) = entry_mod.entry()
    torch.cuda.synchronize()
    kernels.reset_launches()
    e_out = forward(e_params, e_images)
    torch.cuda.synchronize()
    path_launches["entry_forward"] = dict(kernels.LAUNCHES)
    if path_launches["entry_forward"] != {**dict.fromkeys(kernels.LAUNCHES, 0),
                                          "attention_fwd": 12, "gelu_fwd": 12,
                                          "layernorm": 25}:
        raise AssertionError(f"entry forward launches {path_launches['entry_forward']}, "
                             "expected K1 and the GELU forward once per block (12), the "
                             "LayerNorm twice per block and once after (25)")
    cpu_forward, _ = entry_mod.entry(device="cpu")
    cpu_params = {k: v.cpu() for k, v in e_params.items()}
    seeded = torch.rand(e_images.shape, device=dev, generator=gen)
    entry_err = {}
    for label, images in (("zeros", e_images), ("seeded", seeded)):
        got = e_out if label == "zeros" else forward(e_params, images)
        want = cpu_forward(cpu_params, images.cpu())
        for what, g, w in zip(("logits", "tokens"), got, want):
            err = (g.float().cpu() - w.float()).abs().max().item()
            scale = w.float().abs().max().item()
            entry_err[f"{label} {what}"] = err / scale
            if not err <= BF16_ULPS_8 * scale:
                raise AssertionError(f"entry forward {label} {what}: card vs cpu {err} "
                                     f"> {BF16_ULPS_8} * {scale}")
    entry_s = time.perf_counter() - t0
    print(f"entry: forward {tuple(tuple(o.shape) for o in e_out)} on the card, launches "
          f"{path_launches['entry_forward']}; card vs cpu relative to scale {entry_err}; "
          f"{entry_s:.1f} s")

    one = entry_mod.dryrun_step(4, None, dev)
    path_launches["dryrun_one_process"] = one["launches"]
    t0 = time.perf_counter()
    dryrun = entry_mod.dryrun_multichip(4)
    dryrun_s = time.perf_counter() - t0
    path_launches["dryrun_rank0"] = dryrun["launches"]
    dryrun_dist = entry_mod.dryrun_distances(dryrun, one)
    if not (dryrun["mesh"] == [2, 2] and np.isfinite(dryrun["loss"])
            and all(dryrun_dist[k] <= b for k, b in entry_mod.DRYRUN_BOUNDS.items())
            and dryrun["launches"] == one["launches"]
            and all(one["launches"][k] > 0 for k in ("attention_fwd", "attention_bwd", "warp"))):
        raise AssertionError(f"dryrun_multichip(4): loss {dryrun['loss']}, launches "
                             f"{dryrun['launches']}; one process: loss {one['loss']}, launches "
                             f"{one['launches']}; distances {dryrun_dist} against bounds "
                             f"{entry_mod.DRYRUN_BOUNDS}")
    print(f"dryrun: 2 x 2 ranks over {dryrun['backend']}, loss {dryrun['loss']:.6f} against "
          f"one process {one['loss']:.6f}; mesh against one process (bounds "
          f"{entry_mod.DRYRUN_BOUNDS}): {dryrun_dist}; rank 0's launches {dryrun['launches']} "
          f"(the one-process step's); {dryrun_s:.1f} s")
    last_s = time.perf_counter() - t_phase
    print(f"last tools and entry check: phase {last_s:.1f} s")

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
        "mp_rank": ("basd_tpu_torch/csrc/mp_rank.cu",
                    "none (basd_tpu/spectral/tridiag.py's fori_loops, in XLA's program)",
                    "teacher Grams (12, 192, 192)"),
        "attn_probe": ("basd_tpu_torch/csrc/attn_probe.cu",
                       "tools/probe_attn_internals.py:25",
                       "full (256, 12, 257, 64)"),
        "swiglu_gate": ("basd_tpu_torch/csrc/swiglu.cu",
                        "none (the JAX package has no SwiGLU MLP)",
                        f"ViT-g teacher ({VITG_ROWS}, {2 * VITG_G}) bfloat16"),
        "gelu_fwd": ("basd_tpu_torch/csrc/gelu.cu",
                     "none (basd_tpu/ops/activations.py, fused by XLA)",
                     "t1 teacher (65792, 4096) bfloat16"),
        "gelu_bwd": ("basd_tpu_torch/csrc/gelu.cu",
                     "none (basd_tpu/ops/activations.py, fused by XLA)",
                     "t1 student (50432, 1536) bfloat16"),
        "rope_qk": ("basd_tpu_torch/csrc/rope.cu",
                    "none (the JAX package has no rotary positions)",
                    "ViT-7B teacher (256, 201, 12288) bfloat16"),
        "layernorm": ("basd_tpu_torch/csrc/layernorm.cu",
                      "none (flax's nn.LayerNorm in basd_tpu/models/vit.py, fused by XLA)",
                      "t1 teacher (65792, 1024) bfloat16"),
    }
    # each kernel's launches on the path it serves: the train step for
    # K1-K4, the spectral tuner for K5, the attention probe for K6, the
    # ViT-g step for the gate, the DINOv3 ViT-7B step for the rotation
    own_path = {"jacobi_eigvals": "tune_spectral",
                "attn_probe": "probe_attn_internals", "swiglu_gate": "vitg14_step",
                "rope_qk": "dinov3_step"}
    measured = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
                "bound_ms", "bound_by",
                "max_abs_err", "rel_err", "eig6_err", "eig_err", "recon_err",
                "orth_err", "eig3_err", "us_per_step", "route", "k1_ms",
                "k1_plain_ms", "k1_bound_ms", "sdpa_ms", "differing",
                "w_equals_k5", "k5_device_ms", "over_own_ulp", "max_ulps", "roofline_pct",
                "differing_share", "max_excess",
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
                      "m7": m7, "m8": m8, "oracle": oracle, "graph": graph,
                      "mp_rank": mp, "swiglu": swiglu, "projection": projection,
                      "rope": rope_readings,
                      "measure_tools": measured_tools, "measure_s": measure_s,
                      "last_tools": last_tools, "entry_rel_err": entry_err,
                      "entry_s": entry_s,
                      "dryrun": {**{k: v for k, v in dryrun.items() if k not in ("grad", "update")},
                                 "one_process_loss": one["loss"], "distances": dryrun_dist,
                                 "wall_s": dryrun_s},
                      "last_s": last_s,
                      "jacobi_eigh_us_per_step_by_n": us_by_n}))
    print(card_line(dev))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
