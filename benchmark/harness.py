"""The benchmark's one general harness: it runs any cell of
`BENCHMARK.json` by the names found there, and names none itself.

For a cell it reads `configs/<config>.json` (the sizes and settings, with
a `family` that names the program's staging, `stage/<family>.py`, the
plain reference, `reference/<family>.py`, and the cost counts,
`costs/<family>.py`), `traffic/<traffic>.json` (the feed's parameters),
`workloads/<cell>.json` (the traced run's stretch and the limits of the
comparison) and one reader per metric, `metrics/<metric>.py`.

A run:
  1. set-up (`setup_s`, from the process's start): the program staged
     from the seed, a host pool of seeded uint8 batches fed through the
     port's own input path (`epoch_batches` -> `prefetch_to_device`), and
     the first steps, which warm up and capture the step and which the
     reference follows; then `warm_seconds` (the traffic's) of steps;
  2. `--trace 0`: a closed loop of steps for `--seconds`, ended by a
     synchronize; `--trace 1`: an unprofiled stretch as long, a profiled
     stretch of replays and one profiled eager step;
  3. the peak memory read, the program freed, the reference run on the
     same batches and weights, and every compared number held to its
     limit.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import statistics
import sys
import tempfile
import time
from itertools import count
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "basd_tpu")
# the first steps, which warm up and capture the step: the reference
# follows them
CHECKED_STEPS = 3
# untraced profiler cycles before the traced replays
PROFILE_WAIT, PROFILE_WARMUP = 1, 2


def process_age_s(started: float) -> float:
    """Seconds since this process began (Linux: its start time in
    /proc/self/stat), else since `started` on the perf_counter clock."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - started


def load_json(*parts) -> dict:
    with open(HERE.joinpath(*parts)) as f:
        return json.load(f)


def cell_spec(name: str) -> SimpleNamespace:
    """Everything a cell is, found by the names in `BENCHMARK.json`."""
    with open(ROOT / "BENCHMARK.json") as f:
        manifest = json.load(f)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]
    applies = lambda m: name in m.get("workloads", [name])
    return SimpleNamespace(
        name=name, chips=cell["chips"], config=load_json("configs", cell["config"] + ".json"),
        traffic=load_json("traffic", cell["traffic"] + ".json"),
        workload=load_json("workloads", name + ".json"),
        end_to_end=[m for m in manifest["end_to_end"] if applies(m)],
        per_layer=[m for m in manifest["per_layer"] if applies(m)])


def derive_seeds(seed: int) -> dict:
    """Independent 62-bit seeds for each random source of a run."""
    names = ("teacher", "student", "selector", "step", "data")
    state = np.random.SeedSequence(seed).generate_state(len(names), np.uint64)
    return {n: int(s) >> 2 for n, s in zip(names, state)}


def smoke_config(cfg: dict) -> dict:
    """The configuration at a CPU wiring check's size (every width cut;
    its numbers mean nothing)."""
    cfg = json.loads(json.dumps(cfg))
    small = dict(embed_dim=64, depth=4, num_heads=2, patch_size=4)
    cfg["student"].update(small, img_size=16, num_classes=10)
    cfg["teacher"].update(small)
    cfg["data"].update(batch_size=8, raw_size=20, crop_ratio=0.8)
    cfg["basd"]["subspace_k"] = None
    return cfg


class Feed:
    """The port's input path over a host pool of seeded uint8 batches:
    each epoch a fresh permutation of the pool (`epoch_batches`), copied
    to the device two batches ahead (`prefetch_to_device`), as
    `Trainer._train_epoch` feeds its step. The first `keep` host batches
    are kept for the reference."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, keep: int):
        from basd_tpu_torch.data.pipeline import epoch_batches, prefetch_to_device

        b, raw = cfg["data"]["batch_size"], cfg["data"]["raw_size"]
        rng = np.random.default_rng(seed)
        n = traffic["pool_batches"] * b
        self.images = rng.integers(0, 256, (n, raw, raw, 3), dtype=np.uint8)
        self.labels = rng.integers(0, cfg["student"]["num_classes"], n, dtype=np.int64)
        self.kept: list = []

        def host():
            for epoch in count():
                order = np.random.default_rng([seed, epoch])
                for imgs, labs in epoch_batches(self.images, self.labels, b, order):
                    if len(self.kept) < keep:
                        self.kept.append((imgs.copy(), labs.copy()))
                    yield imgs, labs

        self.batches = prefetch_to_device(host(), device=device)

    def __next__(self):
        return next(self.batches)


def first_steps(stage, cfg: dict, traffic: dict, seeds: dict, device):
    """The program staged from the seeds and its first CHECKED_STEPS steps
    through the feed, which the reference follows: (program, feed, the
    readings that `judge.numbers` compares)."""
    prog = stage.Program(cfg, seeds, device)
    feed = Feed(cfg, traffic, seeds["data"], device, keep=CHECKED_STEPS)
    checked, grad_norms = [], None
    for i in range(CHECKED_STEPS):
        metrics = prog.step(*next(feed))
        checked.append({k: v.detach().cpu() for k, v in metrics.items()})
        if i == 0:
            grad_norms = prog.grad_norms()
    first = SimpleNamespace(steps=checked, grad_norms=grad_norms, params=prog.params())
    return prog, feed, first


def percentile(values: list, q: int) -> float:
    """The q-th percentile (inclusive method, Python's statistics)."""
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def closed_loop(prog, feed, seconds: float, device) -> SimpleNamespace:
    """Steps back to back for `seconds` of host time, then a synchronize:
    the steps, the window's seconds, each step's ms between consecutive
    step ends (CUDA events on the step's stream) and the losses."""
    import torch

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    marks = []

    def mark():
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())

    losses = []
    t0 = time.perf_counter()
    mark()
    while True:
        losses.append(prog.step(*next(feed))["loss"])
        mark()
        if time.perf_counter() - t0 >= seconds:
            break
    if cuda:
        torch.cuda.synchronize()
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    window_s = time.perf_counter() - t0
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    return SimpleNamespace(steps=len(losses), window_s=window_s, step_ms=step_ms,
                           failed=failed)


def _export(prof, tmpdir):
    from benchmark.trace import Timeline

    path = Path(tmpdir) / "trace.json"
    prof.export_chrome_trace(str(path))
    timeline = Timeline.load(path)
    path.unlink()
    return timeline


def profiled_replays(prog, batches, active: int, device, tmpdir):
    """Steps on `batches` under torch.profiler (host and device), the first
    PROFILE_WAIT + PROFILE_WARMUP of them untraced cycles that absorb the
    profiler's first-launch costs, the last `active` traced. Returns the
    timeline of the traced steps and their host seconds (from the traced
    cycle's start to a synchronize after the last step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    lead = PROFILE_WAIT + PROFILE_WARMUP
    with profile(activities=acts, schedule=schedule(wait=PROFILE_WAIT, warmup=PROFILE_WARMUP,
                                                    active=active)) as prof:
        for i, batch in enumerate(batches[:lead + active]):
            if i == lead:
                # the traced cycle starts on an idle device: no replay of
                # the untraced cycles runs into it
                if cuda:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
            prog.step(*batch)
            if i == lead + active - 1:
                if cuda:
                    torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            prof.step()
    return _export(prof, tmpdir), seconds


def profiled_eager(prog, batch, device, tmpdir):
    """One eager step (`TrainStep.eager`) under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        prog.eager_step(*batch)
        if cuda:
            torch.cuda.synchronize()
    return _export(prof, tmpdir)


def traced(prog, feed, spec, cfg, costs, seconds, device) -> SimpleNamespace:
    """The traced run: an unprofiled stretch (the step's FLOP rate), a
    profiled stretch of replays (busy and idle share, kernels, rooflines,
    the breakdown) and one profiled eager step (the stages, by launch)."""
    stretch = closed_loop(prog, feed, seconds, device)
    n = spec.workload["profile_steps"]
    batches = [next(feed) for _ in range(PROFILE_WAIT + PROFILE_WARMUP + n + 1)]
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        replays, window_s = profiled_replays(prog, batches, n, device, tmp)
        eager = profiled_eager(prog, batches[-1], device, tmp)
    return SimpleNamespace(stretch=stretch, replays=replays, replay_steps=n,
                           window_s=window_s, eager=eager, cfg=cfg, costs=costs,
                           busy_s=replays.busy_us() / 1e6)


def read_metrics(metrics: list, result) -> dict:
    out = {}
    for m in metrics:
        value = importlib.import_module(f"benchmark.metrics.{m['name']}").read(result)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def card_state(device) -> str:
    """The card's clocks, power and temperature, for the record."""
    if device.type != "cuda":
        return "cpu"
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw,"
                          "temperature.gpu", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False)
    return out.stdout.strip()


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None, *, started: float | None = None) -> int:
    started = time.perf_counter() if started is None else started
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a CPU wiring check at tiny widths (plain versions of the kernels);
    # its numbers mean nothing and are no device metric
    ap.add_argument("--smoke", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    spec = cell_spec(args.workload)
    if args.smoke:
        device = torch.device("cpu")
        cfg = smoke_config(spec.config)
        spec.traffic = {**spec.traffic, "warm_seconds": 0.0}
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
            print(f"benchmark: the cell needs {spec.chips} CUDA device(s), found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        cfg = spec.config
    family = cfg["family"]
    stage = importlib.import_module(f"benchmark.stage.{family}")
    costs = importlib.import_module(f"benchmark.costs.{family}")
    seeds = derive_seeds(args.seed)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    prog, feed, first = first_steps(stage, cfg, spec.traffic, seeds, device)
    # steps back to back before the window: a replayed graph runs its
    # kernels with wider gaps for its first seconds (PERF.md)
    closed_loop(prog, feed, spec.traffic["warm_seconds"], device)
    setup_s = process_age_s(started)
    route = prog.route

    batch = cfg["data"]["batch_size"]
    if args.trace == 0:
        window = closed_loop(prog, feed, args.seconds, device)
        attempted, failed = window.steps, window.failed
        p5, p50, p95 = np.percentile(window.step_ms, [5, 50, 95])
        print(f"benchmark: {window.steps} steps in {window.window_s:.3f} s; step ms "
              f"min {min(window.step_ms):.3f} p5 {p5:.3f} p50 {p50:.3f} p95 {p95:.3f} "
              f"max {max(window.step_ms):.3f}; {card_state(device)}", file=sys.stderr)
    else:
        trace = traced(prog, feed, spec, cfg, costs, args.seconds, device)
        attempted, failed = trace.stretch.steps, trace.stretch.failed
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    kept = feed.kept
    del prog, feed
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    result = SimpleNamespace(batch=batch, setup_s=setup_s, peak_bytes=peak)
    if args.trace == 0:
        result.window = window
        metrics = read_metrics(spec.end_to_end, result)
    else:
        result.trace = trace
        metrics = read_metrics(spec.per_layer, result)

    from benchmark.judge import judge

    compared = judge(cfg, seeds, kept, first, spec.workload["limits"], device)
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in compared.values())
    found = forbidden_modules()
    if found:
        print(f"benchmark: modules {found} are loaded; the run may import none of "
              f"{list(FORBIDDEN)}", file=sys.stderr)
        return 3
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device_info}
    if args.trace == 1:
        device_info.update(busy_s=trace.busy_s, window_s=trace.window_s)
        line["breakdown"] = trace.replays.breakdown()
    line["route"] = route[0]
    line["compared"] = compared
    print(f"benchmark: route {route[0]}: {route[1]}", file=sys.stderr)
    for name, c in compared.items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
