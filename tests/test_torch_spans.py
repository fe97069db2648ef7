"""The train step's spans (`utils/spans.py`) on the CPU, where a stamp is
`perf_counter_ns` in op order: each step's spans, their parents and step
index; the host spans of the input path and the launch; the ring's wrap;
nothing recorded while spans are off; and the `torch.profiler` ranges of a
step unchanged (the stamps-only spans open none)."""

import json

import numpy as np
import pytest
import torch

from basd_tpu_torch.data.pipeline import prefetch_to_device
from basd_tpu_torch.losses import extraction_points, init_selector
from basd_tpu_torch.models import create_student, load_teacher
from basd_tpu_torch.training import train_step as ttrain
from basd_tpu_torch.utils import spans as tspans

torch.set_num_threads(1)
CPU = torch.device("cpu")
B, IMG, RAW, C = 4, 16, 20, 10
STAGES = ("basd:teacher", "basd:student_forward", "basd:loss", "basd:backward",
          "basd:optimizer")


def small_step(augment: bool):
    teacher = load_teacher("vit_mini_patch4", img_size=IMG, dtype=torch.float32, device=CPU)
    student, cfg = create_student(
        "vit_micro_patch4", num_classes=C, drop_path_rate=0.0, img_size=IMG,
        capture_layers=extraction_points(4, 2), dtype=torch.float32, device=CPU)
    init_fn, step = ttrain.make_train_step(
        student, teacher, learning_rate=1e-3, weight_decay=0.05, warmup_steps=5,
        label_smoothing=0.1, img_size=IMG, crop_ratio=IMG / RAW,
        teacher_stats=((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
        dataset_stats=((0.507, 0.487, 0.441), (0.267, 0.256, 0.276)),
        num_classes=C, augment=augment)
    selector = init_selector(1, 2, cfg.embed_dim, teacher.spec.embed_dim, device=CPU)
    return step, init_fn(0, selector)


def host_batches(n: int):
    rng = np.random.default_rng(7)
    for _ in range(n):
        yield (rng.integers(0, 256, (B, RAW, RAW, 3), dtype=np.uint8),
               rng.integers(0, C, B, dtype=np.int64))


def run(step, state, n: int):
    for images, labels in prefetch_to_device(host_batches(n), device=CPU, spans=step.spans):
        state, _ = step(state, images, labels)
    return state


@pytest.mark.parametrize("augment", [True, False])
def test_step_spans_order_parents_and_ids(augment):
    step, state = small_step(augment)
    run(step, state, 1)  # before on(): counted, not recorded
    step.spans.on()
    run(step, state, 3)
    records = step.spans.read()
    first = "basd:augment" if augment else "basd:views"
    want = {tspans.STEP, first, *STAGES, "select", "procrustes", tspans.LAUNCH}
    by_step = {}
    for r in records:
        by_step.setdefault(r.step, {})[r.name] = r
    # the launches and the device spans of steps 1-3; batches 1-3 of the
    # second iterator (its prefetch produced them before step 1 ran)
    assert sorted(by_step) == [1, 2, 3]
    inputs = [r for r in records if r.name == tspans.INPUT]
    assert [r.step for r in inputs] == [1, 2, 3]
    for i, spans in by_step.items():
        assert set(spans) == want | {tspans.INPUT}
        step_span, launch = spans[tspans.STEP], spans[tspans.LAUNCH]
        assert step_span.parent is None and launch.parent is None
        assert launch.start <= step_span.start <= step_span.end <= launch.end
        assert spans[tspans.INPUT].end <= launch.start
        chain = [spans[n] for n in (first, *STAGES)]
        assert chain[0].start == step_span.start
        for a, b in zip(chain, chain[1:]):
            assert a.end == b.start  # adjacent spans share a boundary
        assert chain[-1].end <= step_span.end
        for s in chain:
            assert s.parent == tspans.STEP and s.start <= s.end
        loss, select, procrustes = spans["basd:loss"], spans["select"], spans["procrustes"]
        assert select.parent == procrustes.parent == "basd:loss"
        assert loss.start <= select.start <= select.end == procrustes.start
        assert procrustes.end == loss.end
    assert step.spans.launched == 4 and state.step == 4


def test_the_ring_keeps_the_last_steps(monkeypatch):
    monkeypatch.setattr(tspans, "STEPS", 8)
    rec = tspans.SpanRecorder(CPU)
    rec.on()
    for _ in range(8 + 5):
        with rec.span(tspans.STEP):
            with rec.span("basd:teacher"):
                pass
        with rec.launch_span():
            pass
    device = [r for r in rec.read() if r.name == tspans.STEP]
    assert [r.step for r in device] == list(range(5, 13))
    assert rec.slot == 13 and rec.layout == {
        tspans.STEP: (None, 0, 9), "basd:teacher": (tspans.STEP, 1, 2)}
    # the host ring keeps 2 x STEPS spans
    assert [r.step for r in rec.read() if r.name == tspans.LAUNCH] == list(range(13))


def test_spans_off_record_nothing():
    step, state = small_step(True)
    run(step, state, 2)
    assert step.spans.read() == [] and not step.spans.ring.any()
    step.spans.on()
    step.spans.off()
    run(step, state, 2)
    assert step.spans.read() == [] and not step.spans.ring.any()
    assert step.spans.launched == step.spans.produced == 4


def test_profiler_ranges_of_a_step_are_the_stages(tmp_path):
    """A profiled step holds the `basd:*` ranges it always held and the two
    host spans' ranges; `step`, `select` and `procrustes` open none."""
    from torch.profiler import ProfilerActivity, profile

    step, state = small_step(True)
    run(step, state, 1)
    step.spans.on()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(step, state, 1)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {n for n in names if n.startswith("basd:")} == {"basd:augment", *STAGES}
    assert {tspans.LAUNCH, tspans.INPUT} <= names
    assert not names & {tspans.STEP, "select", "procrustes"}


def test_a_train_step_made_without_a_recorder_has_a_cpu_one():
    step = ttrain.TrainStep(body=None, route_for=None)
    assert step.spans.device == CPU and not step.spans.enabled
