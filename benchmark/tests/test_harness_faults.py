"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped (`--smoke`, on the CPU), everything else
as a run drives it. The faults a one-chip training cell can have: a step
that leaves the state unchanged, and half of the batch left out with the
mean taken over the rest. (No exchange between chips runs in a one-chip
cell, and a training step produces no tokens or answers.) Besides, two
faults of the selector, which the loss, the gradients and the update may
not show: every principal-angle distance 0, and every MP rank one short."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]

FAULTS = {
    # the optimizer's device half does nothing: the state stays as it was
    "state_unchanged": """
from basd_tpu_torch.training import schedule_free
schedule_free.ScheduleFreeAdamW.update = lambda self: None
""",
    # the loss over the first half of the batch, its mean over those rows
    "half_batch": """
from basd_tpu_torch.training import train_step
whole = train_step.basd_loss
def half(selector, logits, targets, s_tok, t_tok, t_imp, **kw):
    h = logits.shape[0] // 2
    return whole(selector, logits[:h], targets[:h], s_tok[:, :h], t_tok[:, :h],
                 t_imp[:, :h], **kw)
train_step.basd_loss = half
""",
    # the selector mixes the teacher's layers evenly, whatever their distance
    "flat_selector": """
import torch
from basd_tpu_torch.losses import selector
selector.masked_principal_angle_distance = (
    lambda basis_s, basis_t, *a, **kw: torch.zeros(basis_s.shape[0], basis_t.shape[1],
                                                   device=basis_s.device))
""",
    # every teacher layer's MP rank one short
    "mp_rank_short": """
from basd_tpu_torch.losses import selector
rank = selector.marchenko_pastur_rank_gram
selector.marchenko_pastur_rank_gram = lambda *a, **kw: rank(*a, **kw) - 1
""",
}

RUN = """
import sys
sys.path.insert(0, {root!r})
{fault}
from benchmark.harness import main
sys.exit(main({argv!r}))
"""


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_step_is_not_correct(cell, fault):
    argv = ["--workload", cell, "--seed", "3000000021", "--seconds", "1", "--trace", "0",
            "--smoke"]
    code = RUN.format(root=str(ROOT), fault=FAULTS[fault], argv=argv)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is False, line["compared"]
