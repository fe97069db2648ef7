"""The frozen FLOP counts of `benchmark/costs/` against
`torch.utils.flop_counter` on the plain reference, at small sizes."""

from __future__ import annotations

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.costs import basd_vit as costs, h100
from benchmark.reference import basd_vit as ref
from benchmark.reference.vit import vit_forward
from benchmark.weights import make_weights

VIT = dict(img_size=16, patch_size=4, embed_dim=32, depth=2, num_heads=2, mlp_ratio=4.0)


def counted(fn) -> int:
    with FlopCounterMode(display=False) as mode:
        fn()
    return mode.get_total_flops()


@pytest.mark.parametrize("classes", [0, 10])
def test_vit_forward(classes):
    w = make_weights({**VIT, "num_classes": classes}, 0, "cpu")
    x = torch.rand(3, 16, 16, 3)
    got = counted(lambda: vit_forward(w, x, patch_size=4, depth=2, heads=2, capture=(0, 1),
                                      head=classes > 0))
    assert got == costs.vit_forward_flops(3, 16, 4, 32, 2, 2, 4.0, classes)


def test_vit_forward_and_backward():
    w = {n: t.requires_grad_(True) for n, t in
         make_weights({**VIT, "num_classes": 10}, 0, "cpu").items()}
    x = torch.rand(3, 16, 16, 3)

    def step():
        logits, tokens, _ = vit_forward(w, x, patch_size=4, depth=2, heads=2, capture=(1,))
        (logits.sum() + tokens.sum()).backward()

    assert counted(step) == costs.vit_train_flops(3, 16, 4, 32, 2, 2, 4.0, 10)


@pytest.mark.parametrize("n_s, n_t", [(16, 4), (9, 9)])
def test_selector_and_procrustes_forward_and_backward(n_s, n_t):
    b, p, l, d_s, d_t, k = 3, 2, 3, 24, 40, 8
    g = torch.Generator().manual_seed(0)
    s_tok = torch.randn(p, b, n_s, d_s, generator=g, requires_grad=True)
    t_tok = torch.randn(l, b, n_t, d_t, generator=g)
    t_imp = torch.rand(l, b, n_t, generator=g)
    log_t, proj_s, proj_t = ref.selector_projections(1, p, d_s, d_t)
    log_t.requires_grad_(True)

    def step():
        mixed, mixed_imp, *_ = ref.select_and_mix(log_t, proj_s, proj_t, s_tok, t_tok, t_imp, k)
        geo = torch.stack([ref.procrustes_mixed(s_tok[j], mixed[j], mixed_imp[j])
                           for j in range(p)]).mean()
        geo.backward()

    assert counted(step) == costs.selector_flops(b, p, l, n_s, n_t, d_s, d_t, k)


CFG = {"student": {"img_size": 224, "patch_size": 16, "embed_dim": 384, "depth": 12,
                   "num_heads": 6, "mlp_ratio": 4.0, "num_classes": 1000},
       "teacher": {"patch_size": 14, "embed_dim": 1024, "depth": 24, "num_heads": 16,
                   "mlp_ratio": 4.0},
       "data": {"batch_size": 256}, "basd": {"num_extraction_points": 4, "subspace_k": None},
       "hardware": {"precision": "bfloat16", "remat": True}}


def test_step_count_at_table1_shapes():
    # ViT-L/14 on 257 tokens: 2 * 303M parameters * 257 tokens per image,
    # plus the scores; ViT-S/16 three times on 197 tokens
    flops = costs.step_flops(CFG)
    assert 50e12 < flops < 56e12
    assert costs.selector_k(CFG) == 96


def test_attention_bound():
    calls = costs.attention_calls(CFG, backward=False)
    # the teacher's forwards and remat's first student forwards write no
    # softmax statistics; the recomputation, which the backward reads, does
    assert calls.count((256, 257, 16, 64, False)) == 24
    assert calls.count((256, 197, 6, 64, False)) == 12
    assert calls.count((256, 197, 6, 64, True)) == 12
    assert costs.attention_calls(CFG, backward=True) == [(256, 197, 6, 64, True)] * 12
    b, n, h, hd = 256, 257, 16, 64
    by_flops = 4 * b * h * n * n * hd / h100.BF16_FLOPS
    teacher = dict(CFG, hardware={"precision": "bfloat16", "remat": False},
                   student=dict(CFG["student"], depth=0), teacher=dict(CFG["teacher"], depth=1))
    by_bytes = 4 * b * n * h * hd * 2 / h100.HBM_BYTES_PER_S
    assert math.isclose(costs.attention_bound_s(teacher, backward=False),
                        max(by_bytes, by_flops))
    b, n, h, hd = 256, 197, 6, 64
    student = dict(CFG, hardware={"precision": "bfloat16", "remat": False},
                   student=dict(CFG["student"], depth=1), teacher=dict(CFG["teacher"], depth=0))
    by_bytes = (4 * b * n * h * hd * 2 + 2 * b * n * h * 4) / h100.HBM_BYTES_PER_S
    by_flops = 4 * b * h * n * n * hd / h100.BF16_FLOPS
    assert math.isclose(costs.attention_bound_s(student, backward=False),
                        max(by_bytes, by_flops))
