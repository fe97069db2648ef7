"""Schedule-Free AdamW (Defazio et al. 2024) as a `torch.optim.Optimizer`:
the port of `basd_tpu/training/schedule_free.py`.

The stored parameters are the gradient point y; the optimizer keeps the
iterate z and the second moment, and `eval_params()` gives the averaged
evaluation point x = (y - (1 - beta1) z) / beta1. Per step t:

    gamma_t = lr * min(1, t / warmup) * sqrt(1 - beta2^t)
    c_t     = gamma_t^2 / sum_{i<=t} gamma_i^2
    v       = beta2 v + (1 - beta2) g^2
    u       = g / (sqrt(v) + eps) + weight_decay * y
    y      += c_t (z - y) + gamma_t (beta1 (1 - c_t) - 1) u   (the OLD z)
    z      -= gamma_t u

Weight decay applies to every parameter, as in the JAX package. A
parameter without a gradient takes a zero gradient.

A step has a host half and a device half. `advance` does the bookkeeping
(`step` and `weight_sum` in `param_groups`, so the state dict is the same)
and works out c_t, gamma_t and gamma_t (beta1 (1 - c_t) - 1) in float64,
then fills each into a 0-d fp32 tensor on the parameters' device. `update`
reads those tensors and nothing else that changes from step to step, so a
CUDA graph that captured it replays each step's values; a fp32 tensor
times a 0-d fp32 tensor rounds as times the Python scalar did. `step` is
`advance` then `update`.
"""

from __future__ import annotations

import torch


class ScheduleFreeAdamW(torch.optim.Optimizer):
    def __init__(
        self,
        params,
        lr: float,
        *,
        beta1: float = 0.9,
        beta2: float = 0.999,
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        warmup_steps: int = 0,
        weight_lr_power: float = 2.0,
    ):
        defaults = dict(
            lr=float(lr), beta1=beta1, beta2=beta2, eps=eps,
            weight_decay=float(weight_decay), warmup_steps=warmup_steps,
            weight_lr_power=weight_lr_power, step=0, weight_sum=0.0,
        )
        super().__init__(params, defaults)
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["z"] = p.detach().clone()
                self.state[p]["exp_avg_sq"] = torch.zeros_like(
                    p, dtype=torch.float32
                )
        # the per-step coefficients of each group, filled by `advance`
        self._coefficients = [
            {name: torch.zeros((), dtype=torch.float32,
                               device=group["params"][0].device)
             for name in ("ckp1", "gamma", "y_u")}
            for group in self.param_groups
        ]

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("ScheduleFreeAdamW takes no closure")
        self.advance()
        self.update()
        return None

    def advance(self) -> None:
        """The step's host half: the bookkeeping, and the coefficients filled
        into their device tensors (on the current stream)."""
        for group, coef in zip(self.param_groups, self._coefficients):
            group["step"] += 1
            t = group["step"]
            warm = group["warmup_steps"]
            sched = min(1.0, t / max(warm, 1)) if warm else 1.0
            beta1, beta2 = group["beta1"], group["beta2"]
            gamma = group["lr"] * sched * (1.0 - beta2**t) ** 0.5
            weight = gamma ** group["weight_lr_power"]
            group["weight_sum"] += weight
            ws = group["weight_sum"]
            ckp1 = weight / ws if ws > 0 else 0.0
            coef["ckp1"].fill_(ckp1)
            coef["gamma"].fill_(gamma)
            coef["y_u"].fill_(gamma * (beta1 * (1.0 - ckp1) - 1.0))

    @torch.no_grad()
    def update(self) -> None:
        """The step's device half, from the coefficients `advance` filled."""
        for group, coef in zip(self.param_groups, self._coefficients):
            beta2, wd = group["beta2"], group["weight_decay"]
            ckp1, gamma, y_u = coef["ckp1"], coef["gamma"], coef["y_u"]
            for p in group["params"]:
                st = self.state[p]
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                g = g.float()
                y = p.float()
                v, z = st["exp_avg_sq"], st["z"]
                v.mul_(beta2).add_((1.0 - beta2) * g * g)
                u = g / (v.sqrt() + group["eps"])
                if wd:
                    u = u + wd * y
                y_new = y + ckp1 * (z - y) + y_u * u
                z.sub_(gamma * u)
                p.copy_(y_new.to(p.dtype))

    @torch.no_grad()
    def eval_params(self) -> list[torch.Tensor]:
        """x = (y - (1 - beta1) z) / beta1 for every parameter, in order."""
        out = []
        for group in self.param_groups:
            b1 = group["beta1"]
            for p in group["params"]:
                z = self.state[p]["z"]
                out.append(((p.float() - (1.0 - b1) * z) / b1).to(p.dtype))
        return out

