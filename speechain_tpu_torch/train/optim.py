"""Learning-rate schedules and the optimizer update (counterpart of
``speechain_tpu/train/optim.py``).

:func:`build_optimizer` ports the reference's flat fast path (:107-146):
one float32 buffer of all gradients, its global norm as one reduction,
clipping to ``grad_clip``, a skip when the norm is not finite (the inner
state, its count included, and the parameters stay untouched; the skip is
counted), then optax's Adam (:49-53) with the schedule. Everything stays
on the device: the skip is a ``where``, not a branch on the host.

Count convention (optax's, kept on purpose): the schedule is evaluated at
the count of updates applied BEFORE this one, and Noam clamps it to
``max(count, 1)``, so updates 1 and 2 both use the step-1 rate.
``torch.optim.lr_scheduler`` would be off by one here.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]


def noam_schedule(peak_lr: float = 2e-3, warmup_steps: int = 4000,
                  d_model: Optional[int] = None,
                  ft_factor: float = 1.0) -> Schedule:
    """lr(step) = init_lr * min(step^-0.5, step * warmup^-1.5), step
    clamped to >= 1; init_lr = d_model^-0.5, else peak_lr * warmup^0.5
    (the rate peaks at peak_lr after warmup)."""
    init_lr = (d_model ** -0.5 if d_model is not None
               else peak_lr * warmup_steps ** 0.5)
    factor = ft_factor * init_lr

    def schedule(step: torch.Tensor) -> torch.Tensor:
        s = torch.clamp(torch.as_tensor(step).to(torch.float32), min=1.0)
        return factor * torch.minimum(s ** -0.5, s * warmup_steps ** -1.5)

    return schedule


def const_schedule(lr: float, ft_factor: float = 1.0) -> Schedule:
    def schedule(step: torch.Tensor) -> torch.Tensor:
        return torch.full((), lr * ft_factor, dtype=torch.float32,
                          device=torch.as_tensor(step).device)

    return schedule


class FlatAdam:
    """Adam over one flat float32 buffer with global-norm clipping and the
    nonfinite skip (``optax.flatten(_safe_clip_update(adam))``).

    ``init(params)`` -> state; ``update(grads, state, params)`` applies the
    update to ``params`` in place and returns the new state."""

    def __init__(self, schedule: Schedule, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 grad_clip: Optional[float] = 5.0):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.grad_clip = grad_clip

    def init(self, params: Sequence[torch.Tensor]) -> Dict[str, Any]:
        n = sum(p.numel() for p in params)
        dev = params[0].device
        return dict(count=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=torch.zeros(n, dtype=torch.float32, device=dev),
                    nu=torch.zeros(n, dtype=torch.float32, device=dev),
                    notfinite=torch.zeros((), dtype=torch.int32, device=dev))

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: Dict[str, Any],
               params: Sequence[torch.Tensor]) -> Dict[str, Any]:
        g = torch.cat([x.reshape(-1).float() for x in grads])
        gnorm = torch.sqrt((g * g).sum())
        finite = torch.isfinite(gnorm)
        if self.grad_clip is not None:
            clip = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-12),
                               max=1.0)
        else:
            clip = torch.ones_like(gnorm)
        g = g * torch.where(finite, clip, torch.zeros_like(clip))
        count = state["count"]
        mu = (1.0 - self.b1) * g + self.b1 * state["mu"]
        nu = (1.0 - self.b2) * (g * g) + self.b2 * state["nu"]
        count_inc = count + 1
        c = count_inc.to(torch.float32)
        mu_hat = mu / (1.0 - self.b1 ** c)
        nu_hat = nu / (1.0 - self.b2 ** c)
        step = -self.schedule(count)
        u = step * (mu_hat / (torch.sqrt(nu_hat) + self.eps))
        u = torch.where(finite, u, torch.zeros_like(u))
        offset = 0
        for p in params:
            n = p.numel()
            p.add_(u[offset:offset + n].view_as(p).to(p.dtype))
            offset += n
        return dict(count=torch.where(finite, count_inc, count),
                    mu=torch.where(finite, mu, state["mu"]),
                    nu=torch.where(finite, nu, state["nu"]),
                    notfinite=state["notfinite"] + (~finite).to(torch.int32))


def build_optimizer(sche_type: str = "noam", optim_type: str = "Adam",
                    optim_conf: Optional[Dict[str, Any]] = None,
                    warmup_steps: int = 4000, d_model: Optional[int] = None,
                    accum_grad: int = 1, grad_clip: Optional[float] = 5.0,
                    ft_factor: float = 1.0,
                    updated_modules: Optional[List[str]] = None) -> FlatAdam:
    """The update chain of one optimizer group, flat path only: the Noam
    or constant schedule, Adam, no gradient accumulation, every parameter
    updated (anything else raises)."""
    optim_conf = dict(optim_conf or {})
    peak_lr = float(optim_conf.pop("lr", 2e-3))
    if sche_type in ("noam", "noam.Noamlr"):
        schedule = noam_schedule(peak_lr, warmup_steps, d_model, ft_factor)
    elif sche_type == "const":
        schedule = const_schedule(peak_lr, ft_factor)
    else:
        raise NotImplementedError(f"scheduler {sche_type!r} is not ported")
    if optim_type != "Adam" or accum_grad != 1 or updated_modules:
        raise NotImplementedError(
            "only Adam over all parameters without gradient accumulation is "
            "ported")
    b1, b2 = optim_conf.get("betas", (0.9, 0.999))
    return FlatAdam(schedule, b1, b2, optim_conf.get("eps", 1e-8), grad_clip)
