"""Learning-rate schedules and the optimizer update (counterpart of
``speechain_tpu/train/optim.py``).

:func:`build_optimizer` ports the reference's update chains (:107-183).
Every chain runs over one flat float32 buffer of the gradients it owns:

- the fast path (:136-143), ``optax.flatten(_safe_clip_update(inner))``:
  the buffer's global norm as one reduction, clipping to ``grad_clip``,
  a skip when the norm is not finite (the inner state, its count
  included, and the parameters stay untouched; the skip is counted);
- the per-leaf chain that ``updated_modules`` selects (:144-181),
  ``apply_if_finite(chain(clip_by_global_norm, inner))`` under
  ``multi_transform``: optax's clip rule ``g / norm * clip`` where the
  norm reaches ``grad_clip``, a skip when any gradient is not finite, and
  both seeing only the updated parameters; frozen parameters get no
  moments and stay as they are (:class:`Grouped`);
- ``inner`` is optax's Adam, AdamW (``scale_by_adam``, then ``+
  weight_decay * p``, then ``x -lr``) or SGD (``trace(momentum)``, then
  ``x -lr``), with the Noam, exponential-decay or constant schedule;
- ``accum_grad`` > 1 wraps the chain in ``optax.MultiSteps``
  (:class:`MultiSteps`).

Everything stays on the device: skips are ``where``s, not branches on
the host; only the accumulation's call count is a host integer, as it
depends on nothing but the number of calls.

Count convention (optax's, kept on purpose): the schedule is evaluated at
the count of updates applied BEFORE this one, and Noam clamps it to
``max(count, 1)``, so updates 1 and 2 both use the step-1 rate.
``torch.optim.lr_scheduler`` would be off by one here.

An optimizer is ``init(params, names=None) -> state`` and ``update(grads,
state, params) -> state``, which applies the update to ``params`` in
place; ``names`` are the parameters' ``named_parameters`` names, which
:class:`Grouped` resolves to the reference's flax paths through the
weight bridge's naming (``utils/weights.py::flax_param_path``), so a
path prefix selects the same parameters in both packages.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from speechain_tpu_torch.utils.weights import flax_param_path

Schedule = Callable[[torch.Tensor], torch.Tensor]
OPTIMIZERS = ("Adam", "AdamW", "SGD")


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


def exp_decay_schedule(base_lr: float, decay_factor: float = 0.999,
                       steps_per_epoch: int = 1000,
                       ft_factor: float = 1.0) -> Schedule:
    """lr(step) = base_lr * decay_factor ^ (step // steps_per_epoch), the
    epoch a float32 floor division as the reference's (:39-46)."""
    factor = ft_factor * base_lr

    def schedule(step: torch.Tensor) -> torch.Tensor:
        epoch = torch.div(torch.as_tensor(step).to(torch.float32),
                          steps_per_epoch, rounding_mode="floor")
        return factor * torch.pow(decay_factor, epoch)

    return schedule


def const_schedule(lr: float, ft_factor: float = 1.0) -> Schedule:
    def schedule(step: torch.Tensor) -> torch.Tensor:
        return torch.full((), lr * ft_factor, dtype=torch.float32,
                          device=torch.as_tensor(step).device)

    return schedule


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([x.reshape(-1).float() for x in tensors])


class FlatOptimizer:
    """One update chain over a flat float32 buffer (see the module
    docstring): ``leafwise`` False is the fast path's clip and skip,
    True the per-leaf chain's."""

    def __init__(self, schedule: Schedule, optim_type: str = "Adam",
                 optim_conf: Optional[Dict[str, Any]] = None,
                 grad_clip: Optional[float] = 5.0, leafwise: bool = False):
        if optim_type not in OPTIMIZERS:
            raise KeyError(f"unknown optimizer {optim_type!r}; known: "
                           f"{OPTIMIZERS}")
        conf = dict(optim_conf or {})
        self.schedule = schedule
        self.optim_type = optim_type
        self.b1, self.b2 = conf.get("betas", (0.9, 0.999))
        self.eps = conf.get("eps", 1e-8)
        self.weight_decay = conf.get("weight_decay", 1e-2)
        self.momentum = conf.get("momentum", 0.0)
        self.grad_clip = grad_clip
        self.leafwise = leafwise

    def init(self, params: Sequence[torch.Tensor],
             names: Optional[Sequence[str]] = None) -> Dict[str, Any]:
        n = sum(p.numel() for p in params)
        dev = params[0].device

        def zeros():
            return torch.zeros(n, dtype=torch.float32, device=dev)
        state = dict(count=torch.zeros((), dtype=torch.int32, device=dev),
                     notfinite=torch.zeros((), dtype=torch.int32,
                                           device=dev))
        if self.optim_type == "SGD":
            state["trace"] = zeros()
        else:
            state["mu"], state["nu"] = zeros(), zeros()
        return state

    def update(self, grads: Sequence[torch.Tensor], state: Dict[str, Any],
               params: Sequence[torch.Tensor]) -> Dict[str, Any]:
        return self.update_flat(_flat(grads), state, params)

    @torch.no_grad()
    def update_flat(self, g: torch.Tensor, state: Dict[str, Any],
                    params: Sequence[torch.Tensor]) -> Dict[str, Any]:
        clip = self.grad_clip
        if self.leafwise:
            finite = torch.isfinite(g).all()
            if clip is not None:
                gnorm = torch.sqrt((g * g).sum())
                g = torch.where(gnorm < clip, g, g / gnorm * clip)
        else:
            gnorm = torch.sqrt((g * g).sum())
            finite = torch.isfinite(gnorm)
            scale = (torch.clamp(clip / torch.clamp(gnorm, min=1e-12),
                                 max=1.0) if clip is not None
                     else torch.ones_like(gnorm))
            g = g * torch.where(finite, scale, torch.zeros_like(scale))
        count = state["count"]
        count_inc = count + 1
        new = dict(count=torch.where(finite, count_inc, count),
                   notfinite=state["notfinite"] + (~finite).to(torch.int32))
        if self.optim_type == "SGD":
            u = g + self.momentum * state["trace"]
            new["trace"] = torch.where(finite, u, state["trace"])
        else:
            mu = (1.0 - self.b1) * g + self.b1 * state["mu"]
            nu = (1.0 - self.b2) * (g * g) + self.b2 * state["nu"]
            c = count_inc.to(torch.float32)
            mu_hat = mu / (1.0 - self.b1 ** c)
            nu_hat = nu / (1.0 - self.b2 ** c)
            u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
            if self.optim_type == "AdamW":
                u = u + self.weight_decay * _flat(params)
            new["mu"] = torch.where(finite, mu, state["mu"])
            new["nu"] = torch.where(finite, nu, state["nu"])
        u = -self.schedule(count) * u
        u = torch.where(finite, u, torch.zeros_like(u))
        offset = 0
        for p in params:
            n = p.numel()
            p.add_(u[offset:offset + n].view_as(p).to(p.dtype))
            offset += n
        return new


class MultiSteps:
    """``optax.MultiSteps(inner, every_k_schedule=k)`` (optax 0.2.6): the
    gradients' running mean ``acc + (g - acc) / (n + 1)`` over k calls;
    the k-th call runs the inner update on it, counts a gradient step and
    resets the mean as optax does, ``0 * acc`` (so a nonfinite gradient
    leaves NaN in the mean, and the inner chain skips every later update,
    as the reference's does); the other calls leave the parameters and
    the inner state untouched."""

    def __init__(self, inner: FlatOptimizer, k: int):
        self.inner, self.k = inner, int(k)

    def init(self, params: Sequence[torch.Tensor],
             names: Optional[Sequence[str]] = None) -> Dict[str, Any]:
        n = sum(p.numel() for p in params)
        dev = params[0].device
        return dict(mini_step=0, gradient_step=torch.zeros(
                        (), dtype=torch.int32, device=dev),
                    acc=torch.zeros(n, dtype=torch.float32, device=dev),
                    inner=self.inner.init(params, names))

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: Dict[str, Any],
               params: Sequence[torch.Tensor]) -> Dict[str, Any]:
        n = state["mini_step"]
        acc = state["acc"]
        acc.add_((_flat(grads) - acc) / float(n + 1))
        state = dict(state, mini_step=(n + 1) % self.k)
        if n == self.k - 1:
            state["inner"] = self.inner.update_flat(acc, state["inner"],
                                                    params)
            state["gradient_step"] = state["gradient_step"] + 1
            acc.mul_(0.0)
        return state


def claims(path: str, prefixes: Sequence[str]) -> bool:
    """The reference's label rule (:153-159): a flax path ``a/b/c`` is
    claimed by a prefix it starts with, or that it holds as a run of
    whole segments."""
    return any(path.startswith(m) or ("/" + m + "/") in ("/" + path + "/")
               for m in prefixes)


class Grouped:
    """``optax.multi_transform`` over named groups (:170-181, :214-239):
    each parameter goes to the group whose prefixes claim its flax path
    (two claims raise), an unclaimed one to the first group without
    prefixes, else it is frozen (no state, never updated). Each group's
    chain sees only its own parameters."""

    def __init__(self, txs: Dict[str, Any],
                 owned: Dict[str, Optional[Sequence[str]]]):
        self.txs, self.owned = txs, owned

    def labels(self, params: Sequence[torch.Tensor],
               names: Sequence[str]) -> List[Optional[str]]:
        """Each parameter's group, None for frozen."""
        fallback = [n for n in self.txs if self.owned.get(n) is None]
        out = []
        for name, p in zip(names, params):
            path = "/".join(flax_param_path(name, p.ndim))
            hit = None
            for group, mods in self.owned.items():
                if mods is None or not claims(path, mods):
                    continue
                if hit is not None:
                    raise ValueError(
                        f"parameter {path} claimed by both {hit} and "
                        f"{group} (overlapping updated_modules)")
                hit = group
            out.append(hit if hit is not None else
                       (fallback[0] if fallback else None))
        return out

    def init(self, params: Sequence[torch.Tensor],
             names: Optional[Sequence[str]] = None) -> Dict[str, Any]:
        if names is None:
            raise ValueError("updated_modules and optimizer groups select "
                             "parameters by name: pass names to init")
        labels = self.labels(params, names)
        state = {}
        for group, tx in self.txs.items():
            idx = [i for i, g in enumerate(labels) if g == group]
            if idx:
                state[group] = dict(index=idx, inner=tx.init(
                    [params[i] for i in idx], [names[i] for i in idx]))
        return state

    def update(self, grads: Sequence[torch.Tensor], state: Dict[str, Any],
               params: Sequence[torch.Tensor]) -> Dict[str, Any]:
        new = {}
        for group, st in state.items():
            idx = st["index"]
            new[group] = dict(index=idx, inner=self.txs[group].update(
                [grads[i] for i in idx], st["inner"],
                [params[i] for i in idx]))
        return new


def build_optimizer(sche_type: str = "noam", optim_type: str = "Adam",
                    optim_conf: Optional[Dict[str, Any]] = None,
                    warmup_steps: int = 4000, d_model: Optional[int] = None,
                    decay_factor: float = 0.999, steps_per_epoch: int = 1000,
                    accum_grad: int = 1, grad_clip: Optional[float] = 5.0,
                    ft_factor: float = 1.0,
                    updated_modules: Optional[Sequence[str]] = None,
                    flatten: bool = True):
    """The update chain of one optimizer group (reference :107-183).
    ``flatten=False`` (the per-leaf moments FSDP shards) is not ported."""
    if not flatten:
        raise NotImplementedError("flatten=False (per-leaf optimizer state "
                                  "for FSDP) is not ported")
    optim_conf = dict(optim_conf or {})
    peak_lr = float(optim_conf.pop("lr", 2e-3))
    if sche_type in ("noam", "noam.Noamlr"):
        schedule = noam_schedule(peak_lr, warmup_steps, d_model, ft_factor)
    elif sche_type in ("exp", "exp.ExponentDecayLr"):
        schedule = exp_decay_schedule(peak_lr, decay_factor,
                                      steps_per_epoch, ft_factor)
    elif sche_type == "const":
        schedule = const_schedule(peak_lr, ft_factor)
    else:
        raise ValueError(f"unknown scheduler {sche_type!r}")
    tx = FlatOptimizer(schedule, optim_type, optim_conf, grad_clip,
                       leafwise=updated_modules is not None)
    if accum_grad > 1:
        tx = MultiSteps(tx, accum_grad)
    if updated_modules:
        tx = Grouped({"update": tx}, {"update": list(updated_modules)})
    return tx


def build_optimizers(optim_sches_cfg: Dict[str, Any], *,
                     steps_per_epoch: int = 1000, accum_grad: int = 1,
                     grad_clip: Optional[float] = 5.0,
                     ft_factor: float = 1.0, flatten: bool = True):
    """The reference's config entry (:186-239): a single {type, conf} or
    a dict of named ones, each owning a disjoint ``updated_modules``
    subset; in the multi case each group is its own fast path over its
    parameters."""
    if "type" in optim_sches_cfg:
        optim_sches_cfg = {"main": optim_sches_cfg}
    txs: Dict[str, Any] = {}
    owned: Dict[str, Optional[List[str]]] = {}
    for name, spec in optim_sches_cfg.items():
        conf = dict(spec.get("conf", {}))
        owned[name] = conf.pop("updated_modules", None)
        txs[name] = build_optimizer(
            sche_type=spec.get("type", "noam"),
            optim_type=conf.pop("optim_type", "Adam"),
            optim_conf=conf.pop("optim_conf", {}),
            warmup_steps=conf.pop("warmup_steps", 4000),
            d_model=conf.pop("d_model", None),
            decay_factor=conf.pop("decay_factor", 0.999),
            steps_per_epoch=steps_per_epoch,
            accum_grad=conf.pop("accum_grad", accum_grad),
            grad_clip=conf.pop("grad_clip", grad_clip),
            ft_factor=conf.pop("ft_factor", ft_factor),
            updated_modules=(owned[name] if len(optim_sches_cfg) == 1
                             else None),
            flatten=flatten)
    if len(txs) == 1:
        return next(iter(txs.values()))
    return Grouped(txs, owned)
