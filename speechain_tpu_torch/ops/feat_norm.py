"""Feature normalization with running statistics.

Counterpart of ``speechain_tpu/ops/feat_norm.py``. :class:`FeatNormConfig`
and :class:`NormStats` are copies; :func:`apply_feat_norm` ports both
branches: per-utterance and per-batch statistics (``utterance`` /
``batch``) and the running ``global`` / ``group`` statistics with the
unseen-group fallback to ``aver_mean`` / ``aver_std`` (reference
``module/norm/feat_norm.py:510-531``). In training (``train=True``,
feat_norm.py:159-195) the running statistics move first, while ``epoch``
is at most ``max_epoch_num``: a group's first update replaces its
statistics, later ones average with weight 1 / (updates so far);
zero-length rows are left out. The output is then normalized with the
just-updated statistics. The port updates the ``NormStats`` tensors in
place (they are the frontend's buffers), where the reference returns new
ones; a single device has no ``psum`` to make.

Per-utterance std is the unbiased (n-1) estimator over valid frames,
clamped from below, as in the reference.

:func:`recover_feat_norm` is the inverse for inference outputs (reference
feat_norm.py:212, the JAX package's ``FeatNormModule.recover``,
``ops/_feat_norm_module.py:36``); :class:`FeatNormModule` owns a
:class:`NormStats` as buffers ``stats.<field>``, as that flax module owns
its ``norm_stats`` collection.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class FeatNormConfig:
    norm_type: str = "global"          # utterance | batch | group | global
    mean_norm: bool = True
    std_norm: bool = True
    clamp: float = 1e-10
    max_epoch_num: int = 4
    num_groups: int = 1                # declared group vocabulary size
    feat_dim: int = 80


class NormStats(NamedTuple):
    """Running statistics. Shapes: (G, D), (G, D), (G,), (G,), (D,), (D,)."""

    mean: torch.Tensor
    std: torch.Tensor
    batch: torch.Tensor
    seen: torch.Tensor       # bool: group has received at least one update
    aver_mean: torch.Tensor  # average over seen groups (fallback)
    aver_std: torch.Tensor


def init_stats(cfg: FeatNormConfig, device=None) -> NormStats:
    G, D = cfg.num_groups, cfg.feat_dim
    f32 = dict(dtype=torch.float32, device=device)
    return NormStats(
        mean=torch.zeros(G, D, **f32), std=torch.ones(G, D, **f32),
        batch=torch.zeros(G, **f32),
        seen=torch.zeros(G, dtype=torch.bool, device=device),
        aver_mean=torch.zeros(D, **f32), aver_std=torch.ones(D, **f32))


def per_utt_stats(feat: torch.Tensor, feat_len: torch.Tensor, clamp: float):
    """Per-utterance mean/std over valid frames. feat (B, T, D)."""
    T = feat.shape[1]
    pos = torch.arange(T, device=feat.device)[None, :, None]
    valid = (pos < feat_len[:, None, None]).to(torch.float32)
    n = torch.clamp(feat_len.to(torch.float32), min=1.0)[:, None]
    mean = (feat * valid).sum(1) / n                            # (B, D)
    sq = (((feat - mean[:, None, :]) ** 2) * valid).sum(1)
    std = torch.sqrt(sq / torch.clamp(n - 1.0, min=1.0))        # unbiased
    return mean, torch.clamp(std, min=clamp)


@torch.no_grad()
def update_stats(stats: NormStats, mean_b: torch.Tensor, std_b: torch.Tensor,
                 feat_len: torch.Tensor, cfg: FeatNormConfig, epoch,
                 group_ids: torch.Tensor) -> None:
    """One training update of the running statistics, in place
    (reference ops/feat_norm.py:160-195)."""
    validf = (feat_len > 0).to(torch.float32)
    dev = mean_b.device
    do_update = (torch.ones((), dtype=torch.bool, device=dev) if epoch is None
                 else torch.as_tensor(epoch, device=dev) <= cfg.max_epoch_num)
    groups = torch.arange(cfg.num_groups, device=dev)
    onehot = ((group_ids[:, None] == groups).to(torch.float32)
              * validf[:, None])
    cnt = onehot.sum(0)                                          # (G,)
    g_mean = (onehot.t() @ mean_b) / torch.clamp(cnt, min=1.0)[:, None]
    g_std = (onehot.t() @ std_b) / torch.clamp(cnt, min=1.0)[:, None]
    upd = do_update & (cnt > 0)
    new_batch = torch.where(upd, stats.batch + 1.0, stats.batch)
    w = torch.where(new_batch > 0, 1.0 / torch.clamp(new_batch, min=1.0),
                    torch.ones_like(new_batch))[:, None]
    first = (~stats.seen)[:, None]
    new_mean = torch.where(
        upd[:, None],
        torch.where(first, g_mean, w * g_mean + (1.0 - w) * stats.mean),
        stats.mean)
    new_std = torch.where(
        upd[:, None],
        torch.where(first, g_std, w * g_std + (1.0 - w) * stats.std),
        stats.std)
    new_seen = stats.seen | upd
    n_seen = torch.clamp(new_seen.to(torch.float32).sum(), min=1.0)
    seen_f = new_seen.to(torch.float32)[:, None]
    aver_mean = torch.where(do_update, (new_mean * seen_f).sum(0) / n_seen,
                            stats.aver_mean)
    aver_std = torch.where(do_update, (new_std * seen_f).sum(0) / n_seen,
                           stats.aver_std)
    for old, new in zip(stats, (new_mean, new_std, new_batch, new_seen,
                                aver_mean, aver_std)):
        old.copy_(new)


def apply_feat_norm(stats: Optional[NormStats], feat: torch.Tensor,
                    feat_len: torch.Tensor, cfg: FeatNormConfig, *,
                    group_ids: Optional[torch.Tensor] = None,
                    train: bool = False, epoch=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalize ``feat`` (B, T, D) or (B, T); in training update the
    running ``stats`` in place first (see the module docstring).

    group_ids: (B,) int indices into the declared group vocabulary, or None
    (group 0); epoch: int or 0-d tensor, or None (always update). Returns
    (feat, feat_len)."""
    squeeze = feat.ndim == 2
    if squeeze:
        feat = feat[..., None]

    if cfg.norm_type in ("utterance", "batch"):
        mean_b, std_b = per_utt_stats(feat, feat_len, cfg.clamp)
        if train and cfg.norm_type == "batch":
            # one set of moments for the batch, zero-length rows left out
            validf = (feat_len > 0).to(torch.float32)[:, None]
            bsz = torch.clamp(validf.sum(), min=1.0)
            mean_b = ((mean_b * validf).sum(0) / bsz).expand_as(mean_b)
            std_b = ((std_b * validf).sum(0) / bsz).expand_as(std_b)
        out = feat
        if cfg.mean_norm:
            out = out - mean_b[:, None, :]
        if cfg.std_norm:
            out = out / std_b[:, None, :]
        return (out[..., 0] if squeeze else out), feat_len

    if cfg.norm_type not in ("global", "group"):
        raise ValueError(f"unknown norm_type {cfg.norm_type!r}")
    if stats is None:
        raise ValueError("global/group norm requires a NormStats state")
    if group_ids is None:
        group_ids = torch.zeros(feat.shape[0], dtype=torch.long,
                                device=feat.device)
    group_ids = group_ids.long()
    if train:
        mean_b, std_b = per_utt_stats(feat, feat_len, cfg.clamp)
        update_stats(stats, mean_b, std_b, feat_len, cfg, epoch, group_ids)
    # ids past the declared groups left the update above (an all-zero
    # one-hot row) and read the last group, as the reference's clamped
    # gather does
    sel = group_ids.clamp(0, cfg.num_groups - 1)
    seen_sel = stats.seen[sel][:, None]                          # (B, 1)
    use_mean = torch.where(seen_sel, stats.mean[sel],
                           stats.aver_mean[None, :])
    use_std = torch.where(seen_sel, stats.std[sel],
                          stats.aver_std[None, :])
    out = feat
    if cfg.mean_norm:
        out = out - use_mean[:, None, :]
    if cfg.std_norm:
        out = out / use_std[:, None, :]
    return (out[..., 0] if squeeze else out), feat_len


def recover_feat_norm(stats: NormStats, feat: torch.Tensor,
                      cfg: FeatNormConfig,
                      group_ids: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Undo ``global`` / ``group`` normalization of ``feat`` (B, T, D):
    times the group's std, plus its mean (unseen groups: the all-group
    averages). Utterance- or batch-normalized features cannot be
    recovered."""
    if cfg.norm_type not in ("global", "group"):
        raise ValueError("utterance/batch-normalized features cannot be "
                         "recovered")
    if group_ids is None:
        group_ids = torch.zeros(feat.shape[0], dtype=torch.long,
                                device=feat.device)
    sel = group_ids.long().clamp(0, cfg.num_groups - 1)
    seen_sel = stats.seen[sel][:, None]
    use_mean = torch.where(seen_sel, stats.mean[sel],
                           stats.aver_mean[None, :])
    use_std = torch.where(seen_sel, stats.std[sel],
                          stats.aver_std[None, :])
    out = feat
    if cfg.std_norm:
        out = out * use_std[:, None, :]
    if cfg.mean_norm:
        out = out + use_mean[:, None, :]
    return out


class FeatNormModule(nn.Module):
    """Feature normalization with its running statistics as buffers
    ``stats.<field>``: ``forward`` normalizes (updating the statistics
    first in training mode), :meth:`recover` undoes it."""

    def __init__(self, cfg: FeatNormConfig):
        super().__init__()
        self.cfg = cfg
        self.stats = nn.Module()
        for name, value in init_stats(cfg)._asdict().items():
            self.stats.register_buffer(name, value)

    def norm_stats(self) -> NormStats:
        return NormStats(*(getattr(self.stats, f)
                           for f in NormStats._fields))

    def forward(self, feat, feat_len, group_ids=None, epoch=None):
        return apply_feat_norm(self.norm_stats(), feat, feat_len, self.cfg,
                               group_ids=group_ids, train=self.training,
                               epoch=epoch)

    def recover(self, feat: torch.Tensor,
                group_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        return recover_feat_norm(self.norm_stats(), feat, self.cfg,
                                 group_ids)
