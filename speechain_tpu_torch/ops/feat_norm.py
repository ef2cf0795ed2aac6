"""Feature normalization from running statistics, evaluation path.

Counterpart of ``speechain_tpu/ops/feat_norm.py``. :class:`FeatNormConfig`
and :class:`NormStats` are copies; :func:`apply_feat_norm` ports the
``train=False`` branches: per-utterance and per-batch statistics
(``utterance`` / ``batch``) and the running ``global`` / ``group``
statistics with the unseen-group fallback to ``aver_mean`` / ``aver_std``
(reference ``module/norm/feat_norm.py:510-531``). Updating the running
statistics is training work and comes with the training slice.

Per-utterance std is the unbiased (n-1) estimator over valid frames,
clamped from below, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch


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


def apply_feat_norm(stats: Optional[NormStats], feat: torch.Tensor,
                    feat_len: torch.Tensor, cfg: FeatNormConfig, *,
                    group_ids: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalize ``feat`` (B, T, D) or (B, T) with frozen statistics.

    group_ids: (B,) int indices into the declared group vocabulary, or None
    (group 0). Returns (feat, feat_len)."""
    squeeze = feat.ndim == 2
    if squeeze:
        feat = feat[..., None]

    if cfg.norm_type in ("utterance", "batch"):
        # in evaluation both normalize each utterance by its own moments
        mean_b, std_b = per_utt_stats(feat, feat_len, cfg.clamp)
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
    seen_sel = stats.seen[group_ids][:, None]                    # (B, 1)
    use_mean = torch.where(seen_sel, stats.mean[group_ids],
                           stats.aver_mean[None, :])
    use_std = torch.where(seen_sel, stats.std[group_ids],
                          stats.aver_std[None, :])
    out = feat
    if cfg.mean_norm:
        out = out - use_mean[:, None, :]
    if cfg.std_norm:
        out = out / use_std[:, None, :]
    return (out[..., 0] if squeeze else out), feat_len
