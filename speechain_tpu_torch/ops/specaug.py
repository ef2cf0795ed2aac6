"""SpecAugment: time warp, frequency and time masking (counterpart of
``speechain_tpu/ops/specaug.py``, :59-143).

The random draws are split from the law. :func:`draw` takes every uniform
number one call needs from a ``torch.Generator``; :func:`spec_augment`
applies the reference's law to them: a warp centre in [window + 1,
min_len - window) and target in [centre - window, centre + window) with
the piecewise-linear, align-corners stretch of :func:`warp_segments`
(skipped when min_len <= 2 window + 1); ``num`` frequency bands per
utterance of width ~ U[w0, w1] at position ~ U[0, max(1, D - max width));
``num`` time bands of width bounded by the batch's shortest length;
masked positions 0.0 under feature norm, else the batch mean. A test can
so feed both sides the same draws. Everything stays on the device: the
bounds that depend on ``feat_len`` are tensors, with no host round trip.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple, Union

import torch


@dataclasses.dataclass(frozen=True)
class SpecAugmentConfig:
    time_warp: bool = True
    time_warp_window: int = 5
    freq_mask: bool = True
    freq_mask_width: Union[int, Tuple[int, int]] = 30
    freq_mask_num: int = 2
    time_mask: bool = True
    time_mask_width: Union[int, float, Tuple] = 0.05
    time_mask_num: int = 2
    feat_norm: bool = True

    @property
    def freq_width_range(self) -> Tuple[int, int]:
        w = self.freq_mask_width
        return ((0, int(w)) if isinstance(w, (int, float))
                else (int(w[0]), int(w[1])))

    @property
    def time_width_range(self):
        w = self.time_mask_width
        return (0, w) if isinstance(w, (int, float)) else (w[0], w[1])


class SpecAugDraws(NamedTuple):
    """Uniform [0, 1) float32 draws of one call: warp centre and target
    (0-d), band widths and positions (B, num) for frequency and time."""

    warp_center: torch.Tensor
    warp_target: torch.Tensor
    freq_len: torch.Tensor
    freq_pos: torch.Tensor
    time_len: torch.Tensor
    time_pos: torch.Tensor


def draw(generator: torch.Generator, batch: int, cfg: SpecAugmentConfig,
         device=None) -> SpecAugDraws:
    """Every uniform number :func:`spec_augment` needs, from
    ``generator`` (on its device), moved to ``device`` (through pinned
    memory for a card, so the copy does not wait for the device)."""
    def u(*shape):
        t = torch.rand(shape, generator=generator)
        if torch.device(device or "cpu").type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)
    return SpecAugDraws(u(), u(), u(batch, cfg.freq_mask_num),
                        u(batch, cfg.freq_mask_num),
                        u(batch, cfg.time_mask_num),
                        u(batch, cfg.time_mask_num))


def _randint(u: torch.Tensor, low, high) -> torch.Tensor:
    """Uniform ints in [low, high) from uniforms u (reference _randint)."""
    span = torch.clamp(torch.as_tensor(high - low), min=1)
    return (low + (u * span).to(torch.int32)).to(torch.int32)


def warp_segments(feat: torch.Tensor, center, target,
                  min_len) -> torch.Tensor:
    """Stretch feat[:, :center] to ``target`` frames and
    feat[:, center:min_len] to ``min_len - target`` frames, as
    ``interpolate(mode='bilinear', align_corners=True)`` per segment;
    frames at t >= min_len pass through (reference :66-94)."""
    B, T, D = feat.shape
    dev = feat.device
    t = torch.arange(T, device=dev, dtype=torch.float32)
    centerf = torch.as_tensor(center, device=dev).to(torch.float32)
    targetf = torch.as_tensor(target, device=dev).to(torch.float32)
    minf = torch.as_tensor(min_len, device=dev).to(torch.float32)
    left = t * (centerf - 1.0) / torch.clamp(targetf - 1.0, min=1.0)
    left = torch.where(targetf > 1.0, left, torch.zeros_like(left))
    right_out = minf - targetf
    right = centerf + (t - targetf) * (minf - centerf - 1.0) / torch.clamp(
        right_out - 1.0, min=1.0)
    right = torch.where(right_out > 1.0, right, centerf.expand_as(right))
    src = torch.where(t < targetf, left, right)
    src = torch.where(t >= minf, t, src)
    src = torch.clamp(src, 0.0, T - 1.0)
    lo = torch.floor(src).to(torch.int64)
    hi = torch.clamp(lo + 1, max=T - 1)
    w = (src - lo.to(torch.float32))[None, :, None]
    return (1.0 - w) * feat[:, lo] + w * feat[:, hi]


def spec_augment(feat: torch.Tensor, feat_len: torch.Tensor,
                 cfg: SpecAugmentConfig,
                 draws: SpecAugDraws) -> torch.Tensor:
    """feat (B, T, D) -> augmented feat; feat_len unchanged."""
    B, T, D = feat.shape
    dev = feat.device
    min_len = feat_len.min().to(torch.int32)

    if cfg.time_warp:
        win = cfg.time_warp_window
        center = _randint(draws.warp_center, win + 1, min_len - win)
        target = _randint(draws.warp_target, center - win, center + win)
        warped = warp_segments(feat, center, target, min_len)
        feat = torch.where(min_len > 2 * win + 1, warped, feat)

    mask = torch.zeros(B, T, D, dtype=torch.bool, device=dev)
    if cfg.freq_mask:
        w0, w1 = cfg.freq_width_range
        mlen = _randint(draws.freq_len, w0, w1 + 1)
        mpos = _randint(draws.freq_pos, 0,
                        torch.clamp(D - mlen.max(), min=1))
        ax = torch.arange(D, device=dev)
        fm = (mpos[..., None] <= ax) & (ax < (mpos + mlen)[..., None])
        mask = mask | fm.any(1)[:, None, :]

    if cfg.time_mask:
        t0, t1 = cfg.time_width_range
        lo = (torch.floor(t0 * min_len).to(torch.int32)
              if isinstance(t0, float) else torch.tensor(int(t0), device=dev))
        hi = (torch.floor(t1 * min_len).to(torch.int32)
              if isinstance(t1, float) else torch.tensor(int(t1), device=dev))
        hi = torch.minimum(hi, min_len)
        mlen = _randint(draws.time_len, lo, hi + 1)
        mpos = _randint(draws.time_pos, 0,
                        torch.clamp(min_len - mlen.max(), min=1))
        ax = torch.arange(T, device=dev)
        tm = (mpos[..., None] <= ax) & (ax < (mpos + mlen)[..., None])
        mask = mask | tm.any(1)[:, :, None]

    fill = (torch.zeros((), dtype=feat.dtype, device=dev) if cfg.feat_norm
            else feat.mean())
    return torch.where(mask, fill, feat)
