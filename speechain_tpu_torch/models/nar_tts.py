"""FastSpeech2 (counterpart of ``speechain_tpu/models/nar_tts.py``).

:class:`FastSpeech2Net` is the reference's network (nar_tts.py:136-342):
the TTS encoder (token embedding, optional Conv1d prenet, transformer
encoder), optional speaker-embedding combination, the duration, pitch and
energy predictors, length regulation, the transformer-encoder decoder over
frames, the feature head and the Conv1d postnet's residual.

In evaluation mode (synthesis) durations are predicted in the log domain
and turned into integer frame counts by :func:`proc_duration`; the pitch
and energy predictions are re-embedded and added to the token encodings
before length regulation. The controllable-TTS alphas (duration, pitch,
energy) multiply the predictions, as the reference's ``train=False``
branch.

In training mode (the module's ``training`` flag, the reference's
``train=True``) :meth:`FastSpeech2Net.prepare_targets` turns the waveform
into the normalized log-Mel and frame energy through the plain frontend
(``ops/frontend.py::frontend_impl``, the reference's ``_frontend_impl``:
the log-Mel kernel has no energy output), normalizes the frame-level pitch
and energy (the feature norms' running statistics move first, with the
speaker ids as group ids, as the reference passes them) and groups them by
the reduction factor. The teacher durations are rescaled to sum to each
utterance's frame count and rounded (:func:`proc_duration`); the
frame-level pitch and energy are averaged per token over them
(:func:`average_scalar_by_duration`), and these teacher values, not the
predictions, are embedded. Length regulation runs to the target's frame
count, and the decoder's mask is the target's length. The output
dictionary then holds the ``tgt_*`` targets that :func:`fastspeech2_loss`
(nar_tts.py:365-399) compares with the predictions.

Length regulation (:func:`length_regulate`) is the reference's static
gather: frame t of an utterance reads token searchsorted(cumsum(dur), t,
'right'), and frames past the total are zeros. The port sums the integer
durations in float32, exactly, in synthesis and in training. The
reference sums them in their own dtype: in bf16 (a bf16 network's) its
partial sums past 256 frames round, in an order that XLA's scan picks, so
a bf16 network's frame boundaries can differ from the port's by bf16's
spacing there; in float32 the two agree exactly.

``param_dtype`` float32 keeps float32 master weights under a bf16
``dtype`` (each use casts, as flax does), as ``ARASRConfig.param_dtype``;
left None, the parameters are stored in ``dtype`` (serving).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from speechain_tpu_torch.models.ar_tts import TTSEncoder
from speechain_tpu_torch.nn.dense import Dense
from speechain_tpu_torch.nn.postnets import Conv1dPostnet
from speechain_tpu_torch.nn.prenets import (Conv1dVarPredictor,
                                            ScalarEmbedConv,
                                            SpeakerEmbedPrenet)
from speechain_tpu_torch.nn.transformer import TransformerEncoder
from speechain_tpu_torch.ops.feat_norm import FeatNormConfig, FeatNormModule
from speechain_tpu_torch.ops.frontend import (FrontendConfig, frontend_impl,
                                              to_float_wave)
from speechain_tpu_torch.train import criteria
from speechain_tpu_torch.utils.masks import make_mask_from_len


@dataclasses.dataclass(frozen=True)
class FastSpeech2Config:
    vocab_size: int
    frontend: FrontendConfig = FrontendConfig(
        n_mels=80, win_length=0.05, hop_length=0.0125, fmin=125.0,
        fmax=7600.0, return_energy=True)
    feat_norm: Optional[FeatNormConfig] = None
    pitch_norm: Optional[FeatNormConfig] = None
    energy_norm: Optional[FeatNormConfig] = None
    reduction_factor: int = 1
    enc_emb: Dict[str, Any] = dataclasses.field(default_factory=dict)
    enc_prenet: Dict[str, Any] = dataclasses.field(default_factory=dict)
    encoder: Dict[str, Any] = dataclasses.field(default_factory=dict)
    duration_predictor: Dict[str, Any] = dataclasses.field(
        default_factory=dict)
    pitch_predictor: Dict[str, Any] = dataclasses.field(default_factory=dict)
    energy_predictor: Dict[str, Any] = dataclasses.field(default_factory=dict)
    decoder: Dict[str, Any] = dataclasses.field(default_factory=dict)
    postnet: Dict[str, Any] = dataclasses.field(default_factory=dict)
    spk_emb: Optional[Dict[str, Any]] = None
    feat_loss_type: str = "L1"
    max_frame_len: int = 2048       # static length-regulation output cap
    dtype: torch.dtype = torch.float32
    param_dtype: Optional[torch.dtype] = None


def average_scalar_by_duration(frame_scalar: torch.Tensor,
                               duration: torch.Tensor) -> torch.Tensor:
    """Per-token mean of a frame-level scalar (decoder/nar_tts.py:151-204,
    reference nar_tts.py:85): frame_scalar (B, T), duration (B, L) frames
    per token -> (B, L), from segment sums of a cumulative sum."""
    T = frame_scalar.shape[1]
    csum = torch.cumsum(torch.nn.functional.pad(frame_scalar, (1, 0)), 1)
    ends = torch.cumsum(duration.float(), 1).to(torch.int32)
    starts = torch.nn.functional.pad(ends, (1, 0))[:, :-1]
    ends_c = ends.clamp(0, T).long()
    starts_c = starts.clamp(0, T).long()
    seg_sum = csum.gather(1, ends_c) - csum.gather(1, starts_c)
    cnt = (ends_c - starts_c).to(frame_scalar.dtype)
    return seg_sum / (cnt + 1e-10)


def length_regulate(enc_text: torch.Tensor, duration: torch.Tensor,
                    max_frames: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token encodings (B, L, D) expanded by durations (B, L) into
    (frames (B, max_frames, D), frame_len (B,)) (reference nar_tts.py:105):
    frame t reads token searchsorted(cumsum(dur), t, 'right'), clamped to
    the last token; frames past the total duration are zeros."""
    B, L, Dm = enc_text.shape
    ends = torch.cumsum(duration.float(), 1)                     # (B, L)
    total = ends[:, -1].to(torch.int32)
    t = torch.arange(max_frames, device=enc_text.device)
    tok = torch.searchsorted(ends, t.float().expand(B, max_frames)
                             .contiguous(), right=True).clamp(0, L - 1)
    frames = enc_text.gather(1, tok[..., None].expand(B, max_frames, Dm))
    frame_len = torch.clamp(total, max=max_frames)
    keep = t[None, :, None] < frame_len[:, None, None]
    return torch.where(keep, frames, frames.new_zeros(())), frame_len


def proc_duration(duration: torch.Tensor, reduction_factor: int = 1,
                  min_frame_num: int = 0,
                  max_frame_num: Optional[int] = None,
                  duration_alpha: Optional[torch.Tensor] = None,
                  train: bool = True) -> torch.Tensor:
    """Round and clamp real-valued durations (decoder/nar_tts.py:206-232,
    reference nar_tts.py:130): times ``duration_alpha`` at inference,
    rounded half to even, at least 0; exact zeros stay zero, others clamp
    to [min_frame_num / r, max_frame_num / r]."""
    if not train and duration_alpha is not None:
        duration = duration * duration_alpha
    duration = torch.clamp(torch.round(duration), min=0)
    zero = duration == 0
    lo = round(min_frame_num / reduction_factor)
    hi = (None if max_frame_num is None
          else round(max_frame_num / reduction_factor))
    duration = torch.clamp(duration, min=lo, max=hi)
    return torch.where(zero, duration.new_zeros(()), duration)


def generate_ctrl_alpha(generator: Optional[torch.Generator],
                        batch_size: int, token_len: int, *,
                        alpha: Optional[float] = None,
                        alpha_min: float = 0.8, alpha_max: float = 1.2,
                        granularity: str = "utterance",
                        device=None) -> torch.Tensor:
    """Controllable-TTS multipliers (model/nar_tts.py:706-785, reference
    nar_tts.py:344): a (B, L) float32 tensor, ``alpha`` everywhere if
    given, else uniform draws in [alpha_min, alpha_max) from the CPU
    ``generator``, one an utterance or one a token (``granularity``),
    moved to ``device``."""
    if alpha is not None:
        return torch.full((batch_size, token_len), float(alpha),
                          device=device)
    if granularity not in ("utterance", "token"):
        raise ValueError(granularity)
    n = 1 if granularity == "utterance" else token_len
    u = torch.rand((batch_size, n), generator=generator)
    a = alpha_min + (alpha_max - alpha_min) * u
    return a.expand(batch_size, token_len).to(device)


class FastSpeech2Net(nn.Module):
    """FastSpeech2 for synthesis (evaluation mode) and training (training
    mode). Submodule names follow the reference's, so ``utils/weights.py``
    bridges its variables; the transformer FFNs run the FFN kernel
    ('linear') or plain convolutions ('conv'), and both transformer
    stacks' self-attention the flash-attention kernel."""

    def __init__(self, cfg: FastSpeech2Config):
        super().__init__()
        c = self.cfg = cfg
        dt = c.dtype
        self.encoder = TTSEncoder(c.vocab_size, c.enc_emb,
                                  c.enc_prenet or None, c.encoder, dtype=dt)
        d_model = c.encoder.get("d_model", 512)
        if c.spk_emb is not None:
            self.spk_emb = SpeakerEmbedPrenet(d_model=d_model, dtype=dt,
                                              **c.spk_emb)
        for name in ("duration_predictor", "pitch_predictor",
                     "energy_predictor"):
            self.add_module(name, Conv1dVarPredictor(
                d_model, dtype=dt, **getattr(c, name)))
        self.pitch_embed = ScalarEmbedConv(d_model, dtype=dt)
        self.energy_embed = ScalarEmbedConv(d_model, dtype=dt)
        self.decoder = TransformerEncoder(dtype=dt, **c.decoder)
        self.feat_dim = c.frontend.n_mels * c.reduction_factor
        self.feat_pred = Dense(c.decoder.get("d_model", 512), self.feat_dim,
                               dtype=dt)
        self.postnet = Conv1dPostnet(self.feat_dim, dtype=dt, **c.postnet)
        for name in ("feat_norm", "pitch_norm", "energy_norm"):
            if getattr(c, name) is not None:
                self.add_module(name, FeatNormModule(getattr(c, name)))
        if c.param_dtype is not None:
            self.to(c.param_dtype)

    def _reduce_group(self, x: torch.Tensor, x_len: torch.Tensor,
                      mean: bool):
        """Group r frames into one (reference nar_tts.py:192): (B, T, D)
        -> (B, T // r, D r); (B, T) -> (B, T // r), averaged if ``mean``
        (else (B, T // r, r)); lengths // r."""
        r = self.cfg.reduction_factor
        if r <= 1:
            return x, x_len
        B = x.shape[0]
        T_r = (x.shape[1] // r) * r
        if x.ndim == 3:
            x = x[:, :T_r].reshape(B, T_r // r, x.shape[-1] * r)
        else:
            x = x[:, :T_r].reshape(B, T_r // r, r)
            x = x.mean(-1) if mean else x
        return x, torch.div(x_len, r, rounding_mode="floor")

    def prepare_targets(self, feat, feat_len, pitch, pitch_len, *,
                        epoch=None, group_ids=None):
        """A waveform (B, L, 1) -> log-Mel and frame energy (the plain
        frontend); the log-Mel, pitch and energy normalized where a norm is
        configured (their running statistics move first in training mode);
        then grouped by the reduction factor (reference nar_tts.py:205-240).
        Returns (feat, feat_len, pitch, pitch_len, energy, energy_len)."""
        c = self.cfg
        energy = energy_len = None
        if feat is not None and feat.ndim == 3 and feat.shape[-1] == 1:
            feat, feat_len, energy, energy_len = frontend_impl(
                to_float_wave(feat[..., 0]), feat_len, c.frontend)
        if feat is not None and c.feat_norm is not None:
            feat, feat_len = self.feat_norm(feat, feat_len, group_ids, epoch)
        if pitch is not None and c.pitch_norm is not None:
            pitch, pitch_len = self.pitch_norm(pitch, pitch_len, group_ids,
                                               epoch)
        if energy is not None and c.energy_norm is not None:
            energy, energy_len = self.energy_norm(energy, energy_len,
                                                  group_ids, epoch)
        if feat is not None:
            feat, feat_len = self._reduce_group(feat, feat_len, mean=False)
        if pitch is not None:
            pitch, pitch_len = self._reduce_group(pitch, pitch_len, mean=True)
        if energy is not None:
            energy, energy_len = self._reduce_group(energy, energy_len,
                                                    mean=True)
        return feat, feat_len, pitch, pitch_len, energy, energy_len

    def forward(self, text: torch.Tensor, text_len: torch.Tensor,
                feat: Optional[torch.Tensor] = None,
                feat_len: Optional[torch.Tensor] = None,
                pitch: Optional[torch.Tensor] = None,
                pitch_len: Optional[torch.Tensor] = None,
                duration: Optional[torch.Tensor] = None,
                duration_len: Optional[torch.Tensor] = None,
                spk_feat: Optional[torch.Tensor] = None,
                spk_ids: Optional[torch.Tensor] = None, *,
                epoch=None,
                min_frame_num: int = 0,
                max_frame_num: Optional[int] = None,
                duration_alpha: Optional[torch.Tensor] = None,
                pitch_alpha: Optional[torch.Tensor] = None,
                energy_alpha: Optional[torch.Tensor] = None,
                max_frames: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """The reference's ``__call__`` (nar_tts.py:242-328): text (B, L)
        and text_len (B,); for training the waveform ``feat`` (B, L_w, 1)
        with ``feat_len``, the frame-level ``pitch`` (B, T) and the teacher
        ``duration`` (B, L) frames a token. Without a teacher duration the
        durations are predicted. Returns the reference's output
        dictionary (the ``tgt_*`` entries None where no target was
        given)."""
        c = self.cfg
        train = self.training
        if train and (pitch is None or feat is None or feat.ndim != 3
                      or feat.shape[-1] != 1):
            raise ValueError("FastSpeech2 trains on teacher pitch and "
                             "energy: pass the waveform (B, L, 1) and the "
                             "frame-level pitch")
        enc_text, enc_len, _ = self.encoder(text, text_len)
        if c.spk_emb is not None:
            enc_text = self.spk_emb.combine(
                enc_text, self.spk_emb.embed(spk_ids, spk_feat), where="enc")

        feat, feat_len, pitch, pitch_len, energy, energy_len = \
            self.prepare_targets(feat, feat_len, pitch, pitch_len,
                                 epoch=epoch, group_ids=spk_ids)

        pred_duration, pred_gate = self.duration_predictor(enc_text)
        if duration is not None:
            # teacher durations rescaled to sum to feat_len (:328-333)
            d = duration.float()
            scaled = (d / torch.clamp(d.sum(-1, keepdim=True), min=1e-10)
                      * feat_len[:, None].float())
            used_duration = proc_duration(scaled, c.reduction_factor,
                                          min_frame_num, max_frame_num,
                                          duration_alpha, train=train)
        else:
            pd = pred_duration
            if pred_gate is not None:
                pd = torch.where(pred_gate > 0,
                                 pd.new_full((), -float("inf")), pd)
            used_duration = proc_duration(torch.exp(pd) - 1.0,
                                          c.reduction_factor, min_frame_num,
                                          max_frame_num, duration_alpha,
                                          train=False)
            tok_mask = make_mask_from_len(enc_len, enc_text.shape[1])[:, 0]
            used_duration = torch.where(tok_mask, used_duration,
                                        used_duration.new_zeros(()))

        pred_pitch, _ = self.pitch_predictor(enc_text)
        if pitch is not None:
            pitch = average_scalar_by_duration(pitch, used_duration)
        used_pitch = pitch if train else pred_pitch
        if not train and pitch_alpha is not None:
            used_pitch = used_pitch * pitch_alpha
        pred_energy, _ = self.energy_predictor(enc_text)
        if energy is not None:
            energy = average_scalar_by_duration(energy, used_duration)
        used_energy = energy if train else pred_energy
        if not train and energy_alpha is not None:
            used_energy = used_energy * energy_alpha
        enc_text = (enc_text + self.pitch_embed(used_pitch)
                    + self.energy_embed(used_energy))

        F = max_frames or (feat.shape[1] if feat is not None
                           else c.max_frame_len)
        frames, frame_len = length_regulate(enc_text, used_duration, F)
        if feat_len is not None:
            frame_len = feat_len
        dec_feat, _ = self.decoder(frames, make_mask_from_len(frame_len, F))
        pred_before = self.feat_pred(dec_feat)
        pred_after = pred_before + self.postnet(pred_before)
        return dict(
            pred_before=pred_before, pred_after=pred_after,
            pred_feat_len=frame_len, tgt_feat=feat, tgt_feat_len=feat_len,
            pred_pitch=pred_pitch, tgt_pitch=pitch, tgt_pitch_len=enc_len,
            pred_energy=pred_energy, tgt_energy=energy,
            tgt_energy_len=enc_len, pred_duration=pred_duration,
            pred_duration_gate=pred_gate, used_duration=used_duration,
            tgt_duration_len=enc_len)

    def recover_feat(self, feat: torch.Tensor,
                     group_ids: Optional[torch.Tensor] = None,
                     ungroup: bool = True) -> torch.Tensor:
        """Predictions in the reduction-grouped layout unfolded to (B,
        T r, n_mels), then denormalized where a feature norm is set
        (reference nar_tts.py:330)."""
        c = self.cfg
        if ungroup and c.reduction_factor > 1:
            B, T, Dm = feat.shape
            feat = feat.reshape(B, T * c.reduction_factor,
                                Dm // c.reduction_factor)
        if c.feat_norm is not None:
            feat = self.feat_norm.recover(feat, group_ids)
        return feat


def fastspeech2_loss(outputs: Dict[str, torch.Tensor],
                     tgt_duration: torch.Tensor, cfg: FastSpeech2Config,
                     reduction_factor: Optional[int] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's criterion (nar_tts.py:365-399): ``feat_loss_type``
    on the features before and after the postnet, L2 on the per-token
    pitch and energy and on the log duration log(tgt_duration + 1), plus
    the positive-weighted gate BCE where the duration predictor has a gate
    head; ``duration_f1`` is the F1 of the predicted zero durations against
    the teacher's. ``tgt_duration`` is the batch's (unscaled) teacher
    duration. Returns (loss, metrics), on the device."""
    r = reduction_factor or cfg.reduction_factor
    fl, flen = outputs["tgt_feat"], outputs["tgt_feat_len"]
    fb = criteria.least_error(outputs["pred_before"], fl, flen,
                              loss_type=cfg.feat_loss_type)
    fa = criteria.least_error(outputs["pred_after"], fl, flen,
                              loss_type=cfg.feat_loss_type)
    pl = criteria.least_error(outputs["pred_pitch"], outputs["tgt_pitch"],
                              outputs["tgt_pitch_len"], loss_type="L2")
    el = criteria.least_error(outputs["pred_energy"], outputs["tgt_energy"],
                              outputs["tgt_energy_len"], loss_type="L2")
    dl = criteria.least_error(outputs["pred_duration"],
                              torch.log(tgt_duration.float() + 1.0),
                              outputs["tgt_duration_len"], loss_type="L2")
    loss = fb + fa + pl + el + dl
    metrics = dict(feat_loss_before=fb, feat_loss_after=fa, pitch_loss=pl,
                   energy_loss=el, duration_loss=dl)
    gate_tgt = (tgt_duration == 0).to(torch.int32)
    pred_zero = (proc_duration(torch.exp(outputs["pred_duration"]) - 1.0, r)
                 == 0).to(torch.int32)
    metrics["duration_f1"] = criteria.fbeta_score(
        pred_zero, gate_tgt, outputs["tgt_duration_len"], beta=1.0)
    if outputs.get("pred_duration_gate") is not None:
        gl = criteria.bce_logits(outputs["pred_duration_gate"],
                                 gate_tgt.float(),
                                 outputs["tgt_duration_len"], pos_weight=1.0)
        loss = loss + gl
        metrics["duration_gate_loss"] = gl
    metrics["loss"] = loss
    return loss, metrics
