"""FastSpeech2 synthesis (counterpart of ``speechain_tpu/models/nar_tts.py``).

:class:`FastSpeech2Net` is the reference's network (nar_tts.py:136-342) in
evaluation mode: the TTS encoder (token embedding, optional Conv1d
prenet, transformer encoder), optional speaker-embedding combination,
the duration, pitch and energy predictors, length regulation, the
transformer-encoder decoder over frames, the feature head and the Conv1d
postnet's residual. Durations are predicted in the log domain and turned
into integer frame counts by :func:`proc_duration`; the pitch and energy
predictions are re-embedded and added to the token encodings before
length regulation. The controllable-TTS alphas (duration, pitch, energy)
multiply the predictions, as the reference's ``train=False`` branch.

Length regulation (:func:`length_regulate`) is the reference's static
gather: frame t of an utterance reads token searchsorted(cumsum(dur), t,
'right'), and frames past the total are zeros. The port sums the integer
durations in float32, exactly. The reference sums them in their own dtype:
in bf16 (a bf16 network's) its partial sums past 256 frames round, in an
order that XLA's scan picks, so a bf16 network's frame boundaries can
differ from the port's by bf16's spacing there; in float32 the two agree
exactly.

Training (targets, teacher durations, the losses) is not ported yet:
``forward`` in training mode raises.
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
from speechain_tpu_torch.ops.frontend import FrontendConfig
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
    """FastSpeech2 in evaluation mode. Submodule names follow the
    reference's, so ``utils/weights.py`` bridges its variables; the
    transformer FFNs run the FFN kernel ('linear') or plain convolutions
    ('conv'), and both transformer stacks' self-attention the
    flash-attention kernel."""

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

    def forward(self, text: torch.Tensor, text_len: torch.Tensor,
                spk_feat: Optional[torch.Tensor] = None,
                spk_ids: Optional[torch.Tensor] = None, *,
                min_frame_num: int = 0,
                max_frame_num: Optional[int] = None,
                duration_alpha: Optional[torch.Tensor] = None,
                pitch_alpha: Optional[torch.Tensor] = None,
                energy_alpha: Optional[torch.Tensor] = None,
                max_frames: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Synthesis from text (B, L) and text_len (B,) (reference
        nar_tts.py:242-328 at ``train=False``); returns the reference's
        output dictionary without the training targets."""
        if self.training:
            raise NotImplementedError("FastSpeech2 training is not ported "
                                      "yet; call .eval() first")
        c = self.cfg
        enc_text, enc_len, _ = self.encoder(text, text_len)
        if c.spk_emb is not None:
            enc_text = self.spk_emb.combine(
                enc_text, self.spk_emb.embed(spk_ids, spk_feat), where="enc")

        pred_duration, pred_gate = self.duration_predictor(enc_text)
        pd = pred_duration
        if pred_gate is not None:
            pd = torch.where(pred_gate > 0, pd.new_full((), -float("inf")),
                             pd)
        used_duration = proc_duration(torch.exp(pd) - 1.0,
                                      c.reduction_factor, min_frame_num,
                                      max_frame_num, duration_alpha,
                                      train=False)
        tok_mask = make_mask_from_len(enc_len, enc_text.shape[1])[:, 0]
        used_duration = torch.where(tok_mask, used_duration,
                                    used_duration.new_zeros(()))

        pred_pitch, _ = self.pitch_predictor(enc_text)
        used_pitch = (pred_pitch if pitch_alpha is None
                      else pred_pitch * pitch_alpha)
        pred_energy, _ = self.energy_predictor(enc_text)
        used_energy = (pred_energy if energy_alpha is None
                       else pred_energy * energy_alpha)
        enc_text = (enc_text + self.pitch_embed(used_pitch)
                    + self.energy_embed(used_energy))

        F = max_frames or c.max_frame_len
        frames, frame_len = length_regulate(enc_text, used_duration, F)
        dec_feat, _ = self.decoder(frames, make_mask_from_len(frame_len, F))
        pred_before = self.feat_pred(dec_feat)
        pred_after = pred_before + self.postnet(pred_before)
        return dict(
            pred_before=pred_before, pred_after=pred_after,
            pred_feat_len=frame_len, pred_pitch=pred_pitch,
            pred_energy=pred_energy, pred_duration=pred_duration,
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
