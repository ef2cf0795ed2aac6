"""Autoregressive Transformer-TTS (counterpart of
``speechain_tpu/models/ar_tts.py``): the TTS text encoder
(:class:`TTSEncoder`, :74; encoder/tts.py:20-87), which FastSpeech2
shares, and :class:`ARTTSNet` (:99) with :func:`artts_loss` (:279).

:class:`ARTTSNet` (decoder/ar_tts.py:24-213): the waveform's log-Mel from
the plain frontend (``ops/frontend.py::frontend_impl``, the reference's
``_frontend_impl``: the log-Mel kernel is not on this path), feature
normalization with the speaker ids as group ids, reduction-factor
grouping (T / r frames of D r); the decoder's input is that target
shifted right by a zero frame, through the linear prenet with its
dropout on in every mode (the reference's ``turn_on_dropout``), the
speaker combination, the transformer decoder at the prenet's width (the
reference overrides the config's ``d_model`` with it), the stop and
feature heads, and the Conv1d postnet's residual. With attention
guidance (``att_guid_sigma`` > 0) the decoder returns layer 0's
cross-attention matrix, which is all the loss reads; every other
attention stays on the flash kernel (the reference routes the whole
decoder to XLA then). Synthesis steps the decoder through its KV cache
(:meth:`ARTTSNet.decode_step`, ``infer/tts_decoding.py``).

``param_dtype`` float32 keeps float32 master weights under a bf16
``dtype``, as ``FastSpeech2Config.param_dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from speechain_tpu_torch.nn.dense import Dense
from speechain_tpu_torch.nn.postnets import Conv1dPostnet
from speechain_tpu_torch.nn.prenets import (Conv1dPrenet, EmbedPrenet,
                                            LinearPrenet, SpeakerEmbedPrenet,
                                            _as_list)
from speechain_tpu_torch.nn.transformer import (DecoderCache,
                                                TransformerDecoder,
                                                TransformerEncoder)
from speechain_tpu_torch.ops.feat_norm import FeatNormConfig, FeatNormModule
from speechain_tpu_torch.ops.frontend import (FrontendConfig, frontend_impl,
                                              to_float_wave)
from speechain_tpu_torch.train import criteria
from speechain_tpu_torch.utils.masks import make_mask_from_len


@dataclasses.dataclass(frozen=True)
class ARTTSConfig:
    vocab_size: int
    frontend: FrontendConfig = FrontendConfig(
        n_mels=80, win_length=0.05, hop_length=0.0125, fmin=125.0,
        fmax=7600.0)
    feat_norm: Optional[FeatNormConfig] = None
    reduction_factor: int = 1
    enc_emb: Dict[str, Any] = dataclasses.field(default_factory=dict)
    enc_prenet: Dict[str, Any] = dataclasses.field(default_factory=dict)
    encoder: Dict[str, Any] = dataclasses.field(default_factory=dict)
    dec_prenet: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: dict(lnr_dims=[256, 256], lnr_dropout=0.5))
    decoder: Dict[str, Any] = dataclasses.field(default_factory=dict)
    postnet: Dict[str, Any] = dataclasses.field(default_factory=dict)
    spk_emb: Optional[Dict[str, Any]] = None
    stop_pos_weight: float = 5.0
    feat_loss_type: str = "L2"
    att_guid_sigma: float = 0.0
    dtype: torch.dtype = torch.float32
    param_dtype: Optional[torch.dtype] = None


class TTSEncoder(nn.Module):
    """``forward(text, text_len)`` -> (encoding (B, L, D), text_len, mask
    (B, 1, L))."""

    def __init__(self, vocab_size: int, emb: Dict[str, Any],
                 prenet: Optional[Dict[str, Any]], encoder: Dict[str, Any],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embedding = EmbedPrenet(vocab_size, dtype=dtype, **emb)
        width = self.embedding.embedding_dim
        self.prenet = (None if prenet is None
                       else Conv1dPrenet(width, dtype=dtype, **prenet))
        self.encoder = TransformerEncoder(dtype=dtype, **encoder)

    def forward(self, text: torch.Tensor, text_len: torch.Tensor):
        x = self.embedding(text)
        if self.prenet is not None:
            x, text_len = self.prenet(x, text_len)
        mask = make_mask_from_len(text_len, x.shape[1])
        out, mask = self.encoder(x, mask)
        return out, text_len, mask


class ARTTSNet(nn.Module):
    """Transformer-TTS for training (training mode) and synthesis. Module
    names follow the reference's, so ``utils/weights.py`` bridges its
    variables."""

    def __init__(self, cfg: ARTTSConfig):
        super().__init__()
        c = self.cfg = cfg
        dt = c.dtype
        self.encoder = TTSEncoder(c.vocab_size, c.enc_emb,
                                  c.enc_prenet or None, c.encoder, dtype=dt)
        if c.feat_norm is not None:
            self.feat_norm = FeatNormModule(c.feat_norm)
        self.feat_dim = c.frontend.n_mels * c.reduction_factor
        self.dec_prenet = LinearPrenet(self.feat_dim, dtype=dt,
                                       **c.dec_prenet)
        # the decoder runs at the prenet's width, whatever the config's
        # d_model says (transformer/decoder.py:247-249)
        width = _as_list(c.dec_prenet["lnr_dims"])[-1]
        enc_width = c.encoder.get("d_model", 512)
        if c.spk_emb is not None:
            self.spk_emb = SpeakerEmbedPrenet(d_model=width, dtype=dt,
                                              enc_dim=enc_width, **c.spk_emb)
            if self.spk_emb.comb == "concat":   # projected to the width
                enc_width = width
        self.decoder = TransformerDecoder(dtype=dt, enc_dim=enc_width,
                                          **dict(c.decoder, d_model=width))
        self.feat_pred = Dense(width, self.feat_dim, dtype=dt)
        self.stop_pred = Dense(width, 1, dtype=dt)
        self.postnet = Conv1dPostnet(self.feat_dim, dtype=dt, **c.postnet)
        if c.param_dtype is not None:
            self.to(c.param_dtype)

    def _speaker(self, spk_ids, spk_feat):
        if self.cfg.spk_emb is None:
            return None
        return self.spk_emb.embed(spk_ids, spk_feat)

    def prepare_targets(self, feat: torch.Tensor, feat_len: torch.Tensor, *,
                        epoch=None, group_ids=None):
        """A waveform (B, L, 1) -> log-Mel (the plain frontend); normalized
        where a norm is configured (its running statistics move first in
        training mode); grouped by the reduction factor (reference
        ar_tts.py:140-167). Returns (feat, feat_len)."""
        c = self.cfg
        if feat.ndim == 3 and feat.shape[-1] == 1:
            feat, feat_len, _, _ = frontend_impl(
                to_float_wave(feat[..., 0]), feat_len, c.frontend)
        if c.feat_norm is not None:
            feat, feat_len = self.feat_norm(feat, feat_len, group_ids, epoch)
        r = c.reduction_factor
        if r > 1:
            B, T, Dm = feat.shape
            T_r = (T // r) * r
            feat = feat[:, :T_r].reshape(B, T_r // r, Dm * r)
            feat_len = torch.div(feat_len, r, rounding_mode="floor")
        return feat, feat_len

    def decode(self, enc_text: torch.Tensor, enc_mask: torch.Tensor,
               feat: torch.Tensor, feat_len: torch.Tensor, *,
               spk_feat=None, spk_ids=None, return_att: bool = False):
        """Teacher-forced decoder pass over the shifted-right, grouped
        features ``feat`` (reference ar_tts.py:169-193). Returns
        (pred_stop (B, T), pred_before, pred_after (B, T, D r),
        self-attention matrices, cross-attention matrices): every layer's
        under ``return_att``, else layer 0's cross-attention alone under
        attention guidance, else empty lists."""
        c = self.cfg
        x = self.dec_prenet(feat, train=True)
        embs = self._speaker(spk_ids, spk_feat)
        if embs is not None:
            enc_text = self.spk_emb.combine(enc_text, embs, where="enc")
            if self.spk_emb.use_dec_comb:
                x = self.spk_emb.combine(x, embs, where="dec")
        feat_mask = make_mask_from_len(feat_len, x.shape[1])
        layers = range(self.decoder.num_layers)
        if return_att:
            mats = dict(self_attmats=layers, cross_attmats=layers)
        elif c.att_guid_sigma > 0.0:
            mats = dict(cross_attmats=(0,))
        else:
            mats = {}
        dec = self.decoder(x, enc_text, feat_mask, enc_mask, **mats)
        self_att, cross_att = [], []
        if mats:
            dec, self_att, cross_att = dec
        pred_stop = self.stop_pred(dec)[..., 0]
        pred_before = self.feat_pred(dec)
        pred_after = pred_before + self.postnet(pred_before)
        return pred_stop, pred_before, pred_after, self_att, cross_att

    def forward(self, text: torch.Tensor, text_len: torch.Tensor,
                feat: torch.Tensor, feat_len: torch.Tensor, *,
                spk_feat=None, spk_ids=None, epoch=None,
                return_att: bool = False) -> Dict[str, torch.Tensor]:
        """The reference's ``__call__`` (ar_tts.py:196-223): text (B, L),
        the waveform ``feat`` (B, L_w, 1) (or features) with ``feat_len``.
        Returns pred_stop, pred_before, pred_after, tgt_feat,
        tgt_feat_len, text_len, and ``cross_att`` (layer 0's, (B, H, T,
        L)) under attention guidance or ``return_att``, which adds every
        layer's matrices as ``dec_self_att`` / ``dec_cross_att``."""
        enc_text, _, enc_mask = self.encoder(text, text_len)
        tgt_feat, tgt_len = self.prepare_targets(
            feat, feat_len, epoch=epoch, group_ids=spk_ids)
        # shift right: a zero frame first (decoder/ar_tts.py:151-155)
        dec_in = F.pad(tgt_feat, (0, 0, 1, 0))[:, :-1]
        pred_stop, pred_before, pred_after, self_att, cross_att = \
            self.decode(enc_text, enc_mask, dec_in, tgt_len,
                        spk_feat=spk_feat, spk_ids=spk_ids,
                        return_att=return_att)
        out = dict(pred_stop=pred_stop, pred_before=pred_before,
                   pred_after=pred_after, tgt_feat=tgt_feat,
                   tgt_feat_len=tgt_len, text_len=text_len)
        if cross_att:
            out["cross_att"] = cross_att[0]
        if return_att:
            out["dec_self_att"] = self_att
            out["dec_cross_att"] = cross_att
        return out

    def encode_text(self, text: torch.Tensor, text_len: torch.Tensor, *,
                    spk_feat=None, spk_ids=None):
        """The encoder and the speaker combination, for synthesis
        (reference ar_tts.py:225-233): (enc_text, enc_mask (B, 1, L))."""
        enc_text, _, enc_mask = self.encoder(text, text_len)
        embs = self._speaker(spk_ids, spk_feat)
        if embs is not None:
            enc_text = self.spk_emb.combine(enc_text, embs, where="enc")
        return enc_text, enc_mask

    def decode_step(self, feat_frame: torch.Tensor, enc_mask: torch.Tensor,
                    cache: DecoderCache, *, spk_feat=None, spk_ids=None):
        """One KV-cached step over feat_frame (B, 1, D r) at the cache's
        position, which advances (reference ar_tts.py:236-255); the
        prenet's dropout is on. Returns (stop logit (B, 1), feat_before
        (B, 1, D r))."""
        x = self.dec_prenet(feat_frame, train=True)
        if self.cfg.spk_emb is not None and self.spk_emb.use_dec_comb:
            x = self.spk_emb.combine(x, self._speaker(spk_ids, spk_feat),
                                     where="dec")
        dec = self.decoder.decode_step(x, cache, enc_mask)
        return self.stop_pred(dec)[..., 0], self.feat_pred(dec)

    def apply_postnet(self, pred_before: torch.Tensor) -> torch.Tensor:
        """The postnet's residual over a (possibly partial) sequence."""
        return pred_before + self.postnet(pred_before)

    def recover_feat(self, feat: torch.Tensor,
                     group_ids: Optional[torch.Tensor] = None,
                     ungroup: bool = False) -> torch.Tensor:
        """Denormalized features for a vocoder (reference ar_tts.py:
        261-276); ``ungroup`` first unfolds the reduction-factor grouping
        (synthesis outputs are already unfolded)."""
        c = self.cfg
        if ungroup and c.reduction_factor > 1:
            B, T, Dm = feat.shape
            feat = feat.reshape(B, T * c.reduction_factor,
                                Dm // c.reduction_factor)
        if c.feat_norm is not None:
            feat = self.feat_norm.recover(feat, group_ids)
        return feat


def artts_loss(outputs: Dict[str, torch.Tensor], cfg: ARTTSConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's criterion (ar_tts.py:279-308): ``feat_loss_type``
    on the features before and after the postnet, the positive-weighted
    BCE of the stop flags (1 at each utterance's last frame), and the
    attention guidance where configured; metrics stop_accuracy and the
    stop flags' F2. Returns (loss, metrics), on the device."""
    tgt, tgt_len = outputs["tgt_feat"], outputs["tgt_feat_len"]
    fb = criteria.least_error(outputs["pred_before"], tgt, tgt_len,
                              loss_type=cfg.feat_loss_type)
    fa = criteria.least_error(outputs["pred_after"], tgt, tgt_len,
                              loss_type=cfg.feat_loss_type)
    pos = torch.arange(tgt.shape[1], device=tgt.device)[None]
    stop_tgt = (pos == (tgt_len - 1)[:, None]).float()
    stop = criteria.bce_logits(outputs["pred_stop"], stop_tgt, tgt_len,
                               pos_weight=cfg.stop_pos_weight)
    loss = fb + fa + stop
    metrics = dict(feat_loss_before=fb, feat_loss_after=fa, stop_loss=stop)
    if cfg.att_guid_sigma > 0.0 and "cross_att" in outputs:
        ag = criteria.attention_guidance(
            outputs["cross_att"], tgt_len, outputs["text_len"],
            sigma=cfg.att_guid_sigma)
        loss = loss + ag
        metrics["att_guid_loss"] = ag
    pred_bin = (torch.sigmoid(outputs["pred_stop"].float()) > 0.5).to(
        torch.int32)
    metrics["stop_accuracy"] = criteria.stop_accuracy(
        outputs["pred_stop"], stop_tgt, tgt_len)
    metrics["stop_f2"] = criteria.fbeta_score(
        pred_bin, stop_tgt.to(torch.int32), tgt_len, beta=2.0)
    metrics["loss"] = loss
    return loss, metrics
