"""Autoregressive attention ASR (counterpart of
``speechain_tpu/models/ar_asr.py``): conformer or transformer encoder,
transformer decoder, optional CTC head.

:class:`ARASRNet` offers what decoding needs: :meth:`~ARASRNet.encode`
(waveform or features -> encoder output), :meth:`~ARASRNet.prime` and
:meth:`~ARASRNet.decode_step` (single-step KV-cached decoding) and
:meth:`~ARASRNet.ctc_logits`; and what training needs: ``forward``
(ar_asr.py:212-238), the teacher-forced pass, whose outputs
:func:`arasr_loss` (:241-270) turns into CE + ctc_weight * CTC.

The frontend (ar_asr.py:64-90) is the float32 log-Mel kernel, then
feature normalization (in training mode the running statistics update
first), then, in training, SpecAugment with draws from the step's
generator (``ops/dropout.py::step_rng``). Training mode is the module's
``training`` flag. ``param_dtype`` float32 keeps float32 master weights
under a bf16 ``dtype`` (each use casts, as flax does); left None, the
parameters are stored in ``dtype`` (serving). With ``ilm_weight`` the
forward also runs the internal LM (:meth:`~ARASRNet.ilm_decode`, the
decoder over zeroed encoder features with an all-true mask, in evaluation
mode as the reference's ``decode`` call without ``train``), whose
cross-entropy :func:`arasr_loss` adds; with ``att_guid_sigma`` it asks the
decoder for its first layer's cross-attention matrix alone
(``cross_attmats=(0,)``: that attention takes the matrix path, the others
keep the kernel; the reference asks for every layer's and reads the
first's), which the attention guidance reads.

Two routes are off by default, as in the reference: ``fused_ln`` sends
the encoder's and decoder's LayerNorms through the LayerNorm kernels
(None: the reference's ``SPEECHAIN_FORCE_FUSED_LN`` switch), and
``prenet_core`` picks the Conv2d prenet's fused core (None, ``"xla"`` or
``"fused"``; by default the reference's ``SPEECHAIN_FORCE_FUSED_PRENET``
switch), see ``nn/norms.py`` and ``nn/prenets.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from speechain_tpu_torch.nn.conformer import ConformerEncoder
from speechain_tpu_torch.nn.postnets import TokenPostnet
from speechain_tpu_torch.nn.prenets import (FROM_ENV, Conv2dPrenet,
                                            EmbedPrenet)
from speechain_tpu_torch.nn.transformer import (DecoderCache,
                                                TransformerDecoder,
                                                TransformerEncoder)
from speechain_tpu_torch.ops.cuda_layernorm import fused_ln_enabled
from speechain_tpu_torch.ops.dropout import step_generator
from speechain_tpu_torch.ops.feat_norm import (FeatNormConfig, NormStats,
                                               apply_feat_norm, init_stats)
from speechain_tpu_torch.ops.frontend import (FrontendConfig, compute_logmel,
                                              to_float_wave)
from speechain_tpu_torch.ops.specaug import (SpecAugmentConfig, draw,
                                             spec_augment)
from speechain_tpu_torch.train import criteria
from speechain_tpu_torch.utils.masks import make_mask_from_len

# encoder types resolvable from module_conf 'type' strings
ENCODERS = {"transformer": TransformerEncoder, "conformer": ConformerEncoder}


@dataclasses.dataclass(frozen=True)
class ARASRConfig:
    vocab_size: int
    frontend: FrontendConfig = FrontendConfig()
    feat_norm: Optional[FeatNormConfig] = None
    specaug: Optional[SpecAugmentConfig] = None      # training only
    enc_prenet: Dict[str, Any] = dataclasses.field(default_factory=dict)
    encoder_type: str = "transformer"
    encoder: Dict[str, Any] = dataclasses.field(default_factory=dict)
    dec_emb: Dict[str, Any] = dataclasses.field(default_factory=dict)
    decoder: Dict[str, Any] = dataclasses.field(default_factory=dict)
    ctc_weight: float = 0.0
    ilm_weight: float = 0.0
    label_smoothing: float = 0.1
    att_guid_sigma: float = 0.0
    dtype: torch.dtype = torch.float32
    param_dtype: Optional[torch.dtype] = None
    fused_ln: Optional[bool] = None
    prenet_core: Optional[str] = FROM_ENV

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


class ASRFrontend(nn.Module):
    """float32 log-Mel + feature normalization (+ SpecAugment in training);
    the running statistics are buffers ``stats.<field>`` of
    :class:`NormStats`."""

    def __init__(self, frontend: FrontendConfig,
                 feat_norm: Optional[FeatNormConfig] = None,
                 specaug: Optional[SpecAugmentConfig] = None):
        super().__init__()
        self.cfg = frontend
        self.feat_norm = feat_norm
        self.specaug = specaug
        if feat_norm is not None:
            self.stats = nn.Module()
            for name, value in init_stats(feat_norm)._asdict().items():
                self.stats.register_buffer(name, value)

    def norm_stats(self) -> NormStats:
        return NormStats(*(getattr(self.stats, f)
                           for f in NormStats._fields))

    def forward(self, feat: torch.Tensor, feat_len: torch.Tensor,
                group_ids: Optional[torch.Tensor] = None, epoch=None):
        if feat.ndim == 3 and feat.shape[-1] == 1:
            # raw waveform -> log-Mel (encoder/asr.py:102-109)
            wave = to_float_wave(feat[..., 0])
            feat, feat_len, _, _ = compute_logmel(wave, feat_len, self.cfg)
        if self.feat_norm is not None:
            feat, feat_len = apply_feat_norm(
                self.norm_stats(), feat, feat_len, self.feat_norm,
                group_ids=group_ids, train=self.training, epoch=epoch)
        if self.training and self.specaug is not None:
            feat = spec_augment(feat, feat_len, self.specaug, draw(
                step_generator(), feat.shape[0], self.specaug, feat.device))
        return feat, feat_len


class ARASRNet(nn.Module):
    """The ASR network; parameters are stored in the dtype they are used
    in (see ``nn/dense.py``)."""

    def __init__(self, cfg: ARASRConfig):
        super().__init__()
        self.cfg = c = cfg
        if c.encoder_type not in ENCODERS:
            raise NotImplementedError(
                f"encoder_type {c.encoder_type!r} is not ported")
        self.frontend = ASRFrontend(c.frontend, c.feat_norm, c.specaug)
        enc = dict(c.encoder)
        self.enc_prenet = Conv2dPrenet(c.frontend.n_mels, dtype=c.dtype,
                                       core=c.prenet_core, **c.enc_prenet)
        fused_ln = fused_ln_enabled() if c.fused_ln is None else c.fused_ln
        self.encoder = ENCODERS[c.encoder_type](dtype=c.dtype,
                                                fused_ln=fused_ln, **enc)
        d_model = enc.get("d_model", 512)
        self.dec_emb = EmbedPrenet(c.vocab_size, dtype=c.dtype, **c.dec_emb)
        self.decoder = TransformerDecoder(dtype=c.dtype, fused_ln=fused_ln,
                                          **c.decoder)
        self.postnet = TokenPostnet(c.decoder.get("d_model", 512),
                                    c.vocab_size, dtype=c.dtype)
        if c.ctc_weight > 0.0:
            self.ctc_head = TokenPostnet(d_model, c.vocab_size, dtype=c.dtype)
        if c.param_dtype is not None:
            self.to(c.param_dtype)

    def encode(self, feat: torch.Tensor, feat_len: torch.Tensor,
               group_ids: Optional[torch.Tensor] = None, epoch=None):
        """feat (B, L, 1) waveform (float or int16 PCM) or (B, T, n_mels)
        features -> (enc_feat (B, T', D), enc_len (B,), enc_mask
        (B, 1, T'))."""
        feat, feat_len = self.frontend(feat, feat_len, group_ids, epoch)
        feat = feat.to(self.cfg.dtype)
        feat, feat_len = self.enc_prenet(feat, feat_len)
        mask = make_mask_from_len(feat_len, feat.shape[1])
        enc_feat, _ = self.encoder(feat, mask)
        return enc_feat, feat_len, mask

    def prime(self, enc_feat: torch.Tensor,
              cache_capacity: int) -> DecoderCache:
        return self.decoder.prime(enc_feat, cache_capacity)

    def decode_step(self, token: torch.Tensor, cache: DecoderCache,
                    enc_mask: torch.Tensor) -> torch.Tensor:
        """token (B, 1) int -> logits (B, 1, V); advances ``cache``."""
        out = self.decoder.decode_step(self.dec_emb(token), cache, enc_mask)
        return self.postnet(out)

    def ctc_logits(self, enc_feat: torch.Tensor) -> torch.Tensor:
        return self.ctc_head(enc_feat)

    def decode(self, enc_feat: torch.Tensor, enc_mask: torch.Tensor,
               text: torch.Tensor, text_len: torch.Tensor,
               cross_attmats=()):
        """Teacher-forced pass: text holds <sos/eos> at both ends; the
        input is text[:, :-1], the targets text[:, 1:]. Returns logits
        (B, L - 1, V); with layer indices in ``cross_attmats``, (logits,
        those layers' cross-attention matrices (B, H, L - 1, T))."""
        tgt_in = text[:, :-1]
        tgt_mask = make_mask_from_len(torch.clamp(text_len - 1, min=0),
                                      tgt_in.shape[1])
        out = self.decoder(self.dec_emb(tgt_in), enc_feat, tgt_mask,
                           enc_mask, cross_attmats=cross_attmats)
        if cross_attmats:
            out, _, cross = out
            return self.postnet(out), cross
        return self.postnet(out)

    def ilm_decode(self, text: torch.Tensor, text_len: torch.Tensor,
                   enc_feat: torch.Tensor) -> torch.Tensor:
        """Internal-LM logits (reference ar_asr.py:202-210): the decoder
        over zeroed encoder features of ``enc_feat``'s shape with an
        all-true mask, in evaluation mode (no dropout), differentiable."""
        parts = (self.dec_emb, self.decoder, self.postnet)
        modes = [m.training for m in parts]
        B, T = enc_feat.shape[:2]
        try:
            for m in parts:
                m.train(False)
            return self.decode(
                torch.zeros_like(enc_feat),
                torch.ones((B, 1, T), dtype=torch.bool,
                           device=enc_feat.device), text, text_len)
        finally:
            for m, mode in zip(parts, modes):
                m.train(mode)

    def forward(self, feat: torch.Tensor, feat_len: torch.Tensor,
                text: torch.Tensor, text_len: torch.Tensor, epoch=None,
                group_ids: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """The training (or validation) forward: logits, encoder lengths
        and, with a CTC weight, CTC logits; with an ILM weight the ILM's
        logits, with attention guidance the first decoder layer's
        cross-attention (``cross_att``)."""
        c = self.cfg
        enc_feat, enc_len, enc_mask = self.encode(feat, feat_len, group_ids,
                                                  epoch)
        out = dict(enc_feat_len=enc_len)
        if c.att_guid_sigma > 0.0:
            out["logits"], (out["cross_att"],) = self.decode(
                enc_feat, enc_mask, text, text_len, cross_attmats=(0,))
        else:
            out["logits"] = self.decode(enc_feat, enc_mask, text, text_len)
        if c.ctc_weight > 0.0:
            out["ctc_logits"] = self.ctc_logits(enc_feat)
        if c.ilm_weight > 0.0:
            out["ilm_logits"] = self.ilm_decode(text, text_len, enc_feat)
        return out


def arasr_loss(outputs: Dict[str, torch.Tensor], text: torch.Tensor,
               text_len: torch.Tensor, cfg: ARASRConfig):
    """CE + ctc_weight * CTC + ilm_weight * ILM-CE + attention guidance
    (reference ar_asr.py:241-270); returns (loss, metrics) as device
    tensors."""
    logits = outputs["logits"]
    ce = criteria.cross_entropy(logits, text, text_len,
                                label_smoothing=cfg.label_smoothing)
    loss = ce
    metrics = dict(ce_loss=ce,
                   accuracy=criteria.accuracy(logits, text, text_len))
    if cfg.ctc_weight > 0.0:
        # CTC targets: sos/eos stripped (reference ar_asr.py:453-458)
        ctc = criteria.ctc_loss(outputs["ctc_logits"],
                                outputs["enc_feat_len"], text[:, 1:],
                                torch.clamp(text_len - 2, min=0))
        loss = (1.0 - cfg.ctc_weight) * loss + cfg.ctc_weight * ctc
        metrics["ctc_loss"] = ctc
    if cfg.ilm_weight > 0.0:
        ilm = criteria.cross_entropy(outputs["ilm_logits"], text, text_len,
                                     label_smoothing=cfg.label_smoothing)
        loss = loss + cfg.ilm_weight * ilm
        metrics["ilm_loss"] = ilm
    if cfg.att_guid_sigma > 0.0 and "cross_att" in outputs:
        att_guid = criteria.attention_guidance(
            outputs["cross_att"], torch.clamp(text_len - 1, min=0),
            outputs["enc_feat_len"], sigma=cfg.att_guid_sigma)
        loss = loss + att_guid
        metrics["att_guid_loss"] = att_guid
    metrics["loss"] = loss
    return loss, metrics
