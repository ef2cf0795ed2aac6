"""Autoregressive attention ASR, serving path (counterpart of
``speechain_tpu/models/ar_asr.py``): conformer encoder + KV-cached
transformer decoder, with an optional CTC head.

:class:`ARASRNet` offers what decoding needs: :meth:`~ARASRNet.encode`
(waveform or features -> encoder output), :meth:`~ARASRNet.prime` and
:meth:`~ARASRNet.decode_step` (single-step KV-cached decoding) and
:meth:`~ARASRNet.ctc_logits`. The frontend is the float32 log-Mel plus
feature normalization from frozen statistics; SpecAugment, the criteria
and the loss come with the training slice, the transformer encoder with a
later one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from speechain_tpu_torch.nn.conformer import ConformerEncoder
from speechain_tpu_torch.nn.postnets import TokenPostnet
from speechain_tpu_torch.nn.prenets import Conv2dPrenet, EmbedPrenet
from speechain_tpu_torch.nn.transformer import DecoderCache, TransformerDecoder
from speechain_tpu_torch.ops.feat_norm import (FeatNormConfig, NormStats,
                                               apply_feat_norm, init_stats)
from speechain_tpu_torch.ops.frontend import (FrontendConfig, compute_logmel,
                                              to_float_wave)
from speechain_tpu_torch.utils.masks import make_mask_from_len


@dataclasses.dataclass(frozen=True)
class ARASRConfig:
    vocab_size: int
    frontend: FrontendConfig = FrontendConfig()
    feat_norm: Optional[FeatNormConfig] = None
    specaug: Any = None                  # training only
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

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


class ASRFrontend(nn.Module):
    """float32 log-Mel + feature normalization; the running statistics are
    buffers ``stats.<field>`` of :class:`NormStats`."""

    def __init__(self, frontend: FrontendConfig,
                 feat_norm: Optional[FeatNormConfig] = None):
        super().__init__()
        self.cfg = frontend
        self.feat_norm = feat_norm
        if feat_norm is not None:
            self.stats = nn.Module()
            for name, value in init_stats(feat_norm)._asdict().items():
                self.stats.register_buffer(name, value)

    def norm_stats(self) -> NormStats:
        return NormStats(*(getattr(self.stats, f)
                           for f in NormStats._fields))

    def forward(self, feat: torch.Tensor, feat_len: torch.Tensor,
                group_ids: Optional[torch.Tensor] = None):
        if feat.ndim == 3 and feat.shape[-1] == 1:
            # raw waveform -> log-Mel (encoder/asr.py:102-109)
            wave = to_float_wave(feat[..., 0])
            feat, feat_len, _, _ = compute_logmel(wave, feat_len, self.cfg)
        if self.feat_norm is not None:
            feat, feat_len = apply_feat_norm(
                self.norm_stats(), feat, feat_len, self.feat_norm,
                group_ids=group_ids)
        return feat, feat_len


class ARASRNet(nn.Module):
    """The ASR network; parameters are stored in the dtype they are used
    in (see ``nn/dense.py``)."""

    def __init__(self, cfg: ARASRConfig):
        super().__init__()
        self.cfg = c = cfg
        if c.encoder_type != "conformer":
            raise NotImplementedError(
                f"encoder_type {c.encoder_type!r} is not ported yet")
        self.frontend = ASRFrontend(c.frontend, c.feat_norm)
        enc = dict(c.encoder)
        self.enc_prenet = Conv2dPrenet(c.frontend.n_mels, dtype=c.dtype,
                                       **c.enc_prenet)
        self.encoder = ConformerEncoder(dtype=c.dtype, **enc)
        d_model = enc.get("d_model", 512)
        self.dec_emb = EmbedPrenet(c.vocab_size, dtype=c.dtype, **c.dec_emb)
        self.decoder = TransformerDecoder(dtype=c.dtype, **c.decoder)
        self.postnet = TokenPostnet(c.decoder.get("d_model", 512),
                                    c.vocab_size, dtype=c.dtype)
        if c.ctc_weight > 0.0:
            self.ctc_head = TokenPostnet(d_model, c.vocab_size, dtype=c.dtype)

    def encode(self, feat: torch.Tensor, feat_len: torch.Tensor,
               group_ids: Optional[torch.Tensor] = None):
        """feat (B, L, 1) waveform (float or int16 PCM) or (B, T, n_mels)
        features -> (enc_feat (B, T', D), enc_len (B,), enc_mask
        (B, 1, T'))."""
        feat, feat_len = self.frontend(feat, feat_len, group_ids)
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
