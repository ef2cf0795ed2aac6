"""Prenets (counterpart of ``speechain_tpu/nn/prenets.py``): token
embedding, linear, the Conv2d downsampling prenet of the ASR path, and the
TTS path's 1-D ones: :class:`Conv1dEv` (prenets.py:56), the encoder's
:class:`Conv1dPrenet` (:140), :class:`SpeakerEmbedPrenet` (:431),
FastSpeech2's :class:`Conv1dVarPredictor` (:506) and
:class:`ScalarEmbedConv` (:537). In training mode the prenets'
BatchNorms normalize with the batch statistics and update their running
ones (the reference's unfused path, prenets.py:399-428). The 1-D modules
keep flax's channels-last (B, T, C) at their interfaces; their
convolutions are plain ``F.conv1d`` (``nn/dense.py::Conv1d``), as the
reference's run outside any Pallas kernel.

The JAX prenet is channels-last (B, T, F, C); the port runs its convs
channels-first (B, C, T, F) as PyTorch does and flattens back to
(B, T', F' * C) in the reference's order.

:class:`Conv2dPrenet` also has the reference's fused routes
(prenets.py:337-397, ``ops/cuda_prenet.py``), off by default as there:
``core="xla"`` (BatchNorm-1 folded into conv1, exact gradients) or
``core="fused"`` (the CUDA core, the reference's ``"pallas"``); the
default comes from ``SPEECHAIN_FORCE_FUSED_PRENET`` /
``SPEECHAIN_DISABLE_FUSED_PRENET`` / ``SPEECHAIN_DISABLE_PALLAS`` as in the
reference (``ops/cuda_prenet.py::prenet_core_impl``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from speechain_tpu_torch.nn.dense import Conv1d, Dense
from speechain_tpu_torch.nn.feed_forward import get_activation
from speechain_tpu_torch.nn.norms import BatchNorm, LayerNorm, bn_norm
from speechain_tpu_torch.ops import cuda_prenet
from speechain_tpu_torch.ops.dropout import dropout


def _as_list(x, n=None):
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x] * (n if n is not None else 1)


def _pair(x):
    return tuple(x) if isinstance(x, (list, tuple)) else (x, x)


class EmbedPrenet(nn.Module):
    """Token embedding with optional sqrt(d) scale; ``padding_idx`` rows
    come out as zeros (prenet/embed.py:14-66)."""

    def __init__(self, vocab_size: int, embedding_dim: int,
                 scale: bool = False, emb_scale: Optional[bool] = None,
                 padding_idx: Optional[int] = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed = nn.Module()
        self.embed.weight = nn.Parameter(torch.zeros(vocab_size,
                                                     embedding_dim,
                                                     dtype=dtype))
        self.padding_idx = padding_idx
        self.scale = scale if emb_scale is None else emb_scale
        self.embedding_dim = embedding_dim
        self.dtype = dtype

    def forward(self, text: torch.Tensor) -> torch.Tensor:
        emb = F.embedding(text.long(), self.embed.weight.to(self.dtype))
        if self.padding_idx is not None:
            emb = emb.masked_fill((text == self.padding_idx)[..., None], 0.0)
        if self.scale:
            emb = emb * math.sqrt(self.embedding_dim)
        return emb


class LinearPrenet(nn.Module):
    """Stacked Linear(+activation+dropout) blocks (prenet/linear.py:18-128);
    in training each layer with a rate in ``lnr_dropout`` drops after its
    activation (the reference's flax ``Dropout``, ``nn/prenets.py:131-132``;
    masks from ``ops/dropout.py``). ``forward(feat, train=True)`` keeps
    the dropout on in evaluation mode, as the Transformer-TTS decoder's
    prenet does at inference (reference ``models/ar_tts.py:181,247``)."""

    def __init__(self, in_features: int, lnr_dims, lnr_activation="ReLU",
                 lnr_dropout=None, zero_centered: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dims = _as_list(lnr_dims)
        self.act = lnr_activation
        self.drops = (_as_list(lnr_dropout, len(self.dims))
                      if lnr_dropout is not None
                      else [None] * len(self.dims))
        self.zero_centered = zero_centered
        prev = in_features
        for i, d in enumerate(self.dims):
            self.add_module(f"linear_{i}", Dense(prev, d, dtype=dtype))
            prev = d

    def forward(self, feat: torch.Tensor,
                train: Optional[bool] = None) -> torch.Tensor:
        """``train`` None follows the module's mode."""
        train = self.training if train is None else train
        for i in range(len(self.dims)):
            feat = getattr(self, f"linear_{i}")(feat)
            if self.act is not None:
                last = i == len(self.dims) - 1
                if not (last and self.zero_centered and "ReLU" in self.act):
                    feat = get_activation(self.act)(feat)
            if self.drops[i] is not None:
                feat = dropout(feat, self.drops[i], train)
        return feat


FROM_ENV = "from_env"      # Conv2dPrenet(core=...): the reference's switch


class Conv2dPrenet(nn.Module):
    """2-D conv downsampling + linear projection, the ASR-encoder prenet
    (prenet/conv2d.py:15-280). Input (B, T, F) is a 1-channel image; each
    block is conv (stride, no padding by default) [-> BatchNorm] -> act;
    output (B, T', C*F') is optionally projected. Length recurrence:
    len = (len - kernel_t) // stride_t + 1 per block.

    ``core`` picks the route where the reference's gate
    (``_prenet_fused_impl``, prenets.py:259-279) allows a fused one: None
    (unfused), ``"xla"`` or ``"fused"``; the default reads the reference's
    environment variables. On a fused route (prenets.py:337-397) the
    BatchNorm-1 batch moments come analytically from the patch statistics
    (mean = S w1 / n1, E[x^2] = w1^T G w1 / n1, n1 = B U1 F1), turn into an
    affine (:meth:`BatchNorm.affine`) that the core applies before its
    activation, and BatchNorm-2, the activation (always, whatever
    ``zero_centered`` says, as the reference's fused route), the flatten
    and the linear layers follow. The fused core returns ZERO as the
    input's gradient (``ops/cuda_prenet.py``; its statistics see a
    detached input for the same reason): right only because nothing
    upstream of the prenet has parameters. The ``"xla"`` core's input
    gradients are exact.
    """

    def __init__(self, in_features: int,
                 conv_dims: Union[int, Sequence[int]] = (64, 64),
                 conv_kernel=3, conv_stride=2, conv_padding=0,
                 conv_batchnorm: bool = False,
                 conv_activation: Optional[str] = "ReLU",
                 conv_dropout=None, lnr_dims=512,
                 lnr_activation: Optional[str] = None, lnr_dropout=None,
                 zero_centered: bool = False,
                 dtype: torch.dtype = torch.float32,
                 bn_axis_name: Optional[str] = None,
                 core: Optional[str] = FROM_ENV):
        super().__init__()
        self.conv_dims = _as_list(conv_dims)
        self.kernel, self.stride = _pair(conv_kernel), _pair(conv_stride)
        self.pad = _pair(conv_padding)
        self.batchnorm = conv_batchnorm
        self.act = conv_activation
        self.drops = (_as_list(conv_dropout, len(self.conv_dims))
                      if conv_dropout is not None
                      else [None] * len(self.conv_dims))
        self.zero_centered = zero_centered
        self.has_linear = lnr_dims is not None
        self.dtype = dtype
        if core == FROM_ENV:
            core = cuda_prenet.prenet_core_impl()
        if core not in (None, "xla", "fused"):
            raise ValueError(f"Conv2dPrenet: core must be None, 'xla' or "
                             f"'fused', got {core!r}")
        self.core = core
        cin, f = 1, in_features
        for i, dim in enumerate(self.conv_dims):
            conv = nn.Module()
            conv.weight = nn.Parameter(torch.zeros(dim, cin, *self.kernel,
                                                   dtype=dtype))
            conv.bias = (None if conv_batchnorm else
                         nn.Parameter(torch.zeros(dim, dtype=dtype)))
            self.add_module(f"conv_{i}", conv)
            if conv_batchnorm:
                self.add_module(f"batchnorm_{i}",
                                BatchNorm(dim, epsilon=1e-5, dtype=dtype))
            cin = dim
            f = (f + 2 * self.pad[1] - self.kernel[1]) // self.stride[1] + 1
        if self.has_linear:
            self.linear = LinearPrenet(cin * f, lnr_dims, lnr_activation,
                                       lnr_dropout=lnr_dropout,
                                       zero_centered=zero_centered,
                                       dtype=dtype)

    def out_len(self, feat_len: torch.Tensor) -> torch.Tensor:
        for _ in self.conv_dims:
            feat_len = ((feat_len + 2 * self.pad[0] - self.kernel[0])
                        // self.stride[0] + 1)
        return feat_len

    def fused_route(self, T: int, F: int) -> Optional[str]:
        """The route for a (B, T, F) input: ``core`` where the reference's
        gate (prenets.py:259-279) allows a fused one, else None."""
        dims = self.conv_dims
        if (self.core is None or len(dims) != 2 or dims[0] != dims[1]
                or dims[0] % 128 != 0 or self.kernel != (3, 3)
                or self.stride != (2, 2) or self.pad != (0, 0)
                or not self.batchnorm or any(d is not None
                                             for d in self.drops)
                or self.act is None):
            return None
        _, _, T2, F2 = cuda_prenet.geom(T, F)
        return self.core if T2 >= 2 and F2 >= 1 else None

    def forward(self, feat: torch.Tensor, feat_len: torch.Tensor):
        route = self.fused_route(feat.shape[1], feat.shape[2])
        if route is not None:
            x = self._fused(feat.to(self.dtype), route)
        else:
            x = self._unfused(feat.to(self.dtype))
        B, T2, F2, C = x.shape
        feat = x.reshape(B, T2, F2 * C)
        feat_len = self.out_len(feat_len)
        if self.has_linear:
            feat = self.linear(feat)
        return feat, feat_len

    def _unfused(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, F) -> (B, T2, F2, C) through the conv blocks; in training
        a block with a rate in ``conv_dropout`` drops after its activation
        step, over the reference's channels-last layout (``nn/prenets.py:
        415-416``)."""
        x = x[:, None]                                   # (B, 1, T, F)
        n = len(self.conv_dims)
        for i in range(n):
            conv = getattr(self, f"conv_{i}")
            x = F.conv2d(x, conv.weight.to(self.dtype),
                         None if conv.bias is None
                         else conv.bias.to(self.dtype),
                         stride=self.stride, padding=self.pad)
            if self.batchnorm:
                bn = getattr(self, f"batchnorm_{i}")
                mean, var = bn.statistics(x, (0, 2, 3))
                view = (-1, 1, 1)
                x = bn_norm(x, mean.view(view), var.view(view),
                            bn.weight.float().view(view),
                            bn.bias.float().view(view),
                            bn.epsilon).to(self.dtype)
            if self.act is not None:
                last = i == n - 1 and not self.has_linear
                if not (last and self.zero_centered and "ReLU" in self.act):
                    x = get_activation(self.act)(x)
            if self.drops[i] is not None:
                x = dropout(x.permute(0, 2, 3, 1), self.drops[i],
                            self.training).permute(0, 3, 1, 2)
        return x.permute(0, 2, 3, 1)

    def _fused(self, mel: torch.Tensor, route: str) -> torch.Tensor:
        """(B, T, F) in the compute dtype -> (B, T2, F2, C), activated
        after BatchNorm-2, on the fused route."""
        B, T, Fm = mel.shape
        U1, F1, _, _ = cuda_prenet.geom(T, Fm)
        C = self.conv_dims[0]
        w1 = self.conv_0.weight.float().reshape(C, 9).t()     # (9, C)
        w2 = self.conv_1.weight.float().permute(2, 3, 1, 0).reshape(9, C, C)
        bn1 = self.batchnorm_0
        if bn1.training:
            M = cuda_prenet.build_patches_std(
                mel if route == "xla" else mel.detach())
            S, G = cuda_prenet.patch_stats_std(M)
            n1 = B * U1 * F1
            mean1 = (S @ w1) / n1
            mean2 = torch.einsum("jc,jk,kc->c", w1, G, w1) / n1
        else:
            mean1 = mean2 = None
        g1, b1 = bn1.affine(mean1, mean2)
        if route == "xla":
            x = cuda_prenet.xla_prenet_core(
                cuda_prenet.build_patches_std(mel), w1, g1, b1, w2, self.act)
        else:
            x = cuda_prenet.fused_prenet_core(mel, w1, g1, b1, w2, self.act)
        x = self.batchnorm_1(x)
        return get_activation(self.act)(x)


# ------------------------------------------------------------ 1-D prenets

class Conv1dEv(nn.Module):
    """1-D conv with 'valid' / 'full' / 'same' / 'causal' padding
    (prenet/conv1d.py:21-122, reference prenets.py:56) over (B, T, C); an
    even kernel's 'same' pads d k / 2 on both sides and drops the last
    ``dilation`` outputs, as the reference does."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, stride: int = 1, dilation: int = 1,
                 padding_mode: str = "same", use_bias: bool = True,
                 groups: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        k, d = kernel_size, dilation
        self.cutoff = 0
        if padding_mode == "valid":
            pad = (0, 0)
        elif padding_mode == "full":
            pad = (d * (k - 1),) * 2
        elif padding_mode == "same":
            if stride != 1:
                raise ValueError("stride must be 1 for 'same' padding")
            if k % 2 == 0:
                pad, self.cutoff = (d * k // 2,) * 2, d
            else:
                pad = (d * (k - 1) // 2,) * 2
        elif padding_mode == "causal":
            pad = (d * (k - 1), 0)
        else:
            raise ValueError(f"unsupported padding mode {padding_mode!r}")
        self.conv_lyr = Conv1d(in_channels, out_channels, k, stride, d, pad,
                               use_bias, groups, dtype)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        out = self.conv_lyr(feat)
        return out[:, :-self.cutoff] if self.cutoff else out


class Conv1dPrenet(nn.Module):
    """Conv1d blocks (+BatchNorm+activation+dropout), then optional Linear
    blocks: the TTS encoder's prenet (prenet/conv1d.py:131-324, reference
    prenets.py:140). ``lnr_dims`` entries of -1 inherit the previous
    width. ``forward(feat, feat_len)`` returns (feat, feat_len)."""

    def __init__(self, in_channels: int, conv_dims=(512, 512, 512),
                 conv_kernel: int = 5, conv_stride: int = 1,
                 conv_batchnorm: bool = True,
                 conv_activation: Optional[str] = "ReLU",
                 conv_dropout=None, lnr_dims=-1,
                 lnr_activation: Optional[str] = None, lnr_dropout=None,
                 zero_centered: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_dims = _as_list(conv_dims)
        self.drops = (_as_list(conv_dropout, len(self.conv_dims))
                      if conv_dropout is not None
                      else [None] * len(self.conv_dims))
        self.batchnorm, self.act = conv_batchnorm, conv_activation
        self.zero_centered = zero_centered
        self.has_linear = lnr_dims is not None
        cin = in_channels
        for i, dim in enumerate(self.conv_dims):
            self.add_module(f"conv_{i}", Conv1dEv(
                cin, dim, conv_kernel, conv_stride, padding_mode="same",
                use_bias=not conv_batchnorm, dtype=dtype))
            if conv_batchnorm:
                self.add_module(f"batchnorm_{i}",
                                BatchNorm(dim, epsilon=1e-5, dtype=dtype))
            cin = dim
        if self.has_linear:
            dims, prev = [], cin
            for d in _as_list(lnr_dims):
                prev = prev if d == -1 else d
                dims.append(prev)
            self.linear = LinearPrenet(cin, dims, lnr_activation,
                                       lnr_dropout=lnr_dropout,
                                       zero_centered=zero_centered,
                                       dtype=dtype)

    def forward(self, feat: torch.Tensor,
                feat_len: Optional[torch.Tensor] = None):
        n = len(self.conv_dims)
        for i in range(n):
            feat = getattr(self, f"conv_{i}")(feat)
            if self.batchnorm:
                feat = getattr(self, f"batchnorm_{i}")(feat)
            if self.act is not None:
                last = i == n - 1 and not self.has_linear
                if not (last and self.zero_centered and "ReLU" in self.act):
                    feat = get_activation(self.act)(feat)
            if self.drops[i] is not None:
                feat = dropout(feat, self.drops[i], self.training)
        if self.has_linear:
            feat = self.linear(feat)
        return feat, feat_len


class SpeakerEmbedPrenet(nn.Module):
    """Speaker-embedding combination (prenet/spk_embed.py:7-230, reference
    prenets.py:431): a lookup table (``spk_num``) and/or external speaker
    features (``spk_emb_dim_pretrained``), each L2-normalized and
    projected to d_model, then added to a (B, T, D) sequence or
    concatenated to it and projected. ``enc_dim``: the width of the
    sequence combined ``where="enc"`` where it differs from d_model (the
    Transformer-TTS encoder's, wider than its decoder); flax infers it."""

    def __init__(self, d_model: int, spk_emb_dim_lookup: Optional[int] = None,
                 spk_num: Optional[int] = None,
                 spk_emb_dim_pretrained: Optional[int] = None,
                 spk_emb_comb: str = "concat", use_dec_comb: bool = False,
                 dtype: torch.dtype = torch.float32,
                 enc_dim: Optional[int] = None):
        super().__init__()
        self.use_lookup = spk_num is not None
        self.use_pretrained = spk_emb_dim_pretrained is not None
        if not (self.use_lookup or self.use_pretrained):
            raise ValueError("SpeakerEmbedPrenet needs spk_num or "
                             "spk_emb_dim_pretrained")
        self.comb, self.dtype = spk_emb_comb, dtype
        self.use_dec_comb = use_dec_comb
        if self.use_lookup:
            dim = spk_emb_dim_lookup or d_model
            self.lookup = nn.Module()
            self.lookup.weight = nn.Parameter(torch.zeros(spk_num, dim,
                                                          dtype=dtype))
            self.lookup_proj = Dense(dim, d_model, dtype=dtype)
        if self.use_pretrained:
            self.pretrained_proj = Dense(spk_emb_dim_pretrained, d_model,
                                         dtype=dtype)
        n_emb = int(self.use_lookup) + int(self.use_pretrained)
        if spk_emb_comb == "concat":
            self.enc_comb_proj = Dense((enc_dim or d_model) + n_emb * d_model,
                                       d_model, dtype=dtype)
            if use_dec_comb:
                self.dec_comb_proj = Dense((1 + n_emb) * d_model, d_model,
                                           dtype=dtype)

    @staticmethod
    def _l2(e: torch.Tensor) -> torch.Tensor:
        return e / torch.clamp(torch.linalg.vector_norm(
            e, dim=-1, keepdim=True), min=1e-12)

    def embed(self, spk_ids: Optional[torch.Tensor] = None,
              spk_feat: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        """The projected, L2-normalized speaker embeddings, (B, D) each."""
        embs = []
        if self.use_lookup:
            if spk_ids is None:
                raise ValueError("a speaker lookup table needs spk_ids")
            e = F.embedding(spk_ids.long(), self.lookup.weight.to(self.dtype))
            embs.append(self.lookup_proj(self._l2(e)))
        if self.use_pretrained:
            if spk_feat is None:
                raise ValueError("external speaker embeddings need spk_feat")
            embs.append(self.pretrained_proj(self._l2(spk_feat)))
        return embs

    def combine(self, feat: torch.Tensor, embs: List[torch.Tensor], *,
                where: str = "enc") -> torch.Tensor:
        if self.comb == "add":
            for e in embs:
                feat = feat + e[:, None, :]
            return feat
        B, T = feat.shape[:2]
        cat = torch.cat([feat] + [e[:, None, :].expand(B, T, e.shape[-1])
                                  for e in embs], dim=-1)
        proj = self.enc_comb_proj if where == "enc" else self.dec_comb_proj
        return proj(cat)

    def forward(self, feat, spk_ids=None, spk_feat=None) -> torch.Tensor:
        return self.combine(feat, self.embed(spk_ids, spk_feat), where="enc")


class Conv1dVarPredictor(nn.Module):
    """FastSpeech2's variance predictor (prenet/var_pred.py:42-240,
    reference prenets.py:506): [Conv1d -> ReLU -> LayerNorm -> Dropout] x
    N -> Linear -> a scalar a token, and an optional duration-gate head.
    Its LayerNorm is flax's ``nn.LayerNorm`` (epsilon 1e-6), plain here as
    there. ``forward`` returns (scalar, gate or None), (B, T) each."""

    def __init__(self, in_channels: int, conv_dims=(256, 256),
                 conv_kernel: int = 3, conv_dropout=0.5,
                 use_gate: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_dims = _as_list(conv_dims)
        self.drops = _as_list(conv_dropout, len(self.conv_dims))
        cin = in_channels
        for i, dim in enumerate(self.conv_dims):
            self.add_module(f"conv_{i}", Conv1dEv(cin, dim, conv_kernel,
                                                  padding_mode="same",
                                                  dtype=dtype))
            self.add_module(f"layernorm_{i}", LayerNorm(dim, fused=False))
            cin = dim
        self.pred_head = Dense(cin, 1, dtype=dtype)
        self.gate_head = Dense(cin, 1, dtype=dtype) if use_gate else None

    def forward(self, feat: torch.Tensor):
        for i in range(len(self.conv_dims)):
            feat = torch.relu(getattr(self, f"conv_{i}")(feat))
            feat = getattr(self, f"layernorm_{i}")(feat)
            feat = dropout(feat, self.drops[i], self.training)
        gate = (None if self.gate_head is None
                else self.gate_head(feat)[..., 0])
        return self.pred_head(feat)[..., 0], gate


class ScalarEmbedConv(nn.Module):
    """A scalar sequence (B, T) re-embedded to (B, T, out_dim) by a Conv1d
    (var_pred.py:185-240 ``emb_pred_scalar``, reference prenets.py:537)."""

    def __init__(self, out_dim: int, kernel_size: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.emb_conv = Conv1dEv(1, out_dim, kernel_size,
                                 padding_mode="same", dtype=dtype)

    def forward(self, scalar: torch.Tensor) -> torch.Tensor:
        return self.emb_conv(scalar[..., None])
