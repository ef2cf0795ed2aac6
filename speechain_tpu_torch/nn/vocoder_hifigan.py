"""HiFi-GAN generator, the inference vocoder (counterpart of
``speechain_tpu/nn/vocoder_hifigan.py``; reference
module/vocoder/hifigan.py:38-397, SpeechBrain layout): conv_pre ->
[LeakyReLU -> upsampling ConvTranspose -> the mean of the multi-receptive-
field ResBlocks] x 4 -> LeakyReLU -> conv_post -> tanh.

Every convolution is plain ``F.conv1d`` / ``F.conv_transpose1d`` in
float32, as the reference computes them outside any Pallas kernel. The
module keeps the reference's interface, (B, T, n_mels) log-Mel in and
(B, T * prod(upsample_factors)) waveform out, and runs channels-first
(B, C, T) in between, PyTorch's convolution layout. The reference's flax
``ConvTranspose(transpose_kernel=True, padding=k - 1 - (k - f) // 2)`` is
PyTorch's ``ConvTranspose1d`` with padding (k - f) // 2, its weight (in,
out, K) the flax kernel (K, out, in) transposed (``utils/weights.py``);
'SAME' convolutions with odd kernels pad d (k - 1) / 2 on both sides.

:func:`load_torch_hifigan` maps a PyTorch HiFi-GAN state dict in
SpeechBrain's key layout, weight-normalized or not, onto this module's;
:func:`_fold_weight_norm` folds g * v / ||v|| into plain weights, as the
reference's ``remove_weight_norm`` does. The repository holds no vocoder
checkpoint: the state dict comes from the caller's memory.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from speechain_tpu_torch.nn.dense import Conv1d

HIFIGAN_DEFAULT_CONFIG = dict(
    in_channels=80,
    resblock_type="1",
    resblock_dilation_sizes=((1, 3, 5), (1, 3, 5), (1, 3, 5)),
    resblock_kernel_sizes=(3, 7, 11),
    upsample_kernel_sizes=(16, 16, 4, 4),
    upsample_initial_channel=512,
    upsample_factors=(8, 8, 2, 2),
)

LRELU = 0.1


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LRELU)


class ResBlock1(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Tuple[int, ...] = (1, 3, 5)):
        super().__init__()
        self.n = len(dilation)
        for i, d in enumerate(dilation):
            self.add_module(f"convs1_{i}", Conv1d(channels, channels,
                                                  kernel_size, dilation=d))
            self.add_module(f"convs2_{i}", Conv1d(channels, channels,
                                                  kernel_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C, T)."""
        for i in range(self.n):
            xt = getattr(self, f"convs1_{i}")(_lrelu(x), channels_last=False)
            xt = getattr(self, f"convs2_{i}")(_lrelu(xt),
                                              channels_last=False)
            x = xt + x
        return x


class ResBlock2(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Tuple[int, ...] = (1, 3)):
        super().__init__()
        self.n = len(dilation)
        for i, d in enumerate(dilation):
            self.add_module(f"convs_{i}", Conv1d(channels, channels,
                                                 kernel_size, dilation=d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"convs_{i}")(_lrelu(x),
                                            channels_last=False) + x
        return x


class ConvTranspose1d(nn.Module):
    """Upsampling by ``stride``: weight (in, out, K), padding
    (K - stride) // 2, so T inputs give T * stride outputs where K - stride
    is even."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, stride: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(in_channels, out_channels,
                                               kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.stride = stride
        self.padding = (kernel_size - stride) // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose1d(x, self.weight, self.bias, self.stride,
                                  self.padding)


class HiFiGAN(nn.Module):
    """Generator: (B, T, n_mels) log-Mel -> (B, T * prod(factors)) wave,
    float32."""

    def __init__(self, in_channels: int = 80, resblock_type: str = "1",
                 resblock_dilation_sizes: Sequence = ((1, 3, 5),) * 3,
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
                 upsample_initial_channel: int = 512,
                 upsample_factors: Sequence[int] = (8, 8, 2, 2)):
        super().__init__()
        self.upsample_factors = tuple(upsample_factors)
        self.num_kernels = len(resblock_kernel_sizes)
        self.conv_pre = Conv1d(in_channels, upsample_initial_channel, 7)
        res_cls = ResBlock1 if resblock_type == "1" else ResBlock2
        ch = upsample_initial_channel
        for i, (f, k) in enumerate(zip(upsample_factors,
                                       upsample_kernel_sizes)):
            out = upsample_initial_channel // (2 ** (i + 1))
            self.add_module(f"ups_{i}", ConvTranspose1d(ch, out, k, f))
            for j, (rk, rd) in enumerate(zip(resblock_kernel_sizes,
                                             resblock_dilation_sizes)):
                self.add_module(f"resblocks_{i * self.num_kernels + j}",
                                res_cls(out, rk, tuple(rd)))
            ch = out
        self.conv_post = Conv1d(ch, 1, 7)

    @property
    def hop(self) -> int:
        """Samples per mel frame: the product of the upsampling factors."""
        return int(np.prod(self.upsample_factors))

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.conv_pre(mel.float().transpose(1, 2), channels_last=False)
        for i in range(len(self.upsample_factors)):
            x = getattr(self, f"ups_{i}")(_lrelu(x))
            xs = None
            for j in range(self.num_kernels):
                out = getattr(self, f"resblocks_{i * self.num_kernels + j}")(
                    x)
                xs = out if xs is None else xs + out
            x = xs / self.num_kernels
        x = self.conv_post(_lrelu(x), channels_last=False)
        return torch.tanh(x)[:, 0]


def _f32(x) -> torch.Tensor:
    """An array or CPU tensor as a float32 tensor."""
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


def _fold_weight_norm(sd: Mapping, prefix: str) -> torch.Tensor:
    """weight_norm(g, v) -> g * v / ||v||, the norm over every axis but
    the first (reference vocoder_hifigan.py:117)."""
    g, v = _f32(sd[prefix + ".weight_g"]), _f32(sd[prefix + ".weight_v"])
    norm = torch.sqrt((v ** 2).sum(dim=tuple(range(1, v.ndim)),
                                   keepdim=True))
    return g * v / torch.clamp(norm, min=1e-12)


def load_torch_hifigan(state_dict: Mapping, config: Dict = None
                       ) -> Dict[str, torch.Tensor]:
    """A PyTorch HiFi-GAN state dict in SpeechBrain's layout (``conv_pre``,
    ``ups.<i>``, ``resblocks.<r>.convs1.<j>`` ..., raw or weight-normed
    keys; reference vocoder_hifigan.py:126) -> this module's state dict.
    The weights keep PyTorch's layouts, so only names change and weight
    norms fold."""
    config = {**HIFIGAN_DEFAULT_CONFIG, **(config or {})}

    def weight(prefix):
        if prefix + ".weight_g" in state_dict:
            return _fold_weight_norm(state_dict, prefix)
        return _f32(state_dict[prefix + ".weight"])

    out: Dict[str, torch.Tensor] = {}

    def put(name, prefix):
        out[name + ".weight"] = weight(prefix)
        out[name + ".bias"] = _f32(state_dict[prefix + ".bias"])

    put("conv_pre", "conv_pre")
    put("conv_post", "conv_post")
    n_up = len(config["upsample_factors"])
    for i in range(n_up):
        put(f"ups_{i}", f"ups.{i}")
    n_conv = len(config["resblock_dilation_sizes"][0])
    convs = (("convs1", "convs2") if config["resblock_type"] == "1"
             else ("convs",))
    for r in range(n_up * len(config["resblock_kernel_sizes"])):
        for j in range(n_conv):
            for which in convs:
                put(f"resblocks_{r}.{which}_{j}",
                    f"resblocks.{r}.{which}.{j}")
    return out
