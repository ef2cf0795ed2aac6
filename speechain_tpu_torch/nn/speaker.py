"""Speaker encoders: ECAPA-TDNN and x-vector (192-d embeddings).

Counterpart of ``speechain_tpu/nn/speaker.py``. Inference only: offline
speaker-feature extraction (``pyscripts/spk_feat_extractor.py``) and
speaker-similarity evaluation (``pyscripts/spk_sim_evaluation.py``). Input
is (B, T, n_mels) log-Mel, channels last as in the reference; the modules
transpose once and run ``F.conv1d`` channels first. Output: L2-normalized
(B, 192).

The parameter names are the reference's torch ``EncoderClassifier``
layout (its ``nn.Sequential``: ``model.0``, ``model.3.0.convs.{i}``,
``model.3.1.se.{1,3}``, ``model.3.2``, ``model.6``; for x-vector
``model.{0,1,3,4,6,7,11,13}``), so an ``encoder.pth`` state dict loads
with ``load_state_dict(strict=True)`` once ``num_batches_tracked`` is
dropped. The parameter-free places of that sequence (activations, the
pooling, the flatten) are ``nn.Identity``: the forward pass calls the
layers itself, with a length-masked mean for the pooling.

BatchNorm runs in inference mode (running statistics, eps 1e-5 as
flax's). cuDNN would take TF32 for the float32 convolutions unless told
not to, which the entry points do (``utils/device.py``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

EMB_DIM = 192


class SEModule(nn.Module):
    """Squeeze-and-excitation over channels, (B, C, T) -> (B, C, T): the
    gate from the mean over every frame (the reference masks nothing
    here)."""

    def __init__(self, channels: int, bottleneck: int = 128):
        super().__init__()
        self.se = nn.Sequential(nn.Identity(),
                                nn.Conv1d(channels, bottleneck, 1),
                                nn.Identity(),
                                nn.Conv1d(bottleneck, channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=2, keepdim=True)
        s = self.se[3](F.relu(self.se[1](s)))
        return x * torch.sigmoid(s)


class Res2Block(nn.Module):
    """Res2Net split-conv block, (B, C, T) -> (B, C, T), with the
    reference's dataflow: each conv takes the previous conv's output (not
    conv + split), and the output adds the first ``scale`` entries of the
    interleaved list [s0, c0, s1, c1, ...]."""

    def __init__(self, channels: int, kernel_size: int = 3, scale: int = 8):
        super().__init__()
        self.scale = scale
        self.width = channels // scale
        self.convs = nn.ModuleList(
            nn.Conv1d(self.width, self.width, kernel_size,
                      padding=kernel_size // 2) for _ in range(scale - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        splits = torch.split(x, self.width, dim=1)
        out = splits[0]
        outputs = [out]
        for conv, split in zip(self.convs, splits[1:]):
            out = conv(F.relu(out))
            outputs.append(out)
            outputs.append(split)
        return x + torch.cat(outputs[: self.scale], dim=1)


def _masked_mean(x: torch.Tensor, feat_len: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """(B, C, T) -> (B, C): the mean over the first ``feat_len`` frames,
    over max(their count, 1)."""
    if feat_len is None:
        return x.mean(dim=2)
    pos = torch.arange(x.shape[2], device=x.device)
    valid = (pos[None, :] < feat_len.to(x.device)[:, None]).to(x.dtype)
    return ((x * valid[:, None, :]).sum(2)
            / torch.clamp(valid.sum(1, keepdim=True), min=1.0))


class EncoderClassifier(nn.Module):
    """ECAPA or x-vector encoder: (B, T, 80) log-Mel and optional
    ``feat_len`` (B,) -> (B, 192) L2-normalized embeddings."""

    def __init__(self, model_type: str = "ecapa", n_mels: int = 80):
        super().__init__()
        self.model_type = model_type
        I = nn.Identity
        if model_type == "ecapa":
            ch = 512
            self.model = nn.Sequential(
                nn.Conv1d(n_mels, ch, 7, padding=3), nn.BatchNorm1d(ch), I(),
                nn.Sequential(Res2Block(ch), SEModule(ch),
                              nn.BatchNorm1d(ch)),
                I(), I(), nn.Linear(ch, EMB_DIM))
        elif model_type == "xvector":
            self.model = nn.Sequential(
                nn.Conv1d(n_mels, 512, 5, padding=2), nn.BatchNorm1d(512),
                I(),
                nn.Conv1d(512, 512, 3, padding=1), nn.BatchNorm1d(512), I(),
                nn.Conv1d(512, 512, 3, padding=1), nn.BatchNorm1d(512), I(),
                I(), I(), nn.Linear(512, 512), I(), nn.Linear(512, EMB_DIM))
        else:
            raise ValueError(model_type)
        self.eval()

    def forward(self, feat: torch.Tensor,
                feat_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        m = self.model
        x = feat.transpose(1, 2)                          # (B, C, T)
        if self.model_type == "ecapa":
            x = F.relu(m[1](m[0](x)))
            res2, se, bn2 = m[3]
            x = bn2(se(res2(x)))
            emb = m[6](_masked_mean(x, feat_len))
        else:
            for conv, bn in ((0, 1), (3, 4), (6, 7)):
                x = F.relu(m[bn](m[conv](x)))
            emb = m[13](F.relu(m[11](_masked_mean(x, feat_len))))
        return emb / torch.clamp(torch.linalg.vector_norm(
            emb, dim=-1, keepdim=True), min=1e-12)


def extract_spk_feat(model_type: str, state_dict, feat: torch.Tensor,
                     feat_len: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Batch speaker embeddings: an encoder of ``model_type`` with
    ``state_dict`` on ``feat``'s device, without autograd."""
    model = EncoderClassifier(model_type=model_type)
    model.load_state_dict(speaker_state_dict(state_dict), strict=True)
    with torch.inference_mode():
        return model.to(feat.device)(feat, feat_len)


def speaker_cosine_similarity(emb_a: torch.Tensor,
                              emb_b: torch.Tensor) -> torch.Tensor:
    """Cosine similarity of L2-normalized embeddings."""
    return (emb_a * emb_b).sum(-1)


# --------------------------------------------------------------------------
# Checkpoints: the reference's encoder.pth is a torch state dict in the
# layout above, so it loads as it is
# --------------------------------------------------------------------------

def speaker_state_dict(state_dict) -> Dict[str, torch.Tensor]:
    """A reference speaker-encoder state dict as float32 CPU tensors,
    without BatchNorm's ``num_batches_tracked``."""
    return {k: torch.as_tensor(v).detach().to("cpu", torch.float32)
            for k, v in state_dict.items()
            if not k.endswith("num_batches_tracked")}


def load_speaker_encoder(checkpoint_path: str, model_type: str = "ecapa"
                         ) -> Tuple[EncoderClassifier, Dict[str, torch.Tensor]]:
    """Load a local torch speaker-encoder checkpoint (.pt/.pth, the
    reference's ``encoder.pth``): (model with the weights loaded, its
    state dict)."""
    sd = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = speaker_state_dict(sd)
    model = EncoderClassifier(model_type=model_type)
    model.load_state_dict(sd, strict=True)
    return model.eval(), sd


def restore_speaker_variables(checkpoint: str, model_type: str = "ecapa"
                              ) -> Dict[str, torch.Tensor]:
    """The entry points' restore: a torch .pt/.pth/.ckpt state dict. An
    orbax checkpoint directory cannot be read here (ROADMAP.md A6):
    convert it with the JAX package's tools to a state dict first."""
    if os.path.isfile(checkpoint) and checkpoint.endswith(
            (".pt", ".pth", ".ckpt")):
        return load_speaker_encoder(checkpoint, model_type)[1]
    raise NotImplementedError(
        f"{checkpoint!r} is not a .pt/.pth/.ckpt state dict; reading orbax "
        "checkpoints is not ported yet (ROADMAP.md A6)")
