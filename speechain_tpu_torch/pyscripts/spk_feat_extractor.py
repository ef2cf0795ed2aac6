"""Offline speaker-embedding extraction: idx2wav -> .npy embeddings.

Counterpart of ``speechain_tpu/pyscripts/spk_feat_extractor.py``: ECAPA-TDNN
or x-vector embeddings (192-d) from 80-bin log-Mel features, one .npy a
utterance and an ``idx2spk_feat`` file beside them::

    python -m speechain_tpu_torch.pyscripts.spk_feat_extractor \\
        --wav_path data/idx2wav --save_path data/spk_feat \\
        --checkpoint encoder.pth [--spk_model xvector] [--device cpu]

The checkpoint is a torch state dict in the reference's layout (its
``encoder.pth``). The log-Mel runs on the card's log-Mel kernel unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from speechain_tpu_torch.nn.speaker import (EncoderClassifier,
                                            restore_speaker_variables)
from speechain_tpu_torch.ops.frontend import FrontendConfig, LogMelFrontend
from speechain_tpu_torch.utils.device import (resolve_device,
                                              set_fp32_matmul_exact)
from speechain_tpu_torch.utils.fileio import (read_data_by_path,
                                              read_idx2data_file,
                                              write_idx2data_file)


def make_embedder(spk_model: str, checkpoint: str, sr: int, device):
    """``embed(wave)``: one waveform (numpy) -> its (192,) float32
    embedding, the encoder and the frontend on ``device``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_fp32_matmul_exact()
    model = EncoderClassifier(model_type=spk_model)
    model.load_state_dict(restore_speaker_variables(checkpoint, spk_model),
                          strict=True)
    model.to(dev).eval()
    fe = LogMelFrontend(FrontendConfig(sr=sr, n_mels=80))

    def embed(wave: np.ndarray) -> np.ndarray:
        wave = torch.from_numpy(np.asarray(wave, np.float32).reshape(1, -1))
        with torch.inference_mode():
            feat, feat_len = fe(wave.to(dev),
                                torch.tensor([wave.shape[1]], device=dev))
            emb = model(feat, feat_len)
        return emb[0].float().cpu().numpy()

    return embed


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--wav_path", required=True)
    p.add_argument("--save_path", required=True)
    p.add_argument("--spk_model", default="ecapa",
                   choices=["ecapa", "xvector"])
    p.add_argument("--checkpoint", required=True,
                   help="the encoder's torch .pt/.pth state dict (the "
                        "reference's encoder.pth)")
    p.add_argument("--sr", type=int, default=16000)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    embed = make_embedder(args.spk_model, args.checkpoint, args.sr,
                          args.device)
    idx2wav = read_idx2data_file(args.wav_path)
    os.makedirs(args.save_path, exist_ok=True)
    idx2spk_feat = {}
    for idx, path in idx2wav.items():
        out = os.path.join(args.save_path, f"{idx}.npy")
        np.save(out, embed(read_data_by_path(path)))
        idx2spk_feat[idx] = out
    write_idx2data_file(idx2spk_feat,
                        os.path.join(args.save_path, "idx2spk_feat"))
    print(f"extracted {len(idx2spk_feat)} speaker embeddings")


if __name__ == "__main__":
    main()
