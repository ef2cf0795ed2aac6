"""TTS synthesis entry points (counterparts of the synth closures in
``speechain_tpu/chain.py:108-140`` and the runner's TTS branches,
``runner.py:1096-1140``): text -> FastSpeech2 or Transformer-TTS ->
(optionally) HiFi-GAN or Griffin-Lim.

:func:`make_fastspeech2_synthesizer` moves the networks to the device
(the CUDA card unless the caller passes ``device="cpu"``) and returns
``synth(text, text_len, ...)``: one FastSpeech2 forward in evaluation
mode with its predicted durations, whose ``pred_after`` is the
hypothesis feature; with a vocoder, the features recovered to the mel
domain (``FastSpeech2Net.recover_feat``: ungrouped and denormalized, as
the chain does before its vocoder) go through it in float32, and
``wave_len`` is the recovered frame count times the vocoder's hop. The
vocoder ``"gl"`` is the chain's Griffin-Lim branch (chain.py:132-135):
``ops/griffin_lim.py::logmel_to_wave`` over the recovered features at the
network's frontend, ``gl_iters`` iterations, ``wave_len`` =
min(frames x hop, L).

:func:`make_artts_synthesizer` is the same for Transformer-TTS: the
autoregressive loop of ``infer/tts_decoding.py`` with the recipe's
``infer_cfg`` (stop threshold 0.5, maxlen ratio 10, Griffin-Lim), its
features (already unfolded) denormalized and vocoded as the runner does
(runner.py:1104-1115).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from speechain_tpu_torch.infer.tts_decoding import make_tts_synthesizer
from speechain_tpu_torch.ops.griffin_lim import logmel_to_wave
from speechain_tpu_torch.utils.device import (resolve_device,
                                              set_fp32_matmul_exact)


def make_fastspeech2_synthesizer(net, vocoder=None, *, device=None,
                                 max_frames: Optional[int] = None,
                                 gl_iters: int = 32):
    """``net`` a :class:`~speechain_tpu_torch.models.nar_tts.FastSpeech2Net`,
    ``vocoder`` a :class:`~speechain_tpu_torch.nn.vocoder_hifigan.HiFiGAN`,
    ``"gl"`` (Griffin-Lim, ``gl_iters`` iterations) or None;
    ``max_frames`` the static length-regulation cap (default: the config's
    ``max_frame_len``). Returns ``synth(text, text_len, spk_feat=None,
    spk_ids=None, gl_phases=None, **controls)`` -> dict
    with ``hypo_feat`` (B, F, feat_dim), ``hypo_feat_len`` (B,),
    ``used_duration`` (B, L) and, with a vocoder, ``wave`` float32 and
    ``wave_len``; ``controls`` are the network's ``duration_alpha``,
    ``pitch_alpha``, ``energy_alpha``, ``min_frame_num`` and
    ``max_frame_num``; ``gl_phases`` are Griffin-Lim's initial phases
    ((B, F, n_freqs) uniform draws; by default drawn from a CPU generator
    seeded 0, ``ops/griffin_lim.py::griffin_lim``)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_fp32_matmul_exact()
    net.to(dev).eval()
    gl = isinstance(vocoder, str)
    if gl and vocoder != "gl":
        raise ValueError(f"unknown vocoder {vocoder!r}")
    if vocoder is not None and not gl:
        vocoder.to(dev).eval()
    r = net.cfg.reduction_factor

    def synth(text, text_len, spk_feat=None, spk_ids=None, gl_phases=None,
              **controls) -> Dict[str, torch.Tensor]:
        def put(x):
            return None if x is None else torch.as_tensor(x).to(dev)
        controls = {k: put(v) if isinstance(v, torch.Tensor) else v
                    for k, v in controls.items()}
        with torch.inference_mode():
            out = net(put(text), put(text_len), spk_feat=put(spk_feat),
                      spk_ids=put(spk_ids), max_frames=max_frames,
                      **controls)
            res = dict(hypo_feat=out["pred_after"],
                       hypo_feat_len=out["pred_feat_len"],
                       used_duration=out["used_duration"])
            if vocoder is not None:
                feat = net.recover_feat(out["pred_after"]).float()
                if gl:
                    res["wave"], res["wave_len"] = logmel_to_wave(
                        feat, out["pred_feat_len"], net.cfg.frontend,
                        n_iter=gl_iters, phases=gl_phases)
                else:
                    res["wave"] = vocoder(feat)
                    res["wave_len"] = out["pred_feat_len"] * (r * vocoder.hop)
        return res

    return synth


def make_artts_synthesizer(net, vocoder=None, *, device=None,
                           stop_threshold: float = 0.5,
                           maxlen_ratio: float = 10.0,
                           continual_steps: int = 0,
                           use_before: bool = False,
                           max_frames: Optional[int] = None,
                           gl_iters: int = 32):
    """``net`` an :class:`~speechain_tpu_torch.models.ar_tts.ARTTSNet`,
    ``vocoder`` a HiFi-GAN, ``"gl"`` or None; the decoding arguments are
    :func:`~speechain_tpu_torch.infer.tts_decoding.tts_auto_regression`'s.
    Returns ``synth(text, text_len, spk_feat=None, spk_ids=None,
    generator=None, gl_phases=None)`` -> dict with ``hypo_feat`` (B, F r,
    n_mels), ``hypo_feat_len``, ``feat_token_len_ratio``, ``steps`` and,
    with a vocoder, ``wave`` float32 and ``wave_len``. ``generator``
    draws the decoder prenet's dropout seeds (a CPU generator seeded 0 by
    default)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_fp32_matmul_exact()
    net.to(dev).eval()
    gl = isinstance(vocoder, str)
    if gl and vocoder != "gl":
        raise ValueError(f"unknown vocoder {vocoder!r}")
    if vocoder is not None and not gl:
        vocoder.to(dev).eval()
    decode = make_tts_synthesizer(
        net, stop_threshold=stop_threshold, maxlen_ratio=maxlen_ratio,
        continual_steps=continual_steps, use_before=use_before,
        max_frames=max_frames)

    def synth(text, text_len, spk_feat=None, spk_ids=None, generator=None,
              gl_phases=None) -> Dict[str, torch.Tensor]:
        def put(x):
            return None if x is None else torch.as_tensor(x).to(dev)
        res = decode(put(text), put(text_len), spk_feat=put(spk_feat),
                     spk_ids=put(spk_ids), generator=generator)
        if vocoder is None:
            return res
        with torch.inference_mode():
            feat = net.recover_feat(res["hypo_feat"]).float()
            lens = res["hypo_feat_len"]
            if gl:
                res["wave"], res["wave_len"] = logmel_to_wave(
                    feat, lens, net.cfg.frontend, n_iter=gl_iters,
                    phases=gl_phases)
            else:
                res["wave"] = vocoder(feat)
                res["wave_len"] = lens * vocoder.hop
        return res

    return synth
