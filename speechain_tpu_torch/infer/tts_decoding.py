"""Autoregressive TTS mel generation (counterpart of
``speechain_tpu/infer/tts_decoding.py``, :28-149).

:func:`tts_auto_regression` is the reference's ``lax.while_loop`` as a
host loop over :meth:`ARTTSNet.decode_step`, which steps the decoder
through its KV cache:

- priming: the cross-attention K/V of every layer and an empty
  self-attention cache of ``F`` frames; the first step feeds the zero
  frame at position 0 (the reference's priming pass feeds it too, without
  advancing, and discards its output);
- each step writes the pre-postnet frame into the ``before`` buffer; the
  frame fed back (and emitted) is by default the post-postnet one, the
  postnet re-applied over the whole (B, F, D r) buffer and the step's
  frame taken (the postnet is a non-causal conv stack, so this equals the
  reference's full-prefix call); ``use_before=True`` feeds the
  pre-postnet frame;
- the stop law (tts_decoding.py:89-111): a row fires at step s when its
  stop logit exceeds -log(1 / threshold - 1); its stop point is s + 2 (the
  reference counts the leading zero frame); it stops ``continual_steps``
  frames later, or once its length reaches its cap text_len x
  ``maxlen_ratio`` / r + 1, less one; a stopped row emits zeros and keeps
  its length; ``F`` is ``max_frames`` or int(L x ``maxlen_ratio`` / r) + 1;
- the outputs are unfolded to (B, F r, n_mels), the lengths times r.

The prenet's dropout is on at every step (decoder/ar_tts.py:202-213);
its seeds are drawn from the caller's ``generator`` at every step, so a
run is reproducible from the generator on any device.

The loop asks the card whether every row has stopped once every
:data:`CHECK_EVERY` steps, not at every step (each answer is a host
synchronisation), and never runs past the step at which every row
reaches its cap, which the host knows from the text lengths. Steps after
the last row stopped write only zeros past every row's length, so the
outputs are the reference's.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from speechain_tpu_torch.ops.dropout import step_rng

CHECK_EVERY = 16            # steps between two host reads of the flags


def tts_auto_regression(net, text: torch.Tensor, text_len: torch.Tensor, *,
                        spk_feat: Optional[torch.Tensor] = None,
                        spk_ids: Optional[torch.Tensor] = None,
                        stop_threshold: float = 0.5,
                        maxlen_ratio: float = 10.0,
                        continual_steps: int = 0, use_before: bool = False,
                        max_frames: Optional[int] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> Dict[str, torch.Tensor]:
    """Mel features for text (B, L) / text_len (B,) on the network's
    device, in evaluation mode and without gradients (the caller's
    business). Returns ``hypo_feat`` (B, F r, n_mels) float32,
    ``hypo_feat_len`` (B,) and ``feat_token_len_ratio``; ``steps``, the
    number of decoder steps run, is the only addition to the reference's
    dictionary. ``generator`` (a CPU generator seeded 0 by default) draws
    the prenet's dropout seeds."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    c = net.cfg
    r = c.reduction_factor
    feat_dim = c.frontend.n_mels * r
    B, dev = text.shape[0], text.device
    logits_threshold = -math.log(1.0 / stop_threshold - 1.0)

    enc_text, enc_mask = net.encode_text(text, text_len, spk_feat=spk_feat,
                                         spk_ids=spk_ids)
    F = max_frames if max_frames is not None else max(
        2, int(text.shape[1] * maxlen_ratio / r) + 1)
    cap = text_len.to(torch.float32) * maxlen_ratio / r + 1
    # a row that never fires stops after ceil(cap - 1) steps (at least 1)
    limit = min(F, int(torch.ceil(cap - 1).clamp(min=1).max()))
    # the reference primes with a decoder pass over a zero frame whose
    # output it discards: the same cross-attention K/V, position 0
    cache = net.decoder.prime(enc_text, F)

    before_buf = torch.zeros((B, F, feat_dim), device=dev)
    out_buf = torch.zeros((B, F, feat_dim), device=dev)
    frame = torch.zeros((B, 1, feat_dim), device=dev)
    stop_points = torch.zeros((B,), dtype=torch.int32, device=dev)
    flags = torch.zeros((B,), dtype=torch.bool, device=dev)
    hlen = torch.zeros((B,), dtype=torch.int32, device=dev)
    steps = 0
    with step_rng(generator):
        for step in range(limit):
            stop, before = net.decode_step(frame, enc_mask, cache,
                                           spk_feat=spk_feat,
                                           spk_ids=spk_ids)
            before_buf[:, step] = before[:, 0]
            if use_before:
                frame = before.float()
            else:
                frame = net.apply_postnet(before_buf)[:, step:step + 1]
            frame = torch.where(flags[:, None, None], 0.0, frame.float())
            out_buf[:, step] = frame[:, 0]
            hlen = torch.where(flags, hlen, hlen + 1)
            curr = step + 2
            fired = stop[:, -1] > logits_threshold
            stop_points = torch.where(fired & (stop_points == 0), curr,
                                      stop_points).to(torch.int32)
            flags = (((stop_points != 0)
                      & (curr >= stop_points + continual_steps))
                     | (hlen.to(torch.float32) >= cap - 1))
            steps = step + 1
            if steps % CHECK_EVERY == 0 and bool(flags.all()):
                break

    hypo_len = hlen
    if r > 1:
        out_buf = out_buf.reshape(B, F * r, feat_dim // r)
        hypo_len = hypo_len * r
    return dict(hypo_feat=out_buf, hypo_feat_len=hypo_len,
                feat_token_len_ratio=hypo_len.to(torch.float32)
                / (text_len.to(torch.float32) + 1e-10),
                steps=steps)


def make_tts_synthesizer(net, **decode_kwargs):
    """``synth(text, text_len, spk_feat=None, spk_ids=None,
    generator=None)`` -> :func:`tts_auto_regression`'s dictionary, in
    evaluation mode and inference mode on the network's device (the
    reference's jitted closure)."""

    def synthesize(text, text_len, spk_feat=None, spk_ids=None,
                   generator=None):
        net.eval()
        with torch.inference_mode():
            return tts_auto_regression(net, text, text_len,
                                       spk_feat=spk_feat, spk_ids=spk_ids,
                                       generator=generator, **decode_kwargs)

    return synthesize
