"""Analytic FLOP counters for the framework's model families (a copy of
``speechain_tpu/utils/flops.py``: pure arithmetic, no imports).

Its consumers count the model FLOPs of a step or a decode, the numerator
of a model-FLOPs utilization share: the forward pass of each family,
and the reference's uncached beam search against the KV-cached one
(``infer/beam_search.py``).

All counts are multiply-accumulates x 2, forward pass, excluding
negligible elementwise work (activations, norms, softmax scaling) —
consistent under- vs over-counting cancels in the ratios they feed.
"""

from __future__ import annotations


def linear(t: float, d_in: int, d_out: int) -> float:
    """t positions through a dense layer: 2 * t * d_in * d_out."""
    return 2.0 * t * d_in * d_out


def mhsa(t_q: float, t_kv: float, d: int) -> float:
    """Multi-head attention: Q/O projections over t_q, K/V over t_kv,
    scores + AV each 2 * t_q * t_kv * d."""
    proj = linear(t_q, d, d) * 2 + linear(t_kv, d, d) * 2
    attn = 2 * (2.0 * t_q * t_kv * d)
    return proj + attn


def ffn(t: float, d: int, ff: int) -> float:
    return linear(t, d, ff) + linear(t, ff, d)


def conformer_layer(t: float, d: int, ff: int, conv_kernel: int = 15
                    ) -> float:
    """Macaron FFN x2 + MHSA + conv module (pw GLU d->2d, depthwise k,
    pw d->d) — module/transformer/encoder.py conformer block."""
    conv = (linear(t, d, 2 * d)          # pointwise 1 (GLU gates)
            + 2.0 * t * conv_kernel * d  # depthwise
            + linear(t, d, d))           # pointwise 2
    return 2 * ffn(t, d, ff) + mhsa(t, t, d) + conv


def conformer_encoder(t: float, layers: int, d: int, ff: int,
                      conv_kernel: int = 15) -> float:
    return layers * conformer_layer(t, d, ff, conv_kernel)


def transformer_encoder(t: float, layers: int, d: int, ff: int) -> float:
    return layers * (mhsa(t, t, d) + ffn(t, d, ff))


def transformer_decoder(t_q: float, t_self: float, t_enc: float,
                        layers: int, d: int, ff: int) -> float:
    """One decoder forward: self-attention against t_self cached/prefix
    positions, cross-attention against t_enc encoder positions."""
    return layers * (mhsa(t_q, t_self, d) + mhsa(t_q, t_enc, d)
                     + ffn(t_q, d, ff))


def conv2d_subsample_prenet(t_mel: float, n_mels: int, dims, kernel: int = 3,
                            stride: int = 2) -> float:
    """Conv2d prenet (module/prenet/conv2d.py): each layer halves time."""
    total, t, ch_in, freq = 0.0, t_mel, 1, n_mels
    for ch in dims:
        t = (t + stride - 1) // stride
        freq = (freq + stride - 1) // stride
        total += 2.0 * t * freq * ch * ch_in * kernel * kernel
        ch_in = ch
    return total


# ---------------------------------------------------------------------------
# reference-algorithm inference costs
# ---------------------------------------------------------------------------

def ref_beam_search_decoder_flops(L: int, t_enc: int, beam: int,
                                  layers: int, d: int, ff: int,
                                  vocab: int) -> float:
    """FLOPs the REFERENCE beam search spends decoding one utterance to
    length L (infer_func/beam_search.py:299-474): every step re-forwards
    the full t-token prefix for each of ``beam`` hypotheses — self-attn
    t x t, cross-attn t x t_enc, FFN + vocab projection over all t
    positions (only [:, -1] is consumed)."""
    total = 0.0
    for t in range(1, L + 1):
        per_hypo = (transformer_decoder(t, t, t_enc, layers, d, ff)
                    + linear(t, d, vocab))
        total += per_hypo
    return beam * total


def cached_beam_search_decoder_flops(L: int, t_enc: int, beam: int,
                                     layers: int, d: int, ff: int,
                                     vocab: int) -> float:
    """Ours, for comparison: KV-cached single-token steps
    (infer/beam_search.py) — one new position per step; self-attn against
    the growing cache, cross-K/V computed once at priming."""
    prime = beam * linear(t_enc, d, d) * 2 * layers   # cross K/V once
    total = prime
    for t in range(1, L + 1):
        step = layers * (
            linear(1, d, d) * 4                       # self q/k/v/o
            + 2 * (2.0 * t * d)                       # self scores + AV
            + linear(1, d, d) * 2                     # cross q/o
            + 2 * (2.0 * t_enc * d)                   # cross scores + AV
            + ffn(1, d, ff)) + linear(1, d, vocab)
        total += beam * step
    return total


def fastspeech2_fwd_flops(l_tok: int, t_frames: int, d: int, ff: int,
                          enc_layers: int, dec_layers: int, n_mels: int,
                          var_pred_dim: int = 256, var_pred_kernel: int = 3,
                          postnet_ch: int = 256, postnet_kernel: int = 5,
                          postnet_layers: int = 5) -> float:
    """FastSpeech2 synthesis forward (models/nar_tts.py __call__):
    token-side transformer encoder, 3 variance predictors (2-layer convs),
    length-regulated frame-side decoder, mel projection, conv postnet."""
    enc = transformer_encoder(l_tok, enc_layers, d, ff)
    var = 3 * (2.0 * l_tok * var_pred_kernel * d * var_pred_dim
               + 2.0 * l_tok * var_pred_kernel * var_pred_dim * var_pred_dim
               + linear(l_tok, var_pred_dim, 1))
    dec = transformer_encoder(t_frames, dec_layers, d, ff)
    mel = linear(t_frames, d, n_mels)
    post = (2.0 * t_frames * postnet_kernel * n_mels * postnet_ch
            + (postnet_layers - 2)
            * 2.0 * t_frames * postnet_kernel * postnet_ch * postnet_ch
            + 2.0 * t_frames * postnet_kernel * postnet_ch * n_mels)
    return enc + var + dec + mel + post


def hifigan_fwd_flops(t_mel: int, n_mels: int = 80,
                      upsample_initial_channel: int = 512,
                      upsample_factors=(8, 8, 2, 2),
                      upsample_kernel_sizes=(16, 16, 4, 4),
                      resblock_kernel_sizes=(3, 7, 11),
                      resblock_dilation_sizes=((1, 3, 5),) * 3) -> float:
    """HiFiGAN V1 generator (nn/vocoder_hifigan.py): conv_pre, 4 transposed
    upsamples each followed by 3 parallel ResBlocks (2 convs per dilation),
    conv_post. Counted per output position of each conv."""
    total = 2.0 * t_mel * 7 * n_mels * upsample_initial_channel
    t, ch_in = float(t_mel), upsample_initial_channel
    for i, (f, k) in enumerate(zip(upsample_factors, upsample_kernel_sizes)):
        ch = upsample_initial_channel // (2 ** (i + 1))
        t *= f
        total += 2.0 * t * k * ch_in * ch / f      # transposed conv
        for rk, rds in zip(resblock_kernel_sizes, resblock_dilation_sizes):
            total += len(rds) * 2 * (2.0 * t * rk * ch * ch)
        ch_in = ch
    total += 2.0 * t * 7 * ch_in * 1               # conv_post
    return total
