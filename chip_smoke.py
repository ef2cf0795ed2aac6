"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits nonzero):
  1. identity and build: the card's name and power limit, the torch/CUDA
     versions, and an ``nvcc`` build of every kernel from ``csrc/`` (one
     process per source, all started together);
  2. kernels against their plain PyTorch versions at the serving path's
     shapes (conformer-small, 16 utterances of 8 s, beam 16), in float32
     and bfloat16 (the bf16 FFN at dropout 0 and 0.1, also at a ragged
     N = 2985), with their times and bounds; log-Mel (``check_logmel``) at
     the ASR, the TTS and a direct-DFT frontend on 16 x 8 s and ragged at
     (3, 12345), and at the two evaluation frontends (n_fft 800 at 16 kHz,
     1102 at 22.05 kHz) on one utterance of 5 s, each on the device beside its folded and direct bounds
     and its torch.stft composition, the launch as built against
     ``ops/cuda_logmel.py::geometry``, every instance's registers (no
     spill allowed) and the tile sweep;
  2b. the training kernels (FFN backward, flash attention forward and
     backward) against their plain versions, gradients against autograd of
     the plain version, at the training path's shapes and at partial-tile
     shapes, float32 and bfloat16, dropout 0 and 0.1, with their times,
     bounds and, for attention, ``scaled_dot_product_attention``'s time;
     the FFN (as in phases 2, 2c and 14, through ``ffn_case``) also with
     the time of ``ffn_composed``, the same function composed of cuBLAS
     linear layers and elementwise ops (backward: its autograd), its
     weight gradients bit-equal over two runs, every bf16 instance's
     shared memory equal to ``ops/cuda_ffn.py``'s reckoning and its
     registers within budget, and every instance timed at each path shape
     beside the one ``tc_geometry`` picks (the tile sweep);
     flash attention also at the conformer decoder's width (phase 8's
     calls), causal at T = 128, at T = 600 and 768, with one key, and
     causal with an empty key row (T = 77 and 768), its times per call and
     on the device (one CUDA graph; SDPA's backward, autograd run outside a
     graph, and ours beside it from torch.profiler's kernel times), and its
     shared memory per kernel against the reckoning in
     ``ops/cuda_attention.py`` for Tk = 1..2000;
  3. the decode path: conformer-small at full width with seeded random
     weights, beam-16 decoding of 16 random 8 s waveforms through
     ``make_asr_decoder``, with every kernel's launch count;
  4. the decode path against the CPU: a 2-utterance float32 decode on the
     card and again with ``device="cpu"`` (the kernels' plain versions);
     the hypotheses must be token-equal;
  5. the training path: transformer-wide at full width and depth, seeded
     random weights, 16 random 8 s waveforms and 32-token texts through
     ``init_train_state`` / ``build_optimizer`` / ``make_arasr_step``:
     launches of each entry point in one step (exactly the predicted
     counts), then ms/step, mel-frames/s and peak memory over 10 steps, and
     the device's idle share and top kernels from one profiled step;
  6. learning: 20 steps on one repeated batch at a constant 5e-4; the last
     loss must be at least 10 % below the first;
  7. training on the card against the CPU: float32, dropout 0, no
     SpecAugment, 2 utterances, full width, 2 + 2 layers; the loss of one
     step (1e-4), every gradient (1e-3 of its max-norm; the CPU pass takes
     the card's branch at each prenet LeakyReLU kink) and the parameters
     after 2 steps (1e-4) must agree;
  2c. (run after 2b) the conformer training kernels: rel-pos attention
     backward and conv-module backward against autograd of their plain
     versions at the conformer-small training shapes and at partial-tile
     shapes (T = 77 with ragged key masks and an empty row; T = 600),
     float32 and bfloat16, rel-pos at dropout 0 and 0.1; the FFN backward
     at the conformer encoder's residual scale 0.5 and at its decoder's
     rows, and the decoder's FFN forward, at dropout 0 and 0.1; with their
     times (per call and on the device) and bounds; both bf16 backwards'
     device time by kernel, and their yardsticks, the same functions
     composed of bf16 cuBLAS / cuDNN calls (autograd, device time from
     the profiler); the forwards at the same shapes (the conv module's
     u, s and ss; the rel-pos forward's row maximum M and denominator L,
     which the backward reads, against the plain scores') and the bf16
     forwards' compositions (device time from the profiler)
     (phase 2 also runs the rel-pos forward at T = 406, 600 and 768);
  8. the conformer training path: conformer-small at full width and depth
     (the recipe's dropout 0.1, SpecAugment, label smoothing 0.1, Noam
     2e-3 / 25000), 16 random 8 s waveforms and 32-token texts: launches
     of each entry point in one step (exactly the predicted counts), then
     ms/step, mel-frames/s and peak memory over 10 steps, and the device's
     idle share and top kernels from one profiled step;
  9. learning: 20 conformer steps on one repeated batch at a constant
     5e-4; the last loss must be at least 10 % below the first;
  10. conformer training on the card against the CPU, as phase 7 (2 + 2
     layers), and the conv modules' BatchNorm running statistics after 2
     steps (1e-4);
  2d. (run after 2c) the opt-in routes' kernels: LayerNorm forward and
     backward (N = 3184, 496, 256 and ragged, D = 256 and 512) and the
     fused prenet core forward and backward (16 x 801 x 80 at C = 128,
     256, 384 and 512; 3 x 37 x 21, and F2 = 64 and F2 = 1, at C = 128)
     against their plain versions (gradients: autograd of the plain
     version; the prenet's mel gradient must be zero; dw2 and A bit-equal
     over two runs), float32 and bfloat16, with their times per call and
     on the device, bounds and, for LayerNorm, ``F.layer_norm``'s time
     (its backward's on the device from the profiler) and the device ms
     by kernel; at C = 256 and 512 the prenet core's device ms by kernel
     and its composition yardstick (the reference's XLA core: a bf16
     product and a cuDNN convolution); then the LayerNorm launches as
     built against the wrapper's reckoning, and a sweep of the launch
     shapes whose picks must be within SWEEP_SLACK of the fastest;
  11. conformer-small beam-16 decoding with both opt-in routes on (the
     LayerNorm kernels and the fused prenet core), as phase 3, with the
     exact LayerNorm and prenet launches, and a float32 card-vs-CPU decode
     (token-equal) at an audio length whose encoder rows take the kernel;
  12. conformer-small training with both routes on, as phase 8 (launches
     exactly the predicted counts, layer_norm 68 + 68 and prenet_core 1 +
     1 among them), and its learning check, as phase 9;
  13. training with both routes on, card against CPU, as phase 10, at a
     batch whose encoder and decoder rows are multiples of 8 (so both
     sides route every LayerNorm to the kernel or its plain version); the
     CPU's plain prenet core takes the card kernel's branch at conv1
     LeakyReLU kinks (the card's pre-activations recomputed bit for bit
     by ``ops/cuda_prenet.py::conv1_preact``);
  2e. (run after 2d) the attention kernels at every head width: flash
     attention forward and backward at head widths 32, 96, 128, 192, 256
     and the padded 80 (run by the 96 instance), rel-pos at 32, 96 and
     128, against their plain versions (gradients: autograd), float32 and
     bfloat16, dropout 0 and 0.1, causal with an empty key row and a
     partial tile, and cross-attention; the synthesis shapes ((16, 640,
     384) with 4 and 2 heads, (16, 100, 384)) and transformer-large's
     (16, 199, 512) timed per call and on the device beside SDPA; rel-pos
     (with its M and L) timed at (16, 199, 4 heads); every instance's
     registers and spills from the build log; the shared memory against
     the reckoning (flash attention; rel-pos in both dtypes); the built
     backwards' scratch (rel-pos and conv-module, both dtypes), and the
     conv-module's bf16 shared memory and launch grids (forward and
     backward), against the wrappers' reckoning; the conv-module forward
     and backward at C 512 (float32 and bfloat16; timed in bf16 at (16,
     199, 512));
  14. TTS synthesis: bench.py ``_tts_bench``'s FastSpeech2 (d 384, 4
     heads, 4 + 4 layers, F 1536, bf16) and HiFi-GAN V1 (float32), seeded
     random weights, 16 x 100 tokens -> 640 frames -> 163,840 samples
     through ``make_fastspeech2_synthesizer``: launches exactly
     flash_attention 8 and ffn 8, wall ms of a call and of FastSpeech2 and
     HiFi-GAN alone, audio seconds per wall second, peak memory, idle share
     and top kernels; the FFN kernel at the synthesis shapes (D 384) at
     dropout 0 and 0.1;
  15. synthesis on the card against the CPU: float32, 2 + 2 layers, 2
     utterances at full width; durations equal, mel within 1e-4 and the
     waveform within 1e-5 of max(1, max|ref|); the vocoder with cuDNN's
     TF32 on, as a control, must fall outside that limit;
  16. FastSpeech2 training: the LJSpeech recipe (recipes/tts/ljspeech/
     exp_cfg/fastspeech2.yaml: d 384, 2 heads of 192, 4 + 4 layers, the
     'conv' FFN, dropout 0.2 / 0.5, three global norms, Noam 1e-3 / 6000)
     at full width and depth, bf16 on float32 master weights, 16
     utterances of 175,725 samples (640 frames) with 100 tokens, teacher
     durations (some 0) and frame-level pitch, through init_train_state /
     build_optimizer / make_fastspeech2_step: launches exactly
     flash_attention 8 and flash_attention_backward 8 a step, ms a step
     (mean of 10 after 4 warm-ups), mel frames/s, peak memory, idle share
     and top kernels of one profiled step; then 20 steps at a constant
     5e-4 on one batch must lower the loss by 10 %;
  17. FastSpeech2 training on the card against the CPU: float32, dropout
     0, 2 + 2 layers at full width, 2 utterances (one with a padded
     tail), the recipe's 'conv' FFN with 2 heads and bench.py's 'linear'
     FFN with 4 heads (rows 4/5 at D 384 in training): after 3 steps the
     losses within 1e-4 relative, every parameter and running statistic
     (BatchNorm, the feature, pitch and energy norms) within 1e-4 of its
     largest magnitude;
  18. Griffin-Lim: phase 14's FastSpeech2 through
     make_fastspeech2_synthesizer(vocoder="gl") at 16 x 640 frames and 32
     iterations (n_fft 1102): wall ms, audio s per wall s, one profiled
     call; then float32 on 2 utterances, card against CPU from the same
     initial phases: durations equal, mel within 1e-4, and Griffin-Lim on
     the same mel within 1e-4 of max|ref| after 8 iterations (the CPU
     test's tolerance and count); after 32 iterations and through the
     whole synthesizer the differences are reported (each iteration
     amplifies the last one's rounding);
  19. Transformer-TTS synthesis: the LJSpeech recipe (recipes/tts/
     ljspeech/exp_cfg/transformer_tts.yaml: the encoder d 512, 8 heads, 6
     layers, F 2048; the decoder at the prenet's width 256, 8 heads of
     32, 6 layers; r 2; postnet 5 x 512), bf16, seeded random weights, the
     stop head's bias -1e4, 16 x 100 tokens through
     make_artts_synthesizer(net, "gl"): exactly 500 KV-cached decoder steps
     (every row runs to its cap, 1000 frames), launches exactly ffn 3006
     (the encoder's 6, the steps' 6 at N = 16) and flash_attention 6, 32
     Griffin-Lim iterations; wall ms of a call, of the loop alone and of
     Griffin-Lim alone, ms a step, the postnet's recompute over the whole
     buffer timed alone, audio s per wall s, peak memory, one profiled
     call;
  20. Transformer-TTS synthesis on the card against the CPU: float32, 2 + 2
     layers at full width, 2 utterances (100 and 3 tokens), the prenet's
     dropout 0.5 from the same generator seed, ``max_frames`` 24: lengths
     equal (48 and 30 frames) and the features within 1e-4 of max(1,
     max|ref|); the CPU from another seed, as a control, must fall outside;
  21. Transformer-TTS training: the recipe at full width and depth (dropout
     0.1, prenet 0.5, postnet 0.5, attention guidance 0.2, Noam 1e-3 /
     4000), bf16 on float32 master weights, 8 utterances of 120,000
     samples (601 frames, 300 decoder positions) with 100 tokens through
     make_artts_step: launches exactly ffn 12 / ffn_backward 12 /
     flash_attention 17 / flash_attention_backward 17 a step (decoder
     layer 0's cross-attention, which the guidance reads, takes the matrix
     path), ms a step (mean of 10 after 4 warm-ups), mel frames/s, peak
     memory, one profiled step; then 20 steps at a constant 5e-4 on one
     batch must lower the loss by 10 %;
  22. Transformer-TTS training on the card against the CPU: float32,
     dropout 0, 2 + 2 layers at full width, 2 utterances (one with a padded
     tail): after 3 steps the losses, parameters, statistics and Adam's
     first moments as phase 17;
  23. speaker embeddings: 16 seeded references of 3-10 s at 16 kHz
     (.wav) through pyscripts/spk_feat_extractor.py's main with seeded
     random ECAPA weights (a .pt in the reference's layout): launches
     exactly logmel 16 (row 1 at one utterance a call), wall and busy ms,
     unit norms within 1e-5, the same call with --device cpu within 1e-4;
     x-vector likewise; add_delta_features card against CPU;
  24. multi-speaker synthesis: the LibriTTS recipe (recipes/tts/libritts/
     exp_cfg/fastspeech2_multispk.yaml: d 384, 2 heads of 192, 4 + 4
     layers, 'conv' FFN, 192-d embeddings concatenated), bf16, on phase
     23's embeddings, 16 x 100 tokens through Griffin-Lim at n_fft 800:
     launches exactly flash_attention 8, wall, busy and idle share; the
     waves written as .wav; float32 2 + 2 layers card against CPU as
     phase 18;
  25. evaluation: spk_sim_evaluation and tts_evaluation on phase 24's
     and 23's files, on the card (logmel exactly 32 and 64) and with
     --device cpu: every utterance scored by every metric, the card's
     scores within 1e-3 relative of the CPU's, host seconds in DTW and
     pitch tracking.
Phase 2b also holds the FFN at Transformer-TTS's shapes (D 256 / F 2048
forward and backward, both dtypes; the encoder's D 512; the synthesis
step's N = 16) and flash attention at 8 heads of 32 (causal 300 x 300,
cross 300 x 100 with a key mask).

Every kernel entry point checked in phases 2-2e and 14 is also run three
more times on the same inputs (dropout seed included), and every output
must be bit-equal to the first run's (``check_repeats``): the kernels add
their partial sums in a fixed order, with no atomics, so a difference is a
race.

The line before the last is ``{"kernels": [...]}``, one entry per kernel
entry point; the last line is ``{"ok": true, "device": {...}}``. Longer
logs go to chiprun_out/.

``--logmel-ab`` only times the log-Mel kernel at its three cases and
prints the device ms as one JSON line; the same script copied into an
earlier tree times that tree's kernel (an A/B in one call).
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

PEAK_BYTES = 3.35e12                 # H100 SXM HBM3, bytes/s
PEAK_OPS = {"bfloat16": 989e12,      # dense tensor-core rate
            "float32": 67e12}        # float32 outside the tensor cores
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out" / "chip_smoke"
DEV = "cuda"                         # the card (the training phases' device)

# conformer-small (bench.py ARCH, recipes/asr/librispeech/train-clean-5/
# exp_cfg/bpe1k_conformer-small.yaml), decoded as bench.py _decode_bench
V, D, H, F_DIM, K_DW = 1000, 256, 4, 1024, 31
ENC_LAYERS, DEC_LAYERS = 12, 6
B, SECS, SR, BEAM = 16, 8, 16000, 16

# transformer-wide (recipes/asr/librispeech/train-clean-100/exp_cfg/
# bpe5k_transformer-wide.yaml), trained on 16 utterances of 8 s with
# 32-token texts: T_mel 801, T_enc 199, decoder length 31
TW_V, TW_D, TW_H, TW_F = 5000, 512, 8, 2048
TW_ENC, TW_DEC, TW_TEXT = 12, 6, 32
TRAIN_PATH_LAUNCHES = {"logmel": 1, "ffn": 18, "ffn_backward": 18,
                       "flash_attention": 24, "flash_attention_backward": 24}
DECODE_PATH = ("logmel", "ffn", "relpos_attention", "convmod")
# conformer-small trained as bench.py _train_bench with the recipe's
# hyper-parameters: per step 2 macaron FFNs x 12 + 6 decoder FFNs, one
# rel-pos attention and one conv module per encoder layer, causal self-
# and cross-attention per decoder layer, each forward with its backward
CONFORMER_TRAIN_LAUNCHES = {
    "logmel": 1, "ffn": 30, "ffn_backward": 30, "relpos_attention": 12,
    "relpos_attention_backward": 12, "convmod": 12, "convmod_backward": 12,
    "flash_attention": 12, "flash_attention_backward": 12}
# the opt-in routes (ARASRConfig fused_ln / prenet_core): every encoder and
# decoder LayerNorm but the decoder's emb_layernorm (4 a conformer layer +
# the final one, 3 a decoder layer + the final one), and the prenet core
FUSED_ROUTES = dict(fused_ln=True, prenet_core="fused")
ENC_LN, DEC_LN = 4 * ENC_LAYERS + 1, 3 * DEC_LAYERS + 1
FUSED_TRAIN_LAUNCHES = dict(
    CONFORMER_TRAIN_LAUNCHES, layer_norm=ENC_LN + DEC_LN,
    layer_norm_backward=ENC_LN + DEC_LN, prenet_core=1,
    prenet_core_backward=1)
# 802 x 160 samples: 803 mel frames, T_enc 200, so a 2-utterance batch has
# 400 encoder rows, a multiple of 8 (the LayerNorm route's gate)
FUSED_CHECK_SAMPLES = 802 * 160


T_START = time.perf_counter()


def log(msg: str) -> None:
    """A line to standard output, whose end alone may be kept, and to
    log.txt in OUT_DIR; a phase's header ("== ...") with the seconds
    since the script started."""
    if msg.startswith("== "):
        msg += f" [{time.perf_counter() - T_START:.1f} s]"
    print(msg, flush=True)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    with open(OUT_DIR / "log.txt", "a") as f:
        f.write(msg + "\n")


def cuda_time(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean ms per call on the card, CUDA events around ``reps`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


_CAPTURE_STREAM = []


def graph_time(fn, reps: int = 20) -> float:
    """Mean device ms per call: ``reps`` calls captured in one CUDA graph,
    its replay timed with CUDA events, so the host's launch overhead (tens
    of microseconds a Python call) does not hide a kernel of a few. One
    side stream serves every capture: PyTorch keeps a cuBLAS workspace for
    each stream that runs a cuBLAS call, for the life of the process."""
    import torch
    if not _CAPTURE_STREAM:
        _CAPTURE_STREAM.append(torch.cuda.Stream())
    stream = _CAPTURE_STREAM[0]
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_kernels(fn, reps: int = 1, tries: int = 3, host: bool = True):
    """torch.profiler over ``reps`` calls of ``fn``: (device ms, launches,
    kernel name) for each kernel that took device time, longest first. A
    session that records no device time (CUPTI now and then hands back
    none) is run again, up to ``tries`` sessions in all. ``host=False``
    records the device's activity alone, for calls of hundreds of
    thousands of launches, whose host events would take minutes."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    for attempt in range(tries):
        with profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            if us > 0:
                rows.append((us / 1e3, e.count, e.key))
        if rows:
            return sorted(rows, reverse=True)
        log(f"  the profiler recorded no device time (session {attempt + 1}"
            f" of {tries})")
    raise RuntimeError(f"the profiler recorded no device time in {tries} "
                       "sessions")


def profiled_time(fn, reps: int = 20, warmup: int = 3,
                  by_kernel: dict = None) -> float:
    """Mean device ms per call from torch.profiler's kernel times: every
    kernel's device time over ``reps`` calls, summed, over ``reps``. For
    work timed outside a CUDA graph (autograd through a library call);
    gaps between kernels do not count. ``by_kernel``, if given,
    receives the mean ms per call of each kernel name."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    rows = device_kernels(fn, reps)
    if by_kernel is not None:
        for ms, _, key in rows:       # the function's name and template
            name = key.replace("(anonymous namespace)::", "").split("(")[0]
            base = name.split("<")[0]
            name = base.split(" ")[-1].split("::")[-1] + name[len(base):]
            by_kernel[name] = by_kernel.get(name, 0.0) + ms / reps
    return sum(r[0] for r in rows) / reps


def reset_counts() -> None:
    from speechain_tpu_torch.ops import kernels
    for k in kernels():
        k.reset_counts()


def entry_counts() -> dict:
    """Launch count of every kernel entry point, by entry name."""
    from speechain_tpu_torch.ops import entry_points
    return {k.entry_name(sym): k.counts[sym] for k, sym in entry_points()}


def held_mib() -> float:
    """MiB the process holds allocated on the card before a path runs
    (after a garbage collection): the floor under the path's peak, left by
    the model, its inputs and the earlier phases."""
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated() / 2 ** 20


def bound(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def relpos_cost(Bq: int, T: int, s: int, backward: bool = False,
                Dm: int = D, Hm: int = H):
    """(bytes, operations) of one rel-pos attention call at dtype size s
    and width Dm with Hm heads (conformer-small's by default):
    each input read once and each output written once (q/k/v, and g in
    the backward; ph; the float32 biases, key mask and row statistics;
    out, or dq/dk/dv and the float32 dph, dbu, dbv); 3 products over
    every (query, key) pair forward (content and position scores, p v),
    8 backward (the scores again, dp, dv, dq twice, dk, dph)."""
    L = 2 * T - 1
    stats = 4 * (2 * Bq * Hm * T + Bq * T)
    if backward:
        return (s * (7 * Bq * T * Dm + L * Dm) + 4 * (L * Dm + 4 * Dm)
                + stats, 16 * Bq * T * T * Dm)
    return (s * (4 * Bq * T * Dm + L * Dm) + 8 * Dm + stats,
            6 * Bq * T * T * Dm)


def conformer_small_config(dtype, routes=None):
    from speechain_tpu_torch.models.ar_asr import ARASRConfig
    from speechain_tpu_torch.ops.feat_norm import FeatNormConfig
    from speechain_tpu_torch.ops.frontend import FrontendConfig
    return ARASRConfig(
        vocab_size=V,
        frontend=FrontendConfig(n_mels=80, preemphasis=0.97),
        feat_norm=FeatNormConfig(feat_dim=80),
        enc_prenet=dict(conv_dims=[D, D], conv_kernel=3, conv_stride=2,
                        conv_batchnorm=True, conv_activation="LeakyReLU",
                        lnr_dims=D),
        encoder_type="conformer",
        encoder=dict(d_model=D, num_heads=H, num_layers=ENC_LAYERS,
                     fdfwd_dim=F_DIM, fdfwd_activation="GELU",
                     depthwise_kernel_size=K_DW),
        dec_emb=dict(embedding_dim=D),
        decoder=dict(d_model=D, num_heads=H, num_layers=DEC_LAYERS,
                     fdfwd_dim=F_DIM, fdfwd_activation="GELU"),
        ctc_weight=0.3, dtype=dtype, **(routes or {}))


def build_net(dtype, seed: int = 0, routes=None):
    from speechain_tpu_torch.models.ar_asr import ARASRNet
    from speechain_tpu_torch.utils.weights import random_state_dict
    net = ARASRNet(conformer_small_config(dtype, routes))
    sd = random_state_dict(net, seed)
    # sharper output distribution than N(0, 1/fan_in) gives: keeps the
    # beam's top candidates apart by more than float32 summation order
    sd["postnet.linear.weight"] *= 8.0
    net.load_state_dict(sd, strict=True)
    return net.eval()


def waves(n: int, seed: int, L: int = SECS * SR):
    rng = np.random.default_rng(seed)
    wave = (0.1 * rng.standard_normal((n, L, 1))).astype(np.float32)
    return wave, np.full((n,), L, np.int32)


# --------------------------------------------------------------- phase 1

def phase_identity_and_build():
    import torch
    from speechain_tpu_torch.ops import kernels
    from speechain_tpu_torch.ops.cuda_build import build_all
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    ks = build_all(kernels())
    log(f"kernels built in {time.perf_counter() - t0:.2f} s")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    with open(OUT_DIR / "build_log.txt", "w") as f:
        for k in ks:
            f.write(f"== {k.name} ({k.source.name}) ==\n{k.build_log}\n")
            if k.name in ("flash_attention", "relpos_attention"):
                continue                  # phase 2e names each instance
            for line in k.build_log.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {k.name}: {line.strip()}")
    for k in ks:
        k.lib                        # load and bind every library now
    return smi


# --------------------------------------------------------------- phase 2

def check_kernels():
    """Kernel vs plain version at the slice's shapes; returns one record
    per kernel (numbers of the bf16 / path-dtype call) with all calls."""
    import torch
    from speechain_tpu_torch.ops import cuda_attention, cuda_convmod
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(1)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen) * scale).to(
            device=dev, dtype=dtype)

    records = {}

    def compare(name, dtype, kernel_fn, plain_fn, tol_rel, nbytes, ops,
                shape, absolute=False, device=False):
        """Error against the plain version; the tolerance is tol_rel
        times max(1, max|plain|), or tol_rel itself when absolute. With
        ``device``, also the kernel's device ms (``graph_time``)."""
        got, want = kernel_fn().float(), plain_fn().float()
        if not torch.isfinite(got).all():
            raise RuntimeError(f"{name} {dtype}: non-finite output")
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        tol = tol_rel if absolute else tol_rel * max(1.0, scale)
        ms = cuda_time(kernel_fn)
        plain_ms = cuda_time(plain_fn, reps=5, warmup=1)
        dt = "float32" if dtype == torch.float32 else "bfloat16"
        b_ms, b_by = bound(nbytes, ops, dt)
        ok = err <= tol
        rec = dict(call=name, dtype=dt, shape=shape, max_abs_err=err,
                   tol=tol, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by, library_ms=None)
        if device:
            rec["device_ms"] = graph_time(kernel_fn)
        log(f"  {name:<28} {dt:<8} {shape:<34} max_abs_err {err:.3e} "
            f"(tol {tol:.1e}) {'ok' if ok else 'FAIL'}  kernel {ms:.4f} ms"
            + (f" (device {rec['device_ms']:.4f})" if device else "")
            + f"  plain {plain_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})"
            f"  library: no single PyTorch call")
        if not ok:
            raise RuntimeError(f"{name} {dt}: error {err} > {tol}")
        return rec

    # ---- log-Mel (float32 only: the frontend contract) ----------------
    L = SECS * SR
    wave = rnd(B, L, scale=0.1)
    wave_len = torch.full((B,), L, dtype=torch.int32, device=dev)
    wave_len[1] = L - 12345
    records["logmel"] = check_logmel(compare, [
        (label, cfg, wave, wave_len) for label, cfg in logmel_cases()] + [
        (label, cfg, w, torch.full((1,), w.shape[1], dtype=torch.int32,
                                   device=dev))
        for label, cfg in logmel_eval_cases()
        for w in (rnd(1, EVAL_SECS * cfg.sr + 1, scale=0.1),)])
    T_mel = L // 160 + 1                 # the ASR frontend's 801 frames

    # ---- FFN: encoder macaron half, decode step, no-residual entry -----
    T_enc = ((T_mel - 3) // 2 + 1 - 3) // 2 + 1
    ffn_calls = []
    for dtype in (torch.bfloat16, torch.float32):
        for label, N, alpha, with_res in (
                ("encoder", B * T_enc, 0.5, True),
                ("decode_step", B * BEAM, 1.0, True),
                ("(no residual)", B * T_enc, 1.0, False)):
            rates = (0.0, 0.1) if dtype == torch.bfloat16 else (0.0,)
            for rate in rates:
                ffn_calls.append(ffn_case(label, N, D, F_DIM, "GELU", alpha,
                                          with_res, rate, dtype, False, 21))
    records["ffn"] = ffn_calls

    # ---- rel-pos attention ----------------------------------------------
    att_calls = []
    for dtype in (torch.bfloat16, torch.float32):
        s = dtype.itemsize
        q, k, v = (rnd(B, T_enc, D, dtype=dtype) for _ in range(3))
        ph = rnd(2 * T_enc - 1, D, dtype=dtype)
        bu, bv = rnd(D, scale=0.3), rnd(D, scale=0.3)
        lens = torch.full((B,), T_enc, device=dev)
        lens[1::3] = T_enc - 40
        mask = (torch.arange(T_enc, device=dev)[None] < lens[:, None])
        nbytes, ops = relpos_cost(B, T_enc, s)
        att_calls.append(compare(
            "relpos_attention", dtype,
            lambda q=q, k=k, v=v, ph=ph, bu=bu, bv=bv, m=mask:
            cuda_attention.cuda_relpos_attention(q, k, v, ph, bu, bv,
                                                 D ** -0.5, H, m),
            lambda q=q, k=k, v=v, ph=ph, bu=bu, bv=bv, m=mask:
            cuda_attention.relpos_attention_plain(q, k, v, ph, bu, bv,
                                                  D ** -0.5, H, m),
            1e-4 if dtype == torch.float32 else 2 ** -6, nbytes, ops,
            f"q/k/v ({B}, {T_enc}, {D}) H={H}"))
        check_repeats(f"relpos_attention {dtype}",
                      lambda: cuda_attention._launch_forward(
                          q, k, v, ph, bu, bv, mask.to(torch.int32),
                          D ** -0.5, H, 0.0, 0))
    records["relpos_attention"] = att_calls

    # ---- conv module front half -----------------------------------------
    conv_calls = []
    for dtype in (torch.bfloat16, torch.float32):
        s = dtype.itemsize
        x = rnd(B, T_enc, D, dtype=dtype)
        w1 = rnd(2 * D, D, scale=D ** -0.5, dtype=dtype)
        b1 = rnd(2 * D, scale=0.1, dtype=dtype)
        dwk = rnd(D, 1, K_DW, scale=K_DW ** -0.5)
        dwb = rnd(D, scale=0.1, dtype=dtype)
        nbytes = s * (2 * B * T_enc * D + 2 * D * D + 2 * D + D) \
            + 4 * (D * K_DW + 2 * D)
        ops = B * T_enc * (2 * D * 2 * D + 2 * D * K_DW + 4 * D)

        def kern(x=x, w1=w1, b1=b1, dwk=dwk, dwb=dwb):
            return cuda_convmod.cuda_conv_glu_dw(x, w1, b1, dwk, dwb)

        def plain(x=x, w1=w1, b1=b1, dwk=dwk, dwb=dwb):
            return cuda_convmod.conv_glu_dw_plain(x, w1, b1, dwk, dwb)

        check_convmod_stats("conv_glu_dw", kern(), plain(), dtype)
        check_repeats(f"conv_glu_dw {dtype}", kern)
        conv_calls.append(compare(
            "conv_glu_dw", dtype, lambda: kern()[0], lambda: plain()[0],
            1e-4 if dtype == torch.float32 else 2 ** -6, nbytes, ops,
            f"x ({B}, {T_enc}, {D}) K={K_DW}", device=True))
    records["convmod"] = conv_calls
    return records


# the log-Mel cases (row 1): the ASR frontend of every ASR path
# (config/feat/log_mel/asr.yaml: 400 / 160, pre-emphasis 0.97), the TTS
# frontend (config/feat/log_mel/tts.yaml: 800 / 200, fmin 125, fmax 7600)
# and a window one sample short of n_fft, which takes the direct DFT; each
# on the same 16 x 8 s of noise (utterance 1 12,345 samples short)
def logmel_cases():
    from speechain_tpu_torch.ops.frontend import FrontendConfig
    return (("asr", FrontendConfig(n_mels=80, preemphasis=0.97)),
            ("tts", FrontendConfig(n_mels=80, win_length=0.05,
                                   hop_length=0.0125, fmin=125, fmax=7600)),
            ("direct", FrontendConfig(n_mels=80, preemphasis=0.97,
                                      win_length=399, n_fft=400)))


# the evaluation frontends (utils/tts_eval.py::wav_to_logmel: 50 ms
# windows, 12.5 ms hops, no pre-emphasis, mels up to Nyquist): n_fft 800,
# 401 bins at 16 kHz (2 passes over the basis) and n_fft 1102, 552 bins
# at 22.05 kHz (3 passes); the evaluation scores one utterance a call, so
# each runs on one utterance of EVAL_SECS s and a sample (13 blocks)
EVAL_SECS = 5


def logmel_eval_cases():
    from speechain_tpu_torch.ops.frontend import FrontendConfig
    return tuple((f"eval {sr} Hz", FrontendConfig(
        n_mels=80, sr=sr, win_length=0.05, hop_length=0.0125))
        for sr in (16000, 22050))


def logmel_cost(cfg, Bq: int, L: int):
    """(bytes, operations, direct operations) of one log-Mel call: the
    waveform and lengths read and the features written once, the staged
    basis and band weights read once; operations as the kernel needs
    them (folded where ``dft_folds``: per frame 2 N F multiply-add
    operations, N - 2 fold adds, 3 F power and 2 nnz banded mel
    operations; else 4 N F), and the direct DFT with the dense mel
    product (4 N F + 3 F + 2 F n_mels, earlier PRs' bound)."""
    from speechain_tpu_torch.ops import cuda_logmel as cm
    from speechain_tpu_torch.ops.frontend import dft_folds, num_frames
    N, Fq = cfg.fft, cfg.n_freqs
    frames = Bq * int(num_frames(L, N, cfg.hop, cfg.center))
    nnz = len(cm.band_weights(cfg)[0]) - 1
    rows = N // 2 if dft_folds(cfg) else N
    nbytes = 4 * (Bq * L + rows * 2 * Fq + nnz + frames * cfg.n_mels) \
        + 8 * Bq
    dft = 2 * N * Fq + (N - 2) if dft_folds(cfg) else 4 * N * Fq
    return (nbytes, frames * (dft + 3 * Fq + 2 * nnz),
            frames * (4 * N * Fq + 3 * Fq + 2 * Fq * cfg.n_mels))


def logmel_composed(wave, wave_len, cfg):
    """The row's yardstick: the log-Mel composed of library calls in
    float32, torch.stft (cuFFT; Hann window, reflect centre padding),
    power, the mel product (cuBLAS), clamp / log; the length mask as the
    plain version's. Timed only, never in the port."""
    import torch
    from speechain_tpu_torch.ops.frontend import (frontend_constants,
                                                  num_frames, preemphasize)
    x = wave
    if cfg.preemphasis is not None:
        x = preemphasize(x, wave_len, cfg.preemphasis)
    spec = torch.stft(x, cfg.fft, cfg.hop, cfg.win,
                      window=torch.hann_window(cfg.win, device=x.device),
                      center=cfg.center, pad_mode="reflect",
                      onesided=cfg.onesided, return_complex=True)
    power = torch.view_as_real(spec).pow(2).sum(-1).transpose(1, 2)
    feat = torch.log(torch.clamp(power @ frontend_constants(
        cfg, x.device)[1], min=cfg.clamp)) / math.log(cfg.log_base)
    feat_len = num_frames(wave_len, cfg.fft, cfg.hop, cfg.center)
    valid = torch.arange(feat.shape[1], device=x.device)[None] \
        < feat_len[:, None]
    return torch.where(valid[..., None], feat, torch.zeros_like(feat))


def check_logmel(compare, cases):
    """Row 1 at each case (label, config, wave (B, L), wave_len): the kernel
    against its plain version (1e-4 absolute), its time per call and on
    the device, the folded and the direct bound, the composition
    yardstick; every output bit-equal over three further launches; the
    launch as built (``logmel_layout``) against the wrapper's
    ``geometry`` for every instance that fits; every instance's
    registers and spills (none allowed); then the tile sweep: each case
    timed on the device with every instance that fits, and the wrapper's
    pick, timed twice, must be within SWEEP_SLACK of the fastest.
    Returns the case records (the first case's first)."""
    import torch
    from speechain_tpu_torch.ops import cuda_logmel as cm
    from speechain_tpu_torch.ops.cuda_ffn import _sm_count
    sms = _sm_count(cases[0][2].device)
    recs, slow = [], []
    if cm.KERNEL.build_log:
        regs = ptxas_table(cm.KERNEL.build_log, names=("logmel_",))
        log("  logmel registers (spill stores / loads, bytes): " + ", ".join(
            f"{n}<{','.join(map(str, t))}> {r} ({a}/{b})"
            for n, t, r, a, b in regs))
        if any(a or b for *_, a, b in regs) or len(regs) != len(
                cm.FRAMES_PER_WARP):
            raise RuntimeError(f"logmel: spills or instances not as built: "
                               f"{regs}")
    else:
        log("  logmel registers not read: the library was built before")
    for label, cfg, wave, wave_len in cases:
        Bq, L = wave.shape
        nbytes, ops, ops_direct = logmel_cost(cfg, Bq, L)
        geo = cm.geometry(cfg, Bq, L, sms)
        rec = compare(
            f"logmel {label}", torch.float32,
            lambda cfg=cfg: cm.cuda_logmel(wave, wave_len, cfg)[0],
            lambda cfg=cfg: cm.logmel_plain(wave, wave_len, cfg)[0],
            1e-4, nbytes, ops,
            f"wave ({Bq}, {L}) -> {cfg.n_mels} mels, n_fft {cfg.fft} / "
            f"hop {cfg.hop}, {geo['variant']}", absolute=True, device=True)
        rec["direct_bound_ms"] = bound(nbytes, ops_direct, "float32")[0]
        check_repeats(f"logmel {label}",
                      lambda cfg=cfg: cm.cuda_logmel(wave, wave_len, cfg))
        comp = logmel_composed(wave, wave_len, cfg)
        rec["library_composition_err"] = float(
            (comp - cm.logmel_plain(wave, wave_len, cfg)[0]).abs().max())
        rec["library_composition_ms"] = cuda_time(
            lambda cfg=cfg: logmel_composed(wave, wave_len, cfg))
        rec["library_composition_device_ms"] = profiled_time(
            lambda cfg=cfg: logmel_composed(wave, wave_len, cfg))
        times, built = {}, {}
        for tf in cm.FRAMES_PER_WARP:
            try:
                want = cm.geometry(cfg, Bq, L, sms, tf)
            except ValueError:
                continue                   # this instance does not fit
            got = cm.built_layout(cfg, Bq, L, tf)
            if got != {k: want[k] for k in got}:
                raise RuntimeError(f"logmel {label} tf {tf}: the kernel "
                                   f"launches {got}, the wrapper reckons "
                                   f"{want}")
            built[tf] = want["grid"]
            times[tf] = graph_time(lambda cfg=cfg, tf=tf: cm._launch(
                wave, wave_len, cfg, tf), reps=20)
        best = min(times, key=times.get)
        again = graph_time(lambda cfg=cfg: cm.cuda_logmel(wave, wave_len,
                                                           cfg), reps=20)
        rec["sweep"] = dict(device_ms={str(k): v for k, v in times.items()},
                            picked=geo["tf"], fastest=best,
                            picked_again_ms=again, grids=built)
        log(f"    direct bound {rec['direct_bound_ms']:.4f} ms; composition"
            f" (stft + mel) err {rec['library_composition_err']:.2e}, "
            f"{rec['library_composition_ms']:.4f} ms a call, device "
            f"{rec['library_composition_device_ms']:.4f}; sweep (TF: device"
            " ms) " + ", ".join(f"{k}: {v:.4f}" for k, v in sorted(
                times.items(), key=lambda kv: kv[1]))
            + f"; picked {geo['tf']} ({times[geo['tf']] / times[best]:.2f}x"
            f" the fastest, {best}; again {again:.4f}); launches as "
            f"reckoned {built}")
        if min(times[geo["tf"]], again) > SWEEP_SLACK * times[best]:
            slow.append(f"{label}: picked {geo['tf']} "
                        f"{times[geo['tf']]:.4f} ms, {best} "
                        f"{times[best]:.4f}")
        recs.append(rec)
    if slow:
        raise RuntimeError("logmel picks over SWEEP_SLACK: "
                           + "; ".join(slow))
    return recs


def logmel_ab():
    """Device ms of ``cuda_logmel`` at every ``logmel_cases`` case on
    phase 2's waveform (three CUDA graphs of 20 calls each), as one JSON
    line: the A/B of row 1, run the same way against an earlier tree."""
    import torch
    from speechain_tpu_torch.ops import cuda_logmel
    gen = torch.Generator(device="cpu").manual_seed(1)
    L = SECS * SR
    wave = (torch.randn(B, L, generator=gen) * 0.1).to("cuda")
    wave_len = torch.full((B,), L, dtype=torch.int32, device="cuda")
    wave_len[1] = L - 12345
    cuda_logmel.KERNEL.lib
    out = {}
    for label, cfg in logmel_cases():
        out[label] = [graph_time(lambda cfg=cfg: cuda_logmel.cuda_logmel(
            wave, wave_len, cfg), reps=20) for _ in range(3)]
    return out


def check_ragged_shapes():
    """Each kernel against its plain version at shapes that leave partial
    tiles (rows, frames, queries) in every kernel; errors only."""
    import torch
    from speechain_tpu_torch.ops import (cuda_attention, cuda_convmod,
                                         cuda_logmel)
    from speechain_tpu_torch.ops.frontend import FrontendConfig
    gen = torch.Generator(device="cpu").manual_seed(2)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen) * scale).to(
            device="cuda", dtype=dtype)

    bf = torch.bfloat16
    cfg = FrontendConfig(n_mels=80, preemphasis=0.97)
    wave = rnd(3, 12345, scale=0.1)
    wave_len = torch.tensor([12345, 9000, 500], dtype=torch.int32,
                            device="cuda")
    q, k, v = (rnd(3, 77, D, dtype=bf) for _ in range(3))
    ph, bu, bv = rnd(153, D, dtype=bf), rnd(D), rnd(D)
    mask = torch.arange(77, device="cuda")[None] < torch.tensor(
        [[77], [50], [0]], device="cuda")
    cx = rnd(3, 77, D, dtype=bf)
    cw1, cb1 = rnd(2 * D, D, scale=D ** -0.5, dtype=bf), rnd(2 * D, dtype=bf)
    dwk, dwb = rnd(D, 1, K_DW, scale=K_DW ** -0.5), rnd(D, dtype=bf)
    cases = [
        ("logmel (3, 12345), short rows", 1e-4, True,
         lambda: cuda_logmel.cuda_logmel(wave, wave_len, cfg)[0],
         lambda: cuda_logmel.logmel_plain(wave, wave_len, cfg)[0]),
        *((f"relpos_attention T=77, empty row, drop={rate}", 2 ** -6, False,
           lambda rate=rate: cuda_attention.cuda_relpos_attention(
               q, k, v, ph, bu, bv, D ** -0.5, H, mask, rate, 5),
           lambda rate=rate: cuda_attention.relpos_attention_plain(
               q, k, v, ph, bu, bv, D ** -0.5, H, mask, rate, 5))
          for rate in (0.0, 0.1)),
        ("conv_glu_dw T=77", 2 ** -6, False,
         lambda: cuda_convmod.cuda_conv_glu_dw(cx, cw1, cb1, dwk, dwb)[0],
         lambda: cuda_convmod.conv_glu_dw_plain(cx, cw1, cb1, dwk, dwb)[0]),
    ]
    check_convmod_stats("conv_glu_dw T=77",
                        cuda_convmod.cuda_conv_glu_dw(cx, cw1, cb1, dwk, dwb),
                        cuda_convmod.conv_glu_dw_plain(cx, cw1, cb1, dwk,
                                                       dwb), bf)
    check_repeats("logmel (3, 12345)",
                  lambda: cuda_logmel.cuda_logmel(wave, wave_len, cfg))
    for label, ecfg in logmel_eval_cases():     # odd L, the second short
        L2 = EVAL_SECS * ecfg.sr + 1
        ew = rnd(2, L2, scale=0.1)
        elen = torch.tensor([L2, L2 - 4321], dtype=torch.int32,
                            device="cuda")
        cases.append((f"logmel {label} (2, {L2}), short row", 1e-4, True,
                      lambda ew=ew, elen=elen, c=ecfg:
                      cuda_logmel.cuda_logmel(ew, elen, c)[0],
                      lambda ew=ew, elen=elen, c=ecfg:
                      cuda_logmel.logmel_plain(ew, elen, c)[0]))
        check_repeats(f"logmel {label} (2, {L2})",
                      lambda ew=ew, elen=elen, c=ecfg:
                      cuda_logmel.cuda_logmel(ew, elen, c))
    for name, tol_rel, absolute, kernel_fn, plain_fn in cases:
        got, want = kernel_fn().float(), plain_fn().float()
        err = float((got - want).abs().max())
        tol = tol_rel if absolute else tol_rel * max(
            1.0, float(want.abs().max()))
        ok = bool(torch.isfinite(got).all()) and err <= tol
        log(f"  {name:<34} max_abs_err {err:.3e} (tol {tol:.1e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{name}: error {err} > {tol}")
    for rate in (0.0, 0.1):                       # the ragged FFN forward
        ffn_case("ragged", 2985, D, F_DIM, "GELU", 0.5, True, rate, bf,
                 False, 22, timed=False)


def check_long_relpos():
    """The rel-pos forward at T = 406, 600 and 768 (the JAX module's
    ``MAX_T``; about 16 s, 24 s and 31 s of audio) against its plain
    version, float32 and bfloat16, at dropout 0.1; returns the timed
    records."""
    import torch
    from speechain_tpu_torch.ops import cuda_attention as ca
    gen = torch.Generator(device="cpu").manual_seed(4)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen) * scale).to(
            device=DEV, dtype=dtype)

    calls = []
    for T in (406, 600, 768):
        Bq = 4
        lens = torch.tensor([T, T - 100, T // 2, 1])
        km = (torch.arange(T)[None] < lens[:, None]).to(DEV)
        for dtype in (torch.bfloat16, torch.float32):
            dt = "float32" if dtype == torch.float32 else "bfloat16"
            tol = 1e-4 if dtype == torch.float32 else 2 ** -6
            q, k, v = (rnd(Bq, T, D, dtype=dtype) for _ in range(3))
            ph = rnd(2 * T - 1, D, dtype=dtype)
            bu, bv = rnd(D, scale=0.3), rnd(D, scale=0.3)
            args = (q, k, v, ph, bu, bv, D ** -0.5, H, km, 0.1, 321)
            with torch.no_grad():
                err = compare_all(f"relpos_attention T={T} {dt}",
                                  [ca.cuda_relpos_attention(*args)],
                                  [ca.relpos_attention_plain(*args)], tol)
                rec = dict(call=f"relpos_attention long T={T} drop=0.1",
                           dtype=dt, shape=f"q/k/v ({Bq}, {T}, {D}) H={H}",
                           max_abs_err=err, tol_rel=tol,
                           ms=cuda_time(lambda: ca.cuda_relpos_attention(
                               *args)),
                           plain_ms=cuda_time(
                               lambda: ca.relpos_attention_plain(*args),
                               reps=5, warmup=1), library_ms=None)
            rec["bound_ms"], rec["bound_by"] = bound(
                *relpos_cost(Bq, T, dtype.itemsize), dt)
            log(f"  {rec['call']:<36} {dt:<8} err {err:.3e} (tol "
                f"{tol:.1e}) ok  kernel {rec['ms']:.4f} ms  plain "
                f"{rec['plain_ms']:.4f} ms  bound {rec['bound_ms']:.4f} ms "
                f"({rec['bound_by']})")
            calls.append(rec)
    return calls


# -------------------------------------------------------------- phase 2b

def grad_time(out, inputs, g, reps: int = 20, warmup: int = 3) -> float:
    """ms per backward pass over a retained graph (CUDA events)."""
    import torch
    return cuda_time(lambda: torch.autograd.grad(out, inputs, g,
                                                 retain_graph=True),
                     reps, warmup)


def compare_all(name, got, want, tol_rel):
    """Largest absolute error over pairs of arrays; each pair within
    tol_rel x max(1, max|want|), else raise."""
    import torch
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.detach().float(), w.detach().float()
        if not bool(torch.isfinite(g).all()):
            raise RuntimeError(f"{name}: non-finite output {i}")
        err = float((g - w).abs().max())
        tol = tol_rel * max(1.0, float(w.abs().max()))
        if err > tol:
            raise RuntimeError(f"{name}: output {i} error {err} > {tol}")
        worst = max(worst, err)
    return worst


REPEATS = 3           # further launches that check_repeats holds bit-equal


def check_repeats(name, entry, runs: int = REPEATS) -> None:
    """Calls ``entry`` (one kernel entry point on fixed inputs, dropout
    seed and offset included) once, then ``runs`` times more, and raises
    unless every tensor it returns is bit-equal to the first call's. The
    kernels add their partial sums in a fixed order and put no atomic on
    a device value, so a difference is a race: a shared-memory read that
    no barrier orders after its fill."""
    import torch

    def outputs():
        out = entry()
        out = out if isinstance(out, (tuple, list)) else (out,)
        return [t.clone() for t in out if torch.is_tensor(t)]
    first = outputs()
    for run in range(runs):
        for i, (a, b) in enumerate(zip(first, outputs())):
            if not torch.equal(a, b):
                raise RuntimeError(f"{name}: output {i} of launch {run + 2} "
                                   "differs from the first launch's")


# ------------------------------------------------- the FFN kernels (rows 2-5)

def ffn_composed(x, w1, b1, w2, b2, act, res, alpha, mask, rmask):
    """The FFN composed of library calls in x's dtype: F.linear (cuBLAS),
    the activation, the dropout masks as products and the residual add.
    The yardstick of rows 2-5 (no single PyTorch call computes them); the
    port never calls it."""
    import torch.nn.functional as F
    from speechain_tpu_torch.ops import cuda_ffn
    cd = x.dtype
    h = cuda_ffn.get_activation(act)(F.linear(x, w1.to(cd), b1.to(cd)))
    if mask is not None:
        h = h * mask
    y = F.linear(h, w2.to(cd), b2.to(cd))
    if res is not None:
        if rmask is not None:
            y = y * rmask
        y = res + alpha * y
    return y


# ReLU units whose pre-activation lies this close to 0, relative to the
# sum of its terms' magnitudes, are kinks: a float32 sum in another order
# (the kernel's, the plain version's) can put them on either side of 0
# (2^-18: D <= 1024 terms, each sum's error under D x 2^-24 of it)
KINK_REL = 2.0 ** -18


def relu_kink_dx(x, w1, b1, w2, g, alpha, rate, res_rate, dx_kernel,
                 dx_plain, tol_rel):
    """The input gradient of a ReLU FFN, the kernel's against the plain
    version's, where the two may take different branches at kinks. Each
    row must be within tol_rel x max(1, max|dx_plain|) of the plain
    version's row, or of the plain row with some of its kink units (at
    most 4 a row) on the other branch: the plain dx plus, for each such
    unit j, -/+ dz_j W1[j] (dz_j = (g_y W2)_j x its dropout mask, g_y the
    output gradient times alpha and the residual-dropout mask). Returns
    (the largest error so accounted for, the number of kink units, the
    rows that took another branch)."""
    import itertools
    import torch
    from speechain_tpu_torch.ops import cuda_ffn
    from speechain_tpu_torch.ops import dropout as drop
    cd = x.dtype
    N = x.shape[0]
    xr = x.detach().double()
    w1r = cuda_ffn.round_to(w1.detach().float(), cd).double()
    w2r = cuda_ffn.round_to(w2.detach().float(), cd).double()
    z = xr @ w1r.t() + b1.detach().double()
    mag = xr.abs() @ w1r.abs().t() + b1.detach().double().abs()
    kink = z.abs() <= KINK_REL * mag
    with torch.no_grad():                   # the plain version's branch
        zp = x.detach().float() @ w1r.float().t() + b1.detach().float()
        on = cuda_ffn.round_to(zp, cd) > 0
    gy = g.detach().double() * alpha
    if res_rate > 0.0:
        gy = gy * drop.ffn_mask(N, gy.shape[1], res_rate, -77, x.device)
    dz = gy @ w2r                                        # (N, F)
    if rate > 0.0:
        dz = dz * drop.ffn_mask(N, dz.shape[1], rate, 1234, x.device)
    sign = torch.where(on, -1.0, 1.0).double()           # toward the other
    tol = tol_rel * max(1.0, float(dx_plain.abs().max()))
    err = (dx_kernel.float() - dx_plain.float()).abs().amax(-1)
    worst, flipped = float(err[err <= tol].max()), []
    for row in (err > tol).nonzero().flatten().tolist():
        units = kink[row].nonzero().flatten().tolist()
        best = float("inf")
        for k in range(1, min(len(units), 4) + 1):
            for subset in itertools.combinations(units, k):
                idx = torch.tensor(subset, device=x.device)
                alt = dx_plain[row].double() + (
                    sign[row, idx] * dz[row, idx]) @ w1r[idx]
                best = min(best, float((dx_kernel[row].double() - alt)
                                       .abs().max()))
        if best > tol:
            raise RuntimeError(f"dx row {row}: error {float(err[row])} > "
                               f"{tol}, {len(units)} kink units, {best} "
                               "with any of them on the other branch")
        worst = max(worst, best)
        flipped.append(row)
    return worst, int(kink.sum()), flipped


def ffn_case(label, N, Dm, Fm, act, alpha, with_res, rate, dtype,
             backward, seed, timed=True):
    """One FFN call against ffn_plain on the card: the forward's output, or
    every gradient against autograd of ffn_plain (x, residual, W1, b1, W2,
    b2), within 1e-4 (float32) or 2^-6 (bfloat16) of max(1, max|ref|);
    dropout ``rate`` on both sites. The forward takes weights in x's dtype;
    the backward takes float32 weights, cast at use, as the training path
    passes its float32 masters, so the weight gradients compare in float32.
    Either direction then runs its entry point (the backward on the
    weights cast once) REPEATS more times, bit-equal (``check_repeats``).
    Timed: ms a
    call (CUDA events), device ms (one CUDA graph), the plain version's
    ms, and the library composition's (``ffn_composed``; backward: its
    autograd) ms a call and on the device (forward: one CUDA graph;
    backward: torch.profiler's kernel times)."""
    import torch
    from speechain_tpu_torch.ops import cuda_ffn
    from speechain_tpu_torch.ops import dropout as drop
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def rnd(*shape, scale=1.0, dt=torch.float32):
        return (torch.randn(*shape, generator=gen) * scale).to(DEV, dt)

    s = dtype.itemsize
    dt = "float32" if dtype == torch.float32 else "bfloat16"
    tol = 1e-4 if dtype == torch.float32 else 2 ** -6
    wdt = torch.float32 if backward else dtype
    w1 = rnd(Fm, Dm, scale=Dm ** -0.5, dt=wdt)
    w2 = rnd(Dm, Fm, scale=Fm ** -0.5, dt=wdt)
    b1, b2 = rnd(Fm, scale=0.1), rnd(Dm, scale=0.1)
    x = rnd(N, Dm, dt=dtype)
    res = rnd(N, Dm, dt=dtype) if with_res else None
    res_rate = rate if with_res else 0.0
    args = (x, w1, b1, w2, b2, act, res, alpha, rate, res_rate, 1234, -77)
    name = "ffn_backward" if backward else (
        "ffn_residual" if with_res else "ffn")
    rec = dict(call=f"{name} {label} N={N} D={Dm} F={Fm} {act} "
               f"alpha={alpha} drop={rate}", dtype=dt, rate=rate,
               shape=f"x ({N}, {Dm}) F={Fm}", tol_rel=tol, library_ms=None)
    mask = rmask = None
    if rate > 0:
        mask = drop.ffn_mask(N, Fm, rate, 1234, DEV).to(dtype)
        if with_res:
            rmask = drop.ffn_mask(N, Dm, rate, -77, DEV).to(dtype)
    lib_args = (x, w1, b1, w2, b2, act, res, alpha, mask, rmask)
    if not backward:
        with torch.no_grad():
            rec["max_abs_err"] = compare_all(
                rec["call"] + " " + dt, [cuda_ffn.cuda_ffn(*args)],
                [cuda_ffn.ffn_plain(*args)], tol)
            check_repeats(rec["call"] + " " + dt,
                          lambda: cuda_ffn.cuda_ffn(*args))
            if timed:
                rec["ms"] = cuda_time(lambda: cuda_ffn.cuda_ffn(*args))
                rec["device_ms"] = graph_time(
                    lambda: cuda_ffn.cuda_ffn(*args))
                rec["plain_ms"] = cuda_time(
                    lambda: cuda_ffn.ffn_plain(*args), reps=5, warmup=1)
                rec["library_composition_ms"] = cuda_time(
                    lambda: ffn_composed(*lib_args))
                rec["library_composition_device_ms"] = graph_time(
                    lambda: ffn_composed(*lib_args))
        nbytes = (s * (N * Dm + 2 * Fm * Dm + N * Dm * (2 if with_res else 1))
                  + 4 * (Fm + Dm))
        ops = 4 * N * Dm * Fm
    else:
        ins = [t.requires_grad_() for t in (x, res, w1, b1, w2, b2)
               if t is not None]
        g = rnd(N, Dm, dt=dtype)
        out_k = cuda_ffn.cuda_ffn(*args)
        out_p = cuda_ffn.ffn_plain(*args)
        grads_k = torch.autograd.grad(out_k, ins, g, retain_graph=True)
        grads_p = torch.autograd.grad(out_p, ins, g, retain_graph=True)
        if act == "ReLU":        # dx at the kinks: see relu_kink_dx
            dx_err, kinks, flipped = relu_kink_dx(
                x, w1, b1, w2, g, alpha, rate, res_rate, grads_k[0],
                grads_p[0], tol)
            rec.update(kink_units=kinks, kink_rows_flipped=len(flipped))
            if flipped:
                log(f"    {rec['call']} {dt}: dx rows {flipped[:8]} took the "
                    f"other branch at a ReLU kink ({kinks} kink units); "
                    f"within {dx_err:.3e} there")
            rec["max_abs_err"] = max(dx_err, compare_all(
                rec["call"] + " " + dt, grads_k[1:], grads_p[1:], tol))
        else:
            rec["max_abs_err"] = compare_all(rec["call"] + " " + dt,
                                             grads_k, grads_p, tol)
        x2, b1f = x.detach(), b1.detach()
        w1c, w2c = (t.detach().to(dtype) for t in (w1, w2))

        def entry():
            return cuda_ffn.ffn_backward(x2, w1c, b1f, w2c, g, act, alpha,
                                         rate, res_rate, 1234, -77)
        check_repeats(rec["call"] + " " + dt, entry)
        if timed:
            rec["ms"] = cuda_time(entry)
            rec["device_ms"] = graph_time(entry)
            rec["plain_ms"] = grad_time(out_p, ins, g, reps=5, warmup=1)
            lib_ins = [t.detach().requires_grad_() for t in ins]
            it = iter(lib_ins)
            lib = [next(it) if t is not None else None
                   for t in (x, res, w1, b1, w2, b2)]
            out_l = ffn_composed(lib[0], lib[2], lib[3], lib[4], lib[5], act,
                                 lib[1], alpha, mask, rmask)
            rec["library_composition_ms"] = grad_time(out_l, lib_ins, g)
            rec["library_composition_device_ms"] = profiled_time(
                lambda: torch.autograd.grad(out_l, lib_ins, g,
                                            retain_graph=True), reps=5)
        nbytes = s * (3 * N * Dm + 2 * Fm * Dm) + 4 * (2 * Fm * Dm + 2 * Fm
                                                       + Dm)
        ops = 10 * N * Dm * Fm
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops, dt)
    if timed:
        log(f"  {rec['call']:<58} {dt:<8} err {rec['max_abs_err']:.3e}  "
            f"kernel {rec['ms']:.4f} ms (device {rec['device_ms']:.4f})  "
            f"plain {rec['plain_ms']:.4f}  composition "
            f"{rec['library_composition_ms']:.4f} (device "
            f"{rec['library_composition_device_ms']:.4f})  bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    else:
        log(f"  {rec['call']:<58} {dt:<8} err {rec['max_abs_err']:.3e} ok")
    return rec


# the FFN shapes of the paths: (label, N, D = Do, F, activation, alpha)
FFN_PATH_SHAPES = (
    ("decode step", B * BEAM, D, F_DIM, "GELU", 1.0),
    ("conformer encoder", B * 199, D, F_DIM, "GELU", 0.5),
    ("conformer decoder", B * (TW_TEXT - 1), D, F_DIM, "GELU", 1.0),
    ("transformer-wide encoder", B * 199, TW_D, TW_F, "GELU", 1.0),
    ("transformer-wide decoder", B * (TW_TEXT - 1), TW_D, TW_F, "GELU",
     1.0),
    ("tts decoder", 16 * 640, 384, 1536, "ReLU", 1.0),
    ("tts encoder", 16 * 100, 384, 1536, "ReLU", 1.0),
    ("artts decoder", 8 * 300, 256, 2048, "ReLU", 1.0),
    ("artts encoder", 8 * 100, 512, 2048, "ReLU", 1.0),
    ("artts synthesis step", 16, 256, 2048, "ReLU", 1.0))
# shapes whose paths run no FFN backward
FFN_FORWARD_ONLY = ("tts", "decode", "artts synthesis")


# how much slower than the fastest instance the one tc_geometry picks may
# be: five times the largest gap (1.8 %, H100) between an instance's
# device time in the sweep and in the checks above at the same shape
SWEEP_SLACK = 1.10


def check_ffn_instances():
    """The bf16 FFN kernels as built against the reckoning of
    ``ops/cuda_ffn.py``: each instance's shared memory equal to
    ``tc_smem_bytes`` at the recipes' widths, its registers within
    ``tc_register_budget``; registers and spill bytes logged. Then the
    tile sweep: every instance (``TC_TILES``) timed on the device at each
    path shape, forward and backward; the instance ``tc_geometry`` picks
    must be within ``SWEEP_SLACK`` of the fastest. Returns both tables."""
    import torch
    from speechain_tpu_torch.ops import cuda_ffn
    rows = []
    for kind in ("forward", "backward", "wgrad"):
        for nt in ((1,) if kind == "wgrad" else cuda_ffn.TC_TILES):
            for width in ((0,) if kind == "wgrad" else (256, 384, 512, 768)):
                got = cuda_ffn.built_tc_attrs(kind, nt, width, width)
                want, slots = cuda_ffn.tc_smem_bytes(kind, width, width)
                budget = cuda_ffn.tc_register_budget(kind, nt)
                if got["smem"] != want or got["slots"] != slots:
                    raise RuntimeError(f"ffn {kind} NT={nt} D={width}: built "
                                       f"{got}, reckoned {want} B, {slots} "
                                       "slots")
                if got["registers"] > budget:
                    raise RuntimeError(f"ffn {kind} NT={nt}: {got} over the "
                                       f"budget of {budget} registers")
                rows.append(dict(kind=kind, nt=nt, width=width, **got,
                                 register_budget=budget))
        log(f"  ffn {kind}: registers (spill bytes) by NT "
            + ", ".join(f"{r['nt']}: {r['registers']} ({r['spill_bytes']})"
                        for r in rows if r["kind"] == kind
                        and r["width"] in (0, 512))
            + "; shared memory as reckoned at D 256-768")
    sweep = []
    gen = torch.Generator(device="cpu").manual_seed(13)
    geometry = cuda_ffn.tc_geometry
    bf = torch.bfloat16
    try:
        for label, N, Dm, Fm, act, alpha in FFN_PATH_SHAPES:
            def rnd(*shape, scale=1.0, dt=bf):
                return (torch.randn(*shape, generator=gen) * scale).to(DEV,
                                                                        dt)
            w1, w2 = rnd(Fm, Dm, scale=Dm ** -0.5), rnd(Dm, Fm,
                                                        scale=Fm ** -0.5)
            b1 = rnd(Fm, scale=0.1, dt=torch.float32)
            b2 = rnd(Dm, scale=0.1, dt=torch.float32)
            x, res, g = rnd(N, Dm), rnd(N, Dm), rnd(N, Dm)
            for kind in ("forward", "backward"):
                if kind == "backward" and label.startswith(FFN_FORWARD_ONLY):
                    continue                     # no backward on these paths
                pick = geometry(kind, N, Dm, Dm)[0]
                times = {}
                for nt in cuda_ffn.TC_TILES:
                    if nt > 1 and nt // 2 >= -(-Dm // 64):
                        break
                    cuda_ffn.tc_geometry = (lambda *a, nt=nt, **k: (nt, 0))
                    if kind == "forward":
                        fn = (lambda: cuda_ffn.cuda_ffn(
                            x, w1, b1, w2, b2, act, res, alpha, 0.1, 0.1, 5,
                            6))
                    else:
                        fn = (lambda: cuda_ffn.ffn_backward(
                            x, w1, b1, w2, g, act, alpha, 0.1, 0.1, 5, 6))
                    with torch.no_grad():
                        times[nt] = graph_time(fn, reps=10)
                cuda_ffn.tc_geometry = geometry
                best = min(times, key=times.get)
                sweep.append(dict(shape=label, N=N, D=Dm, kind=kind,
                                  device_ms_by_nt=times, picked=pick,
                                  fastest=best))
                log(f"  ffn tile sweep {kind:<8} {label:<26} N={N:<5} device "
                    "ms by NT " + ", ".join(f"{k}: {v:.4f}"
                                            for k, v in times.items())
                    + f"; picked {pick}, fastest {best} "
                    f"({times[pick] / times[best]:.2f}x)")
                if times[pick] > SWEEP_SLACK * times[best]:
                    raise RuntimeError(
                        f"ffn {kind} {label}: tc_geometry picks NT={pick} "
                        f"({times[pick]:.4f} ms), NT={best} takes "
                        f"{times[best]:.4f} ms")
    finally:
        cuda_ffn.tc_geometry = geometry
    return dict(instances=rows, tile_sweep=sweep)


def check_training_kernels():
    """FFN backward and flash attention forward/backward against their
    plain versions (gradients: autograd of the plain version) at the
    training path's shapes, and at partial-tile shapes; returns one record
    list per entry point, the path's bf16 dropout-0.1 call first."""
    import torch
    import torch.nn.functional as F
    from speechain_tpu_torch.ops import cuda_flash_attention as cfa
    gen = torch.Generator(device="cpu").manual_seed(3)

    def rnd(*shape, scale=1.0, dtype=torch.float32, grad=False):
        return (torch.randn(*shape, generator=gen) * scale).to(
            device=DEV, dtype=dtype).requires_grad_(grad)

    records = {"ffn_backward": [], "flash_attention": [],
               "flash_attention_backward": []}
    T_enc, L_dec = 199, TW_TEXT - 1
    D, Fd, Hh = TW_D, TW_F, TW_H

    # ---- FFN + residual backward (rows 3/5) and forward (row 4) --------
    for dtype in (torch.bfloat16, torch.float32):
        for rate in (0.1, 0.0):
            for label, N, timed in (("encoder", B * T_enc, True),
                                    ("decoder", B * L_dec, True),
                                    ("partial", 2985, False)):
                records["ffn_backward"].append(ffn_case(
                    "transformer-wide " + label, N, D, Fd, "GELU", 1.0, True,
                    rate, dtype, True, 31, timed))
    ffn_fwd = [ffn_case("transformer-wide " + label, N, D, Fd, "GELU", 1.0,
                        True, rate, torch.bfloat16, False, 32)
               for label, N in (("encoder", B * T_enc), ("decoder", B * L_dec))
               for rate in (0.1, 0.0)]
    # Transformer-TTS (phases 19 and 21): the decoder's FFN at D 256 / F
    # 2048 in training (forward and backward, both dtypes), the encoder's
    # at D 512, and the synthesis step's forward at N = 16 rows
    for dtype in (torch.bfloat16, torch.float32):
        for rate in (0.1, 0.0):
            for backward in (True, False):
                rec = ffn_case("artts decoder", ARTTS_B * ARTTS_DEC_T,
                               ARTTS_W, ARTTS_F, "ReLU", 1.0, True, rate,
                               dtype, backward, 34,
                               timed=dtype == torch.bfloat16)
                (records["ffn_backward"] if backward
                 else ffn_fwd).append(rec)
    for backward in (True, False):
        rec = ffn_case("artts encoder", ARTTS_B * ARTTS_TOKENS, ARTTS_D,
                       ARTTS_F, "ReLU", 1.0, True, 0.1, torch.bfloat16,
                       backward, 35)
        (records["ffn_backward"] if backward else ffn_fwd).append(rec)
    for dtype in (torch.bfloat16, torch.float32):
        ffn_fwd.append(ffn_case("artts synthesis step", ARTTS_SYNTH_B,
                                ARTTS_W, ARTTS_F, "ReLU", 1.0, True, 0.0,
                                dtype, False, 36,
                                timed=dtype == torch.bfloat16))
    # the recipes' widest FFN (the LM recipes' d_model 768, F 3072), at
    # the instance tc_geometry picks there
    for backward in (False, True):
        rec = ffn_case("d768", B * T_enc, 768, 3072, "GELU", 1.0, True, 0.1,
                       torch.bfloat16, backward, 33, timed=False)
        (records["ffn_backward"] if backward else ffn_fwd).append(rec)

    # ---- flash attention forward and backward (rows 6/7) ---------------
    # the shared memory the wrapper's module reckons is the built kernels'
    from speechain_tpu_torch.ops.cuda_attention import flash_smem_bytes
    for dtype in (torch.bfloat16, torch.float32):
        for Tk in range(1, 2001):
            want = flash_smem_bytes(Tk, dtype)
            got = cfa.built_smem_bytes(Tk, dtype)
            if got != want:
                raise RuntimeError(f"flash attention, {dtype} Tk={Tk}: the "
                                   f"kernels take {got} bytes of shared "
                                   f"memory, the reckoning says {want}")
    log("  flash attention shared memory as reckoned for Tk = 1..2000")

    # (label, B, Tq, Tk, causal, timed, D, H): the transformer-wide
    # training path's calls, the conformer-small decoder's (phase 8), a
    # longer text, long rows, one key, and ragged masks with an empty key
    # row (untimed cases)
    cases = (("encoder self", B, T_enc, T_enc, False, True, D, Hh),
             ("decoder self causal", B, L_dec, L_dec, True, True, D, Hh),
             ("decoder cross", B, L_dec, T_enc, False, True, D, Hh),
             ("conformer decoder self causal", B, L_dec, L_dec, True, True,
              256, 4),
             ("conformer decoder cross", B, L_dec, T_enc, False, True, 256,
              4),
             ("decoder self causal T=128", B, 128, 128, True, True, D, Hh),
             ("long T=600", 4, 600, 600, False, True, D, Hh),
             ("long T=768", 4, 768, 768, False, True, D, Hh),
             ("long causal T=768 empty row", 4, 768, 768, True, False, D,
              Hh),
             ("one key Tq=Tk=1", 2, 1, 1, False, False, D, Hh),
             ("partial T=77 empty row", 3, 77, 77, True, False, D, Hh),
             ("artts decoder self causal", ARTTS_B, ARTTS_DEC_T,
              ARTTS_DEC_T, True, True, ARTTS_W, ARTTS_H),
             ("artts decoder cross", ARTTS_B, ARTTS_DEC_T, ARTTS_TOKENS,
              False, True, ARTTS_W, ARTTS_H))
    for dtype in (torch.bfloat16, torch.float32):
        s = dtype.itemsize
        dt = "float32" if dtype == torch.float32 else "bfloat16"
        tol = 1e-4 if dtype == torch.float32 else 2 ** -6
        for rate in (0.1, 0.0):
            for label, Bq, Tq, Tk, causal, timed, Dm, Hm in cases:
                q = rnd(Bq, Tq, Dm, dtype=dtype, grad=True)
                k = rnd(Bq, Tk, Dm, dtype=dtype, grad=True)
                v = rnd(Bq, Tk, Dm, dtype=dtype, grad=True)
                g = rnd(Bq, Tq, Dm, dtype=dtype)
                lens = torch.randint(Tk // 2, Tk + 1, (Bq,), generator=gen)
                lens[0] = Tk
                if not timed:
                    lens[-1] = 0                 # an empty key row
                km = (torch.arange(Tk)[None] < lens[:, None]).to(DEV)
                sc = Dm ** -0.5
                args = (q, k, v, sc, Hm, causal, rate, 99, km)
                out_k = cfa.flash_attention(*args)
                out_p = cfa.flash_attention_plain(*args)
                gk = torch.autograd.grad(out_k, (q, k, v), g,
                                         retain_graph=True)
                gp = torch.autograd.grad(out_p, (q, k, v), g,
                                         retain_graph=True)
                shape = f"q ({Bq}, {Tq}, {Dm}) k ({Bq}, {Tk}) H={Hm}"
                call = f"{label} drop={rate}"
                ferr = compare_all("flash fwd " + call, [out_k], [out_p],
                                   tol)
                berr = compare_all("flash bwd " + call, gk, gp, tol)
                fwd = dict(call=call, dtype=dt, rate=rate, shape=shape,
                           max_abs_err=ferr, tol_rel=tol)
                bwd = dict(fwd, max_abs_err=berr)
                with torch.no_grad():
                    fa = (q.detach(), k.detach(), v.detach(),
                          km.to(torch.int32), sc, Hm, causal, rate, 99)
                    check_repeats(f"flash fwd {call} {dt}",
                                  lambda: cfa._launch_forward(*fa))
                    _, M, L = cfa._launch_forward(*fa)

                    def kernel_bwd():
                        return cfa.flash_attention_backward(
                            *fa[:4], g, M, L, *fa[4:])
                    check_repeats(f"flash bwd {call} {dt}", kernel_bwd)
                if timed:
                    pairs = (Tq * (Tq + 1) / 2) if causal else Tq * Tk
                    qh, kh, vh = (t.detach().reshape(
                        Bq, -1, Hm, Dm // Hm).transpose(1, 2).contiguous()
                        .requires_grad_() for t in (q, k, v))
                    am = km[:, None, None, :]
                    if causal:
                        am = am & torch.ones(Tq, Tk, dtype=torch.bool,
                                             device=DEV).tril()

                    def sdpa():
                        return F.scaled_dot_product_attention(
                            qh, kh, vh, attn_mask=am, dropout_p=rate,
                            scale=sc)
                    with torch.no_grad():
                        fwd["ms"] = cuda_time(
                            lambda: cfa.flash_attention(*args))
                        fwd["device_ms"] = graph_time(
                            lambda: cfa.flash_attention(*args))
                        fwd["plain_ms"] = cuda_time(
                            lambda: cfa.flash_attention_plain(*args),
                            reps=5, warmup=1)
                        fwd["library_ms"] = cuda_time(sdpa)
                        fwd["library_device_ms"] = graph_time(sdpa)
                    lib = sdpa()
                    gh = g.reshape(Bq, Tq, Hm, -1).transpose(1, 2)
                    with torch.no_grad():
                        bwd["ms"] = cuda_time(kernel_bwd)
                        bwd["device_ms"] = graph_time(kernel_bwd)
                        split = {}
                        bwd["device_ms_profiled"] = profiled_time(
                            kernel_bwd, by_kernel=split)
                        bwd["device_ms_by_kernel"] = split

                    def sdpa_bwd():
                        return torch.autograd.grad(lib, (qh, kh, vh), gh,
                                                   retain_graph=True)
                    bwd["plain_ms"] = grad_time(out_p, (q, k, v), g,
                                                reps=5, warmup=1)
                    bwd["library_ms"] = cuda_time(sdpa_bwd)
                    # autograd through SDPA runs outside a graph here:
                    # both backwards' device times from the profiler
                    bwd["library_device_ms"] = profiled_time(sdpa_bwd)
                    mbytes = 4 * Bq * Tk
                    fwd["bound_ms"], fwd["bound_by"] = bound(
                        s * (2 * Bq * Tq * Dm + 2 * Bq * Tk * Dm) + mbytes,
                        4 * Bq * pairs * Dm, dt)
                    bwd["bound_ms"], bwd["bound_by"] = bound(
                        s * (3 * Bq * Tq * Dm + 4 * Bq * Tk * Dm) + mbytes,
                        10 * Bq * pairs * Dm, dt)
                    for nm, r in (("flash fwd", fwd), ("flash bwd", bwd)):
                        log(f"  {nm + ' ' + call:<48} {dt:<8} err "
                            f"{r['max_abs_err']:.3e}  kernel {r['ms']:.4f}"
                            f" ms (device {r['device_ms']:.4f}"
                            + (f", profiled {r['device_ms_profiled']:.4f}"
                               if "device_ms_profiled" in r else "")
                            + f")  plain {r['plain_ms']:.4f} ms  sdpa "
                            f"{r['library_ms']:.4f} ms (device "
                            f"{r['library_device_ms']:.4f})  bound "
                            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
                    log("    backward by kernel: " + ", ".join(
                        f"{name} {ms:.4f}" for name, ms in
                        bwd["device_ms_by_kernel"].items()))
                    del lib, qh, kh, vh
                else:
                    log(f"  flash {call:<46} {dt:<8} err fwd {ferr:.3e} "
                        f"bwd {berr:.3e} ok")
                records["flash_attention"].append(fwd)
                records["flash_attention_backward"].append(bwd)
                del out_k, out_p, gk, gp
    return records, ffn_fwd


# -------------------------------------------------------------- phase 2c

def convmod_cost(Bq: int, T: int, s: int, backward: bool = False,
                 C: int = D):
    """(bytes, operations) of one conv-module front-half call at dtype
    size s and C channels (conformer-small's D by default): x, the
    weights and u (and du, dx and the float32 weight gradients in the
    backward) once each; the pointwise product (2 x 2C x C per frame; the
    backward also forms dx and dW1, 3 of them), the depthwise sum (and its
    transpose and ddwk) and the GLU."""
    N, K = Bq * T, K_DW
    w = s * (2 * C * C + 3 * C) + 4 * C * K
    if backward:
        nbytes = (s * 4 * N * C + w + 8 * C
                  + 4 * (2 * C * C + 2 * C + C * K + C))
        return nbytes, N * (3 * 4 * C * C + 2 * 2 * C * K + 12 * C)
    return s * 2 * N * C + w + 8 * C, N * (4 * C * C + 2 * C * K + 4 * C)


def check_convmod_stats(name, got, want, dtype):
    """The conv module's s and ss (sums of B T rounded u values) against
    the plain version's, relative to their size: 1e-4 in float32, 1e-2 in
    bf16 (a u rounded the other way moves them by its ulp)."""
    import torch
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for what, g, w in zip(("s", "ss"), got[1:], want[1:]):
        rel = float((g - w).abs().max() / w.abs().max().clamp(min=1e-6))
        if rel > tol:
            raise RuntimeError(f"{name}: {what} off by {rel} (tol {tol}, "
                               "relative)")


def check_relpos_stats(name, args, tol=1e-4):
    """The forward's row maximum M and denominator L, which the backward
    reads, against the plain scores' row maximum and sum of exp(s - max)
    (``relpos_scores_plain``, float32 on the same inputs): within tol x
    max(1, |ref|) and tol relative. ``args`` as cuda_relpos_attention's,
    key mask as bool."""
    import torch
    from speechain_tpu_torch.ops import cuda_attention as ca
    q, k, v, ph, bu, bv, scale, Hm, km, rate, seed = args
    with torch.no_grad():
        _, M, L = ca._launch_forward(q, k, v, ph, bu, bv,
                                     km.to(torch.int32), scale, Hm, rate,
                                     seed)
        s = ca.relpos_scores_plain(q, k, ph, bu, bv, scale, Hm, km)
        m_ref = s.amax(-1)
        l_ref = torch.exp(s - m_ref[..., None]).sum(-1)
    m_err = float(((M - m_ref).abs() / m_ref.abs().clamp(min=1.0)).max())
    l_err = float(((L - l_ref).abs() / l_ref).max())
    if not (m_err <= tol and l_err <= tol):
        raise RuntimeError(f"{name}: the forward's M / L off by {m_err} / "
                           f"{l_err} (tol {tol})")
    return m_err, l_err


def check_conformer_kernels():
    """Rel-pos attention forward and backward (rows 8/9) and conv-module
    forward and backward (rows 10/11) against their plain versions
    (gradients: autograd) at the conformer-small training shapes and at
    partial-tile shapes, float32 and bfloat16, rel-pos at dropout 0.1 and
    0 with the forward's M and L; the FFN backward at the conformer's
    residual scale 0.5. Returns one record list per entry point, the
    path's bf16 call first."""
    import torch
    from speechain_tpu_torch.ops import cuda_attention as ca
    from speechain_tpu_torch.ops import cuda_convmod as cm
    gen = torch.Generator(device="cpu").manual_seed(5)

    def rnd(*shape, scale=1.0, dtype=torch.float32, grad=False):
        return (torch.randn(*shape, generator=gen) * scale).to(
            device=DEV, dtype=dtype).requires_grad_(grad)

    records = {"relpos_attention": [], "relpos_attention_backward": [],
               "convmod_backward": [], "ffn_backward": [], "ffn": []}
    T_enc = 199
    shapes = (("path", B, T_enc, True), ("partial T=77", 3, 77, False),
              ("long T=600", 2, 600, False))

    # ---- rel-pos attention backward (row 9) ----------------------------
    for dtype in (torch.bfloat16, torch.float32):
        s = dtype.itemsize
        dt = "float32" if dtype == torch.float32 else "bfloat16"
        tol = 1e-4 if dtype == torch.float32 else 2 ** -6
        for rate in (0.1, 0.0):
            for label, Bq, T, timed in shapes:
                q, k, v = (rnd(Bq, T, D, dtype=dtype, grad=True)
                           for _ in range(3))
                ph = rnd(2 * T - 1, D, dtype=dtype, grad=True)
                bu = rnd(D, scale=0.3, grad=True)
                bv = rnd(D, scale=0.3, grad=True)
                g = rnd(Bq, T, D, dtype=dtype)
                lens = torch.randint(T // 2, T + 1, (Bq,), generator=gen)
                lens[0] = T
                if not timed:
                    lens[-1] = 0                 # an empty key row
                km = (torch.arange(T)[None] < lens[:, None]).to(DEV)
                ins = (q, k, v, ph, bu, bv)
                args = (*ins, D ** -0.5, H, km, rate, 77)
                out_k = ca.cuda_relpos_attention(*args)
                out_p = ca.relpos_attention_plain(*args)
                gk = torch.autograd.grad(out_k, ins, g, retain_graph=True)
                gp = torch.autograd.grad(out_p, ins, g, retain_graph=True)
                call = f"relpos {label} drop={rate}"
                shape = f"q/k/v ({Bq}, {T}, {D}) H={H}"
                ferr = compare_all("relpos fwd " + call, [out_k], [out_p],
                                   tol)
                berr = compare_all("relpos bwd " + call, gk, gp, tol)
                m_err, l_err = check_relpos_stats(
                    "relpos fwd " + call,
                    (*(t.detach() for t in ins), *args[6:]))
                fwd = dict(call=call, dtype=dt, rate=rate, shape=shape,
                           max_abs_err=ferr, tol_rel=tol, m_err=m_err,
                           l_err=l_err)
                bwd = dict(fwd, max_abs_err=berr)
                with torch.no_grad():
                    fa = tuple(t.detach() for t in ins)
                    km32 = km.to(torch.int32)
                    check_repeats(f"relpos fwd {call} {dt}",
                                  lambda: ca._launch_forward(
                                      *fa, km32, D ** -0.5, H, rate, 77))
                    _, M, L = ca._launch_forward(
                        *fa, km32, D ** -0.5, H, rate, 77)

                    def kernel_bwd():
                        return ca.relpos_attention_backward(
                            *fa, km32, g, M, L, D ** -0.5, H, rate, 77)
                    check_repeats(f"relpos bwd {call} {dt}", kernel_bwd)
                if not timed:
                    log(f"  {call:<38} {dt:<8} err fwd {ferr:.3e} bwd "
                        f"{berr:.3e} M {m_err:.1e} L {l_err:.1e} ok")
                    records["relpos_attention_backward"].append(bwd)
                    continue
                with torch.no_grad():
                    fwd["ms"] = cuda_time(
                        lambda: ca.cuda_relpos_attention(*args))
                    fwd["device_ms"] = graph_time(
                        lambda: ca.cuda_relpos_attention(*args))
                    fwd["plain_ms"] = cuda_time(
                        lambda: ca.relpos_attention_plain(*args), reps=5,
                        warmup=1)
                    bwd["ms"] = cuda_time(kernel_bwd)
                    bwd["device_ms"] = graph_time(kernel_bwd)
                bwd["plain_ms"] = grad_time(out_p, ins, g, reps=5, warmup=1)
                fwd["library_ms"] = bwd["library_ms"] = None
                fwd["bound_ms"], fwd["bound_by"] = bound(
                    *relpos_cost(Bq, T, s), dt)
                bwd["bound_ms"], bwd["bound_by"] = bound(
                    *relpos_cost(Bq, T, s, backward=True), dt)
                for nm, r in (("relpos fwd", fwd), ("relpos bwd", bwd)):
                    dev = (f" (device {r['device_ms']:.4f})"
                           if "device_ms" in r else "")
                    log(f"  {nm + ' ' + call:<38} {dt:<8} err "
                        f"{r['max_abs_err']:.3e}  kernel {r['ms']:.4f} ms"
                        f"{dev}  plain {r['plain_ms']:.4f} ms  bound "
                        f"{r['bound_ms']:.4f} ms ({r['bound_by']})"
                        f"  M {m_err:.1e} L {l_err:.1e}")
                records["relpos_attention"].append(fwd)
                records["relpos_attention_backward"].append(bwd)

    # ---- conv-module backward (row 11) ---------------------------------
    C = D
    for dtype in (torch.bfloat16, torch.float32):
        s = dtype.itemsize
        dt = "float32" if dtype == torch.float32 else "bfloat16"
        tol = 1e-4 if dtype == torch.float32 else 2 ** -6
        for label, Bq, T, timed in shapes:
            x = rnd(Bq, T, C, dtype=dtype, grad=True)
            w1 = rnd(2 * C, C, scale=C ** -0.5, grad=True)
            b1 = rnd(2 * C, scale=0.1, grad=True)
            dwk = rnd(C, 1, K_DW, scale=K_DW ** -0.5, grad=True)
            dwb = rnd(C, scale=0.1, grad=True)
            gu = rnd(Bq, T, C, dtype=dtype)
            gs, gss = rnd(C, scale=0.01), rnd(C, scale=0.01)
            ins = (x, w1, b1, dwk, dwb)
            out_k = cm.cuda_conv_glu_dw(*ins)
            out_p = cm.conv_glu_dw_plain(*ins)
            gk = torch.autograd.grad(out_k, ins, (gu, gs, gss),
                                     retain_graph=True)
            gp = torch.autograd.grad(out_p, ins, (gu, gs, gss),
                                     retain_graph=True)
            call = f"convmod {label}"
            ferr = compare_all("convmod fwd " + call, out_k[:1], out_p[:1],
                               tol)
            check_convmod_stats("convmod fwd " + call, out_k, out_p, dtype)
            err = compare_all("convmod bwd " + call, gk, gp, tol)
            rec = dict(call=call, dtype=dt, shape=f"x ({Bq}, {T}, {C}) "
                       f"K={K_DW}", max_abs_err=err, tol_rel=tol,
                       fwd_max_abs_err=ferr)
            with torch.no_grad():
                x_ = x.detach()
                w1c, b1c = w1.detach().to(dtype), b1.detach().to(dtype)
                dwkf = dwk.detach().reshape(C, K_DW)
                dwbc = dwb.detach().to(dtype)
                check_repeats(f"convmod fwd {call} {dt}",
                              lambda: cm._launch_forward(x_, w1c, b1c, dwkf,
                                                         dwbc))
                u, _, _ = cm._launch_forward(x_, w1c, b1c, dwkf, dwbc)

                def kernel_bwd():
                    return cm.convmod_backward(x_, w1c, b1c, dwkf, u, gu, gs,
                                               gss)
                check_repeats(f"convmod bwd {call} {dt}", kernel_bwd)
            if timed:
                with torch.no_grad():
                    rec["ms"] = cuda_time(kernel_bwd)
                    rec["device_ms"] = graph_time(kernel_bwd)
                rec["plain_ms"] = grad_time(out_p, ins, (gu, gs, gss),
                                            reps=5, warmup=1)
                rec["library_ms"] = None
                rec["bound_ms"], rec["bound_by"] = bound(
                    *convmod_cost(Bq, T, s, backward=True), dt)
                log(f"  convmod bwd {call:<26} {dt:<8} err {err:.3e}  "
                    f"kernel {rec['ms']:.4f} ms (device "
                    f"{rec['device_ms']:.4f})  plain "
                    f"{rec['plain_ms']:.4f} ms  bound {rec['bound_ms']:.4f} "
                    f"ms ({rec['bound_by']})  fwd err {ferr:.3e}")
            else:
                log(f"  convmod {call:<30} {dt:<8} err fwd {ferr:.3e} bwd "
                    f"{err:.3e} ok")
            records["convmod_backward"].append(rec)

    # ---- FFN at the conformer's shapes (rows 4/5): the encoder's macaron
    # halves (alpha 0.5) and the decoder's layers
    for label, N, alpha in (("conformer encoder", B * T_enc, 0.5),
                            ("conformer decoder", B * 31, 1.0)):
        for rate in (0.1, 0.0):
            records["ffn_backward"].append(ffn_case(
                label, N, D, F_DIM, "GELU", alpha, True, rate,
                torch.bfloat16, True, 41))
    records["ffn"] = [ffn_case("conformer decoder", B * 31, D, F_DIM, "GELU",
                               1.0, True, rate, torch.bfloat16, False, 42)
                      for rate in (0.1, 0.0)]
    return records


def relpos_composed(q, k, v, ph, bu, bv, scale, Hm, km, rate):
    """Row 9's yardstick, never called by the port: rel-pos attention
    composed of bf16 cuBLAS products (content scores qu k^T, position
    scores qv ph^T), ``cuda_attention.rel_shift``, a float32 softmax,
    ``F.dropout`` (PyTorch's bits, not the kernel's) and p v."""
    import torch
    import torch.nn.functional as F
    from speechain_tpu_torch.ops import cuda_attention as ca
    Bq, T, Dm = q.shape
    dh = Dm // Hm

    def split(x):
        return x.reshape(Bq, T, Hm, dh).transpose(1, 2)
    qf = q.float()
    qu = ((qf + bu) * scale).to(q.dtype)
    qv = ((qf + bv) * scale).to(q.dtype)
    ac = split(qu) @ split(k).transpose(-1, -2)
    bd = ca.rel_shift(split(qv) @ ph.reshape(2 * T - 1, Hm, dh).permute(
        1, 2, 0)[None])
    sc = (ac + bd).float().masked_fill(~km[:, None, None, :], ca.NEG_FILL)
    p = F.dropout(torch.softmax(sc, -1), rate, training=True).to(q.dtype)
    return (p @ split(v)).transpose(1, 2).reshape(Bq, T, Dm)


def convmod_composed(x, w1, b1, dwk, dwb):
    """Row 11's yardstick, never called by the port: the conv-module
    front half composed of ``F.linear`` (cuBLAS), ``F.glu``, a depthwise
    ``F.conv1d(groups=C)`` (cuDNN), all in x's dtype, and the float32
    moment sums."""
    import torch.nn.functional as F
    C, K = x.shape[-1], dwk.shape[-1]
    P = (K - 1) // 2
    cd = x.dtype
    a = F.glu(F.linear(x, w1.to(cd), b1.to(cd)), -1)
    u = F.conv1d(F.pad(a.transpose(1, 2), (P, K - 1 - P)),
                 dwk.reshape(C, 1, K).to(cd), dwb.to(cd),
                 groups=C).transpose(1, 2)
    uf = u.float()
    return u, uf.sum((0, 1)), (uf * uf).sum((0, 1))


def check_conformer_tc(records):
    """The bf16 tensor-core kernels of rows 8-11 at the path shape (bf16,
    B 16, T 199, D 256, 4 heads; rel-pos at dropout 0.1): each backward's
    device time by kernel (profiler), and each row's composition yardstick
    (forward: per call and on the device, from the profiler; backward: its
    autograd, the same), written into the path records
    (``records[...][0]``) as the FFN rows' are."""
    import torch
    from speechain_tpu_torch.ops import cuda_attention as ca
    from speechain_tpu_torch.ops import cuda_convmod as cm
    gen = torch.Generator(device="cpu").manual_seed(9)

    def rnd(*shape, scale=1.0, dtype=torch.float32, grad=False):
        return (torch.randn(*shape, generator=gen) * scale).to(
            device=DEV, dtype=dtype).requires_grad_(grad)

    bf, T, rate = torch.bfloat16, 199, 0.1
    out = {}
    q, k, v = (rnd(B, T, D, dtype=bf, grad=True) for _ in range(3))
    ph = rnd(2 * T - 1, D, dtype=bf, grad=True)
    bu, bv = rnd(D, scale=0.3, grad=True), rnd(D, scale=0.3, grad=True)
    g = rnd(B, T, D, dtype=bf)
    lens = torch.randint(T // 2, T + 1, (B,), generator=gen)
    lens[0] = T
    km = (torch.arange(T)[None] < lens[:, None]).to(DEV)
    ins = (q, k, v, ph, bu, bv)
    args = (*ins, D ** -0.5, H, km, rate, 77)
    with torch.no_grad():
        fa = tuple(t.detach() for t in ins)
        km32 = km.to(torch.int32)
        _, M, L = ca._launch_forward(*fa, km32, D ** -0.5, H, rate, 77)
        split = {}
        profiled_time(lambda: ca.relpos_attention_backward(
            *fa, km32, g, M, L, D ** -0.5, H, rate, 77), by_kernel=split)
        log("  relpos bwd device ms by kernel: " + ", ".join(
            f"{k} {v:.4f}" for k, v in sorted(split.items(),
                                               key=lambda kv: -kv[1])))
        out["relpos_by_kernel"] = split

    with torch.no_grad():
        def comp_fwd():
            return relpos_composed(*fa, D ** -0.5, H, km, rate)
        comp = dict(ms=cuda_time(comp_fwd), device_ms=profiled_time(comp_fwd))
    log(f"  relpos fwd composition (bf16 cuBLAS): {comp['ms']:.4f} ms a "
        f"call, device {comp['device_ms']:.4f} ms")
    out["relpos_fwd_composition"] = comp
    if records.get("relpos_attention"):
        rec = records["relpos_attention"][0]
        rec["library_composition_ms"] = comp["ms"]
        rec["library_composition_device_ms"] = comp["device_ms"]
    comp_out = relpos_composed(*args[:6], D ** -0.5, H, km, rate)

    def comp_bwd():
        return torch.autograd.grad(comp_out, ins, g, retain_graph=True)
    comp = dict(ms=cuda_time(comp_bwd), device_ms=profiled_time(comp_bwd))
    log(f"  relpos bwd composition (bf16 cuBLAS, autograd): "
        f"{comp['ms']:.4f} ms a call, device {comp['device_ms']:.4f} ms")
    out["relpos_composition"] = comp
    rec = records["relpos_attention_backward"][0]
    rec["library_composition_ms"] = comp["ms"]
    rec["library_composition_device_ms"] = comp["device_ms"]
    del comp_out

    C = D
    x = rnd(B, T, C, dtype=bf, grad=True)
    w1 = rnd(2 * C, C, scale=C ** -0.5, grad=True)
    b1 = rnd(2 * C, scale=0.1, grad=True)
    dwk = rnd(C, 1, K_DW, scale=K_DW ** -0.5, grad=True)
    dwb = rnd(C, scale=0.1, grad=True)
    cot = (rnd(B, T, C, dtype=bf), rnd(C, scale=0.01), rnd(C, scale=0.01))
    cins = (x, w1, b1, dwk, dwb)
    with torch.no_grad():
        def comp_cfwd():
            return convmod_composed(*(t.detach() for t in cins))
        comp = dict(ms=cuda_time(comp_cfwd),
                    device_ms=profiled_time(comp_cfwd))
        split = {}
        profiled_time(lambda: cm.cuda_conv_glu_dw(*(t.detach() for t in cins)),
                      by_kernel=split)
    log(f"  convmod fwd composition (bf16 cuBLAS + cuDNN): {comp['ms']:.4f} "
        f"ms a call, device {comp['device_ms']:.4f} ms; the kernels' device "
        "ms by kernel: " + ", ".join(
            f"{k} {v:.4f}" for k, v in sorted(split.items(),
                                               key=lambda kv: -kv[1])))
    out["convmod_fwd_composition"] = comp
    out["convmod_fwd_by_kernel"] = split
    if records.get("convmod"):
        rec = records["convmod"][0]
        rec["library_composition_ms"] = comp["ms"]
        rec["library_composition_device_ms"] = comp["device_ms"]
    comp_out = convmod_composed(*cins)

    def comp_cbwd():
        return torch.autograd.grad(comp_out, cins, cot, retain_graph=True)
    comp = dict(ms=cuda_time(comp_cbwd), device_ms=profiled_time(comp_cbwd))
    log(f"  convmod bwd composition (bf16 cuBLAS + cuDNN, autograd): "
        f"{comp['ms']:.4f} ms a call, device {comp['device_ms']:.4f} ms")
    out["convmod_composition"] = comp
    rec = records["convmod_backward"][0]
    rec["library_composition_ms"] = comp["ms"]
    rec["library_composition_device_ms"] = comp["device_ms"]
    out["convmod_grids"] = cm.bwd_tc_grids(B, T, C, K_DW)
    with torch.no_grad():
        w1c, b1c = w1.detach().to(bf), b1.detach().to(bf)
        dwkf = dwk.detach().reshape(C, K_DW)
        u, _, _ = cm._launch_forward(x.detach(), w1c, b1c, dwkf,
                                     dwb.detach().to(bf))
        split = {}
        profiled_time(lambda: cm.convmod_backward(x.detach(), w1c, b1c, dwkf,
                                                  u, *cot), by_kernel=split)
    log("  convmod bwd device ms by kernel: " + ", ".join(
        f"{k} {v:.4f}" for k, v in sorted(split.items(),
                                           key=lambda kv: -kv[1])))
    out["convmod_by_kernel"] = split
    return out


# -------------------------------------------------------------- phase 2e

def ptxas_table(build_log: str,
                names=("flash_", "relpos_", "ffn_", "convmod_")):
    """(kernel, template arguments, registers, spill stores, spill loads)
    of every kernel in an nvcc -Xptxas -v log whose name starts with one
    of ``names``, from the mangled names (_ZN, the anonymous namespace
    and the kernel as length-prefixed names, then the template
    arguments: float ``f``, bf16 ``13__nv_bfloat16``, ints ``Li<n>E``,
    bools ``Lb<0|1>E``)."""
    import re
    rows, cur, spill = [], None, (0, 0)
    for line in build_log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\w+)", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            n = re.match(r"_ZN(\d+)", cur)   # the namespace, then the
            if n:                            # kernel: length-prefixed names
                at = n.end() + int(n.group(1))
                k = re.match(r"\d+", cur[at:])
                name = cur[at + k.end():at + k.end() + int(k.group(0))]
                rest = cur[at + k.end() + int(k.group(0)):]
                targs, pos = [], 1         # the I...E list after the name
                while rest.startswith("I") and pos < len(rest):
                    t = re.match(r"f|13__nv_bfloat16|L[ib](\d+)E",
                                 rest[pos:])
                    if t is None:
                        break
                    targs.append(int(t.group(1)) if t.group(1) else
                                 "f32" if t.group(0) == "f" else "bf16")
                    pos += t.end()
                if name.startswith(names):
                    rows.append((name, targs, int(m.group(1)), *spill))
            cur, spill = None, (0, 0)
    return rows


# synthesis shapes (bench.py _tts_bench: d 384, 4 heads, 640 frames, 100
# tokens, batch 16; the FastSpeech2 recipes' 2 heads of 192) and
# transformer-large's 4 heads of 128 (recipes/asr/librispeech/train-960/
# exp_cfg/bpe5k_transformer-large.yaml)
TTS_D, TTS_H, TTS_F, TTS_V = 384, 4, 1536, 100
TTS_B, TTS_TOKENS, TTS_FRAMES = 16, 100, 640
# Transformer-TTS, the LJSpeech recipe (recipes/tts/ljspeech/exp_cfg/
# transformer_tts.yaml): the encoder d 512 with 8 heads, the decoder at the
# prenet's width 256 (8 heads of 32), F 2048, 6 + 6 layers, r 2, 16 kHz;
# trained on 8 utterances of 120,000 samples (7.5 s: 601 frames, 300
# decoder positions) with 100 tokens, synthesized for 16 x 100 tokens
ARTTS_D, ARTTS_W, ARTTS_H, ARTTS_F, ARTTS_V = 512, 256, 8, 2048, 80
ARTTS_B, ARTTS_TOKENS, ARTTS_SAMPLES, ARTTS_DEC_T = 8, 100, 120_000, 300
ARTTS_SYNTH_B = 16
WIDTH_CASES = (
    ("tts decoder self (16, 640, 384) H=4", TTS_B, TTS_FRAMES, TTS_D, 4),
    ("tts decoder self (16, 640, 384) H=2", TTS_B, TTS_FRAMES, TTS_D, 2),
    ("tts encoder self (16, 100, 384) H=4", TTS_B, TTS_TOKENS, TTS_D, 4),
    ("transformer-large self (16, 199, 512) H=4", B, 199, 512, 4))
FLASH_WIDTHS_CHECKED = (32, 96, 128, 192, 256, 80)
RELPOS_WIDTHS_CHECKED = (32, 96, 128)


def check_head_widths(build_logs):
    """Flash attention forward and backward at head widths 32, 96, 128,
    192, 256 and the padded 80 (run by the 96 instance), rel-pos at 32, 96
    and 128, against their plain versions (gradients: autograd of the
    plain version), float32 and bfloat16, dropout 0 and 0.1, causal and
    key-masked with a partial tile and an empty key row; then the
    synthesis shapes and transformer-large's timed in bf16 (per call, on
    the device, SDPA beside them); and every instance's registers and
    spills from the build log. Returns one record list per entry point."""
    import torch
    import torch.nn.functional as F
    from speechain_tpu_torch.ops import cuda_attention as ca
    from speechain_tpu_torch.ops import cuda_flash_attention as cfa
    gen = torch.Generator(device="cpu").manual_seed(7)

    def rnd(*shape, scale=1.0, dtype=torch.float32, grad=False):
        return (torch.randn(*shape, generator=gen) * scale).to(
            device=DEV, dtype=dtype).requires_grad_(grad)

    def key_mask(Bq, Tk, empty):
        lens = torch.randint(Tk // 2, Tk + 1, (Bq,), generator=gen)
        lens[0] = Tk
        if empty:
            lens[-1] = 0
        return (torch.arange(Tk)[None] < lens[:, None]).to(DEV)

    records = {"flash_attention": [], "flash_attention_backward": [],
               "relpos_attention": [], "relpos_attention_backward": [],
               "convmod": [], "convmod_backward": []}
    ptx = []
    for log_text in build_logs:
        ptx += ptxas_table(log_text)
    for name, targs, regs, st, ld in ptx:
        log(f"  ptxas {name}<{', '.join(map(str, targs))}>: {regs} "
            f"registers, spill stores {st} B, loads {ld} B")
    smem = {}
    for dh in FLASH_WIDTHS_CHECKED:
        for dtype in (torch.bfloat16, torch.float32):
            for Tk in (1, 77, 640, 2000):
                want = ca.flash_smem_bytes(Tk, dtype, dh)
                got = cfa.built_smem_bytes(Tk, dtype, dh)
                if got != want:
                    raise RuntimeError(f"flash attention dh={dh} {dtype} "
                                       f"Tk={Tk}: the kernels take {got} "
                                       f"bytes, the reckoning says {want}")
        smem[dh] = ca.flash_smem_bytes(TTS_FRAMES, torch.bfloat16, dh)
    log("  flash attention shared memory as reckoned at every width: "
        + ", ".join(f"{dh}: {v}" for dh, v in smem.items()))
    for dh in (*RELPOS_WIDTHS_CHECKED, 64, 40):
        for dtype in (torch.bfloat16, torch.float32):
            want = ca.relpos_kernel_smem(dtype, dh)
            got = ca.built_relpos_smem(dtype, dh)
            if got != want:
                raise RuntimeError(f"relpos dh={dh} {dtype}: the kernels "
                                   f"take {got} bytes, the reckoning says "
                                   f"{want}")
    log("  relpos shared memory as reckoned (bf16): "
        + ", ".join(f"{dh}: {ca.relpos_kernel_smem(torch.bfloat16, dh)}"
                    for dh in (32, 64, 96, 128)))
    check_scratch_layouts()

    # ---- correctness at every width, untimed ---------------------------
    for dh in FLASH_WIDTHS_CHECKED:
        Hm = 2
        Dm = Hm * dh
        for dtype in (torch.bfloat16, torch.float32):
            dt = "float32" if dtype == torch.float32 else "bfloat16"
            tol = 1e-4 if dtype == torch.float32 else 2 ** -6
            for rate in (0.1, 0.0):
                for label, Bq, Tq, Tk, causal in (
                        ("causal T=77 empty row", 3, 77, 77, True),
                        ("cross Tq=31 Tk=199", 2, 31, 199, False)):
                    q = rnd(Bq, Tq, Dm, dtype=dtype, grad=True)
                    k = rnd(Bq, Tk, Dm, dtype=dtype, grad=True)
                    v = rnd(Bq, Tk, Dm, dtype=dtype, grad=True)
                    g = rnd(Bq, Tq, Dm, dtype=dtype)
                    km = key_mask(Bq, Tk, causal)
                    args = (q, k, v, Dm ** -0.5, Hm, causal, rate, 31, km)
                    out_k = cfa.flash_attention(*args)
                    out_p = cfa.flash_attention_plain(*args)
                    gk = torch.autograd.grad(out_k, (q, k, v), g)
                    gp = torch.autograd.grad(out_p, (q, k, v), g)
                    call = f"dh={dh} {label} drop={rate}"
                    with torch.no_grad():
                        # the entry points at the built width (80 runs on
                        # the 96 instance, heads zero-padded)
                        wid = ca.head_instance("flash", dh,
                                               ca.FLASH_HEAD_WIDTHS)
                        qp, kp, vp, gpd = (cfa.pad_heads(t.detach(), Hm, wid)
                                           for t in (q, k, v, g))
                        fa = (qp, kp, vp, km.to(torch.int32), Dm ** -0.5,
                              Hm, causal, rate, 31)
                        check_repeats(f"flash fwd {call} {dt}",
                                      lambda: cfa._launch_forward(*fa))
                        _, M, L = cfa._launch_forward(*fa)
                        check_repeats(
                            f"flash bwd {call} {dt}",
                            lambda: cfa.flash_attention_backward(
                                *fa[:4], gpd, M, L, *fa[4:]))
                    ferr = compare_all("flash fwd " + call, [out_k],
                                       [out_p], tol)
                    berr = compare_all("flash bwd " + call, gk, gp, tol)
                    shape = f"q ({Bq}, {Tq}, {Dm}) k ({Bq}, {Tk}) H={Hm}"
                    fwd = dict(call=call, dtype=dt, rate=rate, shape=shape,
                               max_abs_err=ferr, tol_rel=tol)
                    records["flash_attention"].append(fwd)
                    records["flash_attention_backward"].append(
                        dict(fwd, max_abs_err=berr))
                    log(f"  flash {call:<40} {dt:<8} err fwd {ferr:.3e} "
                        f"bwd {berr:.3e} ok")
    for dh in RELPOS_WIDTHS_CHECKED:
        Hm = 2
        Dm = Hm * dh
        for dtype in (torch.bfloat16, torch.float32):
            dt = "float32" if dtype == torch.float32 else "bfloat16"
            tol = 1e-4 if dtype == torch.float32 else 2 ** -6
            for rate in (0.1, 0.0):
                Bq, T = 3, 77
                q, k, v = (rnd(Bq, T, Dm, dtype=dtype, grad=True)
                           for _ in range(3))
                ph = rnd(2 * T - 1, Dm, dtype=dtype, grad=True)
                bu = rnd(Dm, scale=0.3, grad=True)
                bv = rnd(Dm, scale=0.3, grad=True)
                g = rnd(Bq, T, Dm, dtype=dtype)
                ins = (q, k, v, ph, bu, bv)
                args = (*ins, Dm ** -0.5, Hm, key_mask(Bq, T, True), rate,
                        41)
                out_k = ca.cuda_relpos_attention(*args)
                out_p = ca.relpos_attention_plain(*args)
                gk = torch.autograd.grad(out_k, ins, g)
                gp = torch.autograd.grad(out_p, ins, g)
                call = f"dh={dh} T=77 empty row drop={rate}"
                with torch.no_grad():
                    fa = (*(t.detach() for t in ins),
                          args[8].to(torch.int32), Dm ** -0.5, Hm, rate, 41)
                    check_repeats(f"relpos fwd {call} {dt}",
                                  lambda: ca._launch_forward(*fa))
                    _, M, L = ca._launch_forward(*fa)
                    check_repeats(
                        f"relpos bwd {call} {dt}",
                        lambda: ca.relpos_attention_backward(
                            *fa[:7], g, M, L, *fa[7:]))
                ferr = compare_all("relpos fwd " + call, [out_k], [out_p],
                                   tol)
                berr = compare_all("relpos bwd " + call, gk, gp, tol)
                check_relpos_stats("relpos fwd " + call,
                                   (*(t.detach() for t in ins), *args[6:]))
                fwd = dict(call=call, dtype=dt, rate=rate,
                           shape=f"q/k/v ({Bq}, {T}, {Dm}) H={Hm}",
                           max_abs_err=ferr, tol_rel=tol)
                records["relpos_attention"].append(fwd)
                records["relpos_attention_backward"].append(
                    dict(fwd, max_abs_err=berr))
                log(f"  relpos {call:<39} {dt:<8} err fwd {ferr:.3e} bwd "
                    f"{berr:.3e} ok")

    # ---- the synthesis and transformer-large shapes, timed (bf16) ------
    dt, s, tol = "bfloat16", 2, 2 ** -6
    for label, Bq, T, Dm, Hm in WIDTH_CASES:
        q, k, v = (rnd(Bq, T, Dm, dtype=torch.bfloat16, grad=True)
                   for _ in range(3))
        g = rnd(Bq, T, Dm, dtype=torch.bfloat16)
        km = key_mask(Bq, T, False)
        sc = Dm ** -0.5
        args = (q, k, v, sc, Hm, False, 0.0, 0, km)
        out_k = cfa.flash_attention(*args)
        out_p = cfa.flash_attention_plain(*args)
        gk = torch.autograd.grad(out_k, (q, k, v), g, retain_graph=True)
        gp = torch.autograd.grad(out_p, (q, k, v), g, retain_graph=True)
        ferr = compare_all("flash fwd " + label, [out_k], [out_p], tol)
        berr = compare_all("flash bwd " + label, gk, gp, tol)
        shape = f"q ({Bq}, {T}, {Dm}) H={Hm} Dh={Dm // Hm}"
        fwd = dict(call=label + " drop=0.0", dtype=dt, rate=0.0,
                   shape=shape, max_abs_err=ferr, tol_rel=tol)
        bwd = dict(fwd, max_abs_err=berr)
        qh, kh, vh = (t.detach().reshape(Bq, T, Hm, -1).transpose(1, 2)
                      .contiguous().requires_grad_() for t in (q, k, v))
        am = km[:, None, None, :]

        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=am,
                                                  scale=sc)
        with torch.no_grad():
            fwd["ms"] = cuda_time(lambda: cfa.flash_attention(*args))
            fwd["device_ms"] = graph_time(lambda: cfa.flash_attention(*args))
            fwd["plain_ms"] = cuda_time(
                lambda: cfa.flash_attention_plain(*args), reps=5, warmup=1)
            fwd["library_ms"] = cuda_time(sdpa)
            fwd["library_device_ms"] = graph_time(sdpa)
            fa = (q.detach(), k.detach(), v.detach(), km.to(torch.int32),
                  sc, Hm, False, 0.0, 0)
            _, M, L = cfa._launch_forward(*fa)

            def kernel_bwd():
                return cfa.flash_attention_backward(*fa[:4], g, M, L,
                                                    *fa[4:])
            bwd["ms"] = cuda_time(kernel_bwd)
            bwd["device_ms"] = graph_time(kernel_bwd)
        lib = sdpa()
        gh = g.reshape(Bq, T, Hm, -1).transpose(1, 2)

        def sdpa_bwd():
            return torch.autograd.grad(lib, (qh, kh, vh), gh,
                                       retain_graph=True)
        bwd["plain_ms"] = grad_time(out_p, (q, k, v), g, reps=5, warmup=1)
        bwd["library_ms"] = cuda_time(sdpa_bwd)
        bwd["library_device_ms"] = profiled_time(sdpa_bwd)
        mbytes = 4 * Bq * T
        fwd["bound_ms"], fwd["bound_by"] = bound(
            s * 4 * Bq * T * Dm + mbytes, 4 * Bq * T * T * Dm, dt)
        bwd["bound_ms"], bwd["bound_by"] = bound(
            s * 7 * Bq * T * Dm + mbytes, 10 * Bq * T * T * Dm, dt)
        for nm, r in (("flash fwd", fwd), ("flash bwd", bwd)):
            log(f"  {nm + ' ' + label:<52} err {r['max_abs_err']:.3e}  "
                f"kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f})  "
                f"plain {r['plain_ms']:.4f} ms  sdpa {r['library_ms']:.4f} "
                f"ms (device {r['library_device_ms']:.4f})  bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
        records["flash_attention"].append(fwd)
        records["flash_attention_backward"].append(bwd)
        del lib, qh, kh, vh, out_k, out_p, gk, gp
    for dh in RELPOS_WIDTHS_CHECKED:
        Bq, T, Hm = B, 199, 4
        Dm = Hm * dh
        q, k, v = (rnd(Bq, T, Dm, dtype=torch.bfloat16) for _ in range(3))
        ph = rnd(2 * T - 1, Dm, dtype=torch.bfloat16)
        bu, bv = rnd(Dm, scale=0.3), rnd(Dm, scale=0.3)
        g = rnd(Bq, T, Dm, dtype=torch.bfloat16)
        km = key_mask(Bq, T, False)
        with torch.no_grad():
            args = (q, k, v, ph, bu, bv, Dm ** -0.5, Hm, km, 0.1, 77)
            ferr = compare_all("relpos fwd timed", [
                ca.cuda_relpos_attention(*args)],
                [ca.relpos_attention_plain(*args)], tol)
            km32 = km.to(torch.int32)
            fwd = dict(call=f"dh={dh} (16, 199, {Dm}) H=4 drop=0.1",
                       dtype=dt, rate=0.1, shape=f"q/k/v ({Bq}, {T}, {Dm}) "
                       f"H={Hm}", max_abs_err=ferr, tol_rel=tol,
                       library_ms=None)
            fwd["ms"] = cuda_time(lambda: ca.cuda_relpos_attention(*args))
            fwd["device_ms"] = graph_time(
                lambda: ca.cuda_relpos_attention(*args))
            fwd["plain_ms"] = cuda_time(
                lambda: ca.relpos_attention_plain(*args), reps=5, warmup=1)
            _, M, L = ca._launch_forward(q, k, v, ph, bu, bv, km32,
                                         Dm ** -0.5, Hm, 0.1, 77)
            bwd = dict(fwd)

            def kernel_bwd():
                return ca.relpos_attention_backward(
                    q, k, v, ph, bu, bv, km32, g, M, L, Dm ** -0.5, Hm, 0.1,
                    77)
            bwd["ms"] = cuda_time(kernel_bwd)
            bwd["device_ms"] = graph_time(kernel_bwd)
        fwd["bound_ms"], fwd["bound_by"] = bound(
            *relpos_cost(Bq, T, s, Dm=Dm, Hm=Hm), dt)
        bwd["bound_ms"], bwd["bound_by"] = bound(
            *relpos_cost(Bq, T, s, True, Dm, Hm), dt)
        bwd["plain_ms"] = None
        for nm, r in (("relpos fwd", fwd), ("relpos bwd", bwd)):
            log(f"  {nm + ' ' + r['call']:<48} kernel {r['ms']:.4f} ms"
                + (f" (device {r['device_ms']:.4f})" if "device_ms" in r
                   else "")
                + (f"  plain {r['plain_ms']:.4f} ms" if r["plain_ms"]
                   else "")
                + f"  bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        records["relpos_attention"].append(fwd)
        records["relpos_attention_backward"].append(bwd)
    records["convmod"], records["convmod_backward"] = \
        check_convmod_widths(rnd)
    return records, [dict(kernel=n, template=t, registers=r, spill_stores=a,
                          spill_loads=b) for n, t, r, a, b in ptx]


# (B, T, D or C, H) at which the built backwards' scratch (and the
# conv-module's grids) must equal the wrappers' reckoning: the conformer
# paths' shapes, a partial tile, one frame, T 600 and conformer-large's
# C 512
LAYOUT_SHAPES = ((B, 199, D, H), (3, 77, D, H), (2, 1, D, H),
                 (B, 600, D, H), (B, 199, 512, 8))


def check_scratch_layouts():
    """The scratch each backward's wrapper allocates (rel-pos
    ``relpos_bwd_scratch``, conv-module ``part_floats``) against what the
    built entry point asks for and refuses less than, in both dtypes at
    ``LAYOUT_SHAPES``; and the conv-module's bf16 kernels' (forward and
    backward) built shared memory and launch grids against
    ``tc_smem_bytes`` / ``fwd_tc_grids`` / ``bwd_tc_grids`` (K 31 and K
    33)."""
    import torch
    from speechain_tpu_torch.ops import cuda_attention as ca
    from speechain_tpu_torch.ops import cuda_convmod as cm
    for Bq, T, Dm, Hm in LAYOUT_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            want = ca.relpos_bwd_scratch(Bq, T, Dm, Hm, dtype)
            got = ca.built_relpos_scratch(Bq, T, Dm, Hm, dtype)
            if got != want:
                raise RuntimeError(f"relpos bwd scratch ({Bq}, {T}, {Dm}) "
                                   f"H={Hm} {dtype}: the kernels ask "
                                   f"{got}, the wrapper allocates {want}")
            for K in (K_DW, cm.MAX_K):
                got = cm.built_layout(Bq, T, Dm, K, dtype)
                want = {"part": cm.part_floats(Bq, T, Dm, K, dtype)}
                if dtype == torch.bfloat16:
                    want["smem"] = cm.tc_smem_bytes()
                    want["grids"] = {**cm.fwd_tc_grids(Bq, T, Dm),
                                     **cm.bwd_tc_grids(Bq, T, Dm, K)}
                if got != want:
                    raise RuntimeError(f"convmod ({Bq}, {T}, {Dm}) "
                                       f"K={K} {dtype}: the kernels have "
                                       f"{got}, the wrapper reckons {want}")
    # a scratch one element short must be refused by the entry point
    # (cudaErrorInvalidValue = 1, before any launch)
    def refused(module, attr, short, call):
        full = getattr(module, attr)
        setattr(module, attr, short(full))
        try:
            call()
        except RuntimeError as e:
            if "cudaError 1" not in str(e):
                raise
            return
        finally:
            setattr(module, attr, full)
        raise RuntimeError(f"{attr} one element short: the entry point "
                           f"did not refuse it")

    Bq, T, Hm = 2, 77, 2
    bias, ML = torch.zeros(D, device=DEV), torch.ones(Bq, Hm, T, device=DEV)
    dwk = torch.zeros(D, K_DW, device=DEV)
    for dtype in (torch.bfloat16, torch.float32):
        z = dict(device=DEV, dtype=dtype)
        x, ph = torch.zeros(Bq, T, D, **z), torch.zeros(2 * T - 1, D, **z)
        w1, b1 = torch.zeros(2 * D, D, **z), torch.zeros(2 * D, **z)
        for key in ("dph_part", "dbu_part", "dbv_part"):
            refused(ca, "relpos_bwd_scratch",
                    lambda f, key=key: lambda *a: {
                        k: v - (k == key) for k, v in f(*a).items()},
                    lambda: ca.relpos_attention_backward(
                        x, x, x, ph, bias, bias, None, x, ML, ML, 0.1, Hm,
                        0.0, 0))
        refused(cm, "part_floats", lambda f: lambda *a: f(*a) - 1,
                lambda: cm.convmod_backward(x, w1, b1, dwk, x, x, bias,
                                            bias))
    log("  backward scratch, conv-module shared memory and grids (forward "
        f"and backward) as reckoned at {len(LAYOUT_SHAPES)} shapes; a "
        "scratch one element "
        f"short refused (both backwards, both dtypes); conv-module bf16 "
        f"shared memory {cm.tc_smem_bytes()}")


def check_convmod_widths(rnd):
    """The conv module at C 512 (conformer-large's width, the same
    instances as C 256): forward (u, s, ss) and backward (autograd of the
    plain version) at (3, 77, 512) and (16, 199, 512) in float32 and
    bfloat16; in bf16 at (16, 199, 512) both timed per call and on the
    device. Returns the (forward, backward) records."""
    import torch
    from speechain_tpu_torch.ops import cuda_convmod as cm
    C, fwd_out, out = 512, [], []
    for dtype in (torch.bfloat16, torch.float32):
        dt = "float32" if dtype == torch.float32 else "bfloat16"
        tol = 1e-4 if dtype == torch.float32 else 2 ** -6
        for label, Bq, T, timed in (("C=512 T=77", 3, 77, False),
                                    ("C=512 path T", B, 199,
                                     dtype == torch.bfloat16)):
            x = rnd(Bq, T, C, dtype=dtype, grad=True)
            w1 = rnd(2 * C, C, scale=C ** -0.5, grad=True)
            b1 = rnd(2 * C, scale=0.1, grad=True)
            dwk = rnd(C, 1, K_DW, scale=K_DW ** -0.5, grad=True)
            dwb = rnd(C, scale=0.1, grad=True)
            cot = (rnd(Bq, T, C, dtype=dtype), rnd(C, scale=0.01),
                   rnd(C, scale=0.01))
            ins = (x, w1, b1, dwk, dwb)
            out_k, out_p = cm.cuda_conv_glu_dw(*ins), cm.conv_glu_dw_plain(*ins)
            ferr = compare_all("convmod fwd " + label, out_k[:1], out_p[:1],
                               tol)
            check_convmod_stats("convmod fwd " + label, out_k, out_p, dtype)
            gk = torch.autograd.grad(out_k, ins, cot)
            gp = torch.autograd.grad(out_p, ins, cot)
            err = compare_all("convmod bwd " + label, gk, gp, tol)
            with torch.no_grad():
                fa = (x.detach(), w1.detach().to(dtype), b1.detach().to(dtype),
                      dwk.detach().reshape(C, K_DW), dwb.detach().to(dtype))
                check_repeats(f"convmod fwd {label} {dt}",
                              lambda: cm._launch_forward(*fa))
                u_ = cm._launch_forward(*fa)[0]
                check_repeats(f"convmod bwd {label} {dt}",
                              lambda: cm.convmod_backward(*fa[:4], u_, *cot))
            rec = dict(call=f"convmod {label}", dtype=dt,
                       shape=f"x ({Bq}, {T}, {C}) K={K_DW}",
                       max_abs_err=err, tol_rel=tol)
            frec = dict(rec, max_abs_err=ferr)
            if timed:
                with torch.no_grad():
                    x_ = x.detach()
                    w1c, b1c = w1.detach().to(dtype), b1.detach().to(dtype)
                    dwkf = dwk.detach().reshape(C, K_DW)
                    dwbc = dwb.detach().to(dtype)

                    def kernel_fwd():
                        return cm._launch_forward(x_, w1c, b1c, dwkf, dwbc)
                    u, _, _ = kernel_fwd()

                    def kernel_bwd():
                        return cm.convmod_backward(x_, w1c, b1c, dwkf, u,
                                                   *cot)
                    for r, fn in ((frec, kernel_fwd), (rec, kernel_bwd)):
                        r["ms"] = cuda_time(fn)
                        r["device_ms"] = graph_time(fn)
                frec["bound_ms"], frec["bound_by"] = bound(
                    *convmod_cost(Bq, T, dtype.itemsize, False, C), dt)
                rec["bound_ms"], rec["bound_by"] = bound(
                    *convmod_cost(Bq, T, dtype.itemsize, True, C), dt)
                for nm, r in (("fwd", frec), ("bwd", rec)):
                    log(f"  convmod {nm} {label:<20} {dt:<8} err "
                        f"{r['max_abs_err']:.3e}  kernel {r['ms']:.4f} ms "
                        f"(device {r['device_ms']:.4f})  bound "
                        f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
            else:
                log(f"  convmod {label:<24} {dt:<8} err fwd {ferr:.3e} bwd "
                    f"{err:.3e} ok")
            fwd_out.append(frec)
            out.append(rec)
    return fwd_out, out


# -------------------------------------------------------------- phase 2d

def layer_norm_cost(N: int, Dn: int, s: int, backward: bool = False):
    """(bytes, operations) of one LayerNorm call at dtype size s: x (and g)
    read, y (or dx) written, the float32 mu / rstd (written forward, read
    backward), scale and bias (and dscale, dbias written backward)."""
    if backward:
        return s * 3 * N * Dn + 8 * N + 12 * Dn, 14 * N * Dn
    return s * 2 * N * Dn + 8 * N + 8 * Dn, 8 * N * Dn


def prenet_cost(Bq: int, T: int, Fm: int, C: int, s: int,
                backward: bool = False):
    """(bytes, operations) of one prenet-core call at dtype size s: the
    mel, w1, g1, b1, w2 and the output (or du) once each, and the float32
    dw2, A, sums written backward; conv2's 9 C^2 multiply-adds per output
    position (twice more backward: dh and dw2), conv1's 9 C per conv1
    position with the affine and activation (backward: z again, A, dy and
    the sums)."""
    U1, F1 = (T - 3) // 2 + 1, (Fm - 3) // 2 + 1
    T2, F2 = (U1 - 3) // 2 + 1, (F1 - 3) // 2 + 1
    P, N1 = Bq * T2 * F2, Bq * U1 * F1
    nbytes = s * (Bq * T * Fm + 9 * C + 9 * C * C + P * C) + 8 * C
    if backward:
        return (nbytes + 4 * (9 * C * C + 11 * C),
                4 * P * 9 * C * C + 4 * N1 * 9 * C + 6 * N1 * C)
    return nbytes, 2 * P * 9 * C * C + 2 * N1 * 9 * C + 3 * N1 * C


# the timed LayerNorm shapes (label, N, D): the conformer encoder's rows
# (16 x 199), the training decoder's (16 x 31), the decode step's (16 x
# beam 16) and transformer-wide's width
LN_TIMED = (("encoder", B * 199, D), ("decoder", B * 31, D),
            ("decode step", B * BEAM, D), ("transformer-wide", B * 199, TW_D))


def ln_candidates(N, Dn, sms):
    """The LayerNorm launches the sweep times at (N, Dn) in bf16: the
    forward at 1, 2, 4 and 8 warps a block, and the backward (P, W, R)
    with P about 1/4, 1/2, 1, 2 or 4 blocks an SM, W 1-8 warps (at most
    the rows a run holds) and every R the kernels take up to the rows a
    warp holds."""
    import torch
    from speechain_tpu_torch.ops import cuda_layernorm as cl
    nv = cl.vectors(Dn, torch.bfloat16)
    bwd = []
    for per_sm in (0.25, 0.5, 1, 2, 4):
        P = max(1, min(N, int(per_sm * sms)))
        rpb = -(-N // P)
        P = -(-N // rpb)
        for W in (1, 2, 4, 8):
            for R in (1, 2, 4):
                if W <= rpb and (R == 1 or (R * nv <= cl.MAX_CHUNK
                                            and R <= -(-rpb // W))):
                    if (P, W, R) not in bwd:
                        bwd.append((P, W, R))
    return (1, 2, 4, 8), bwd


def check_layer_norm_geometry(rnd):
    """The LayerNorm launches as built (``layer_norm_layout``) against
    the wrapper's reckoning (``cuda_layernorm.layout``) at every phase-2d
    shape, both dtypes, at the card's SM count; the kernels' registers and
    spills from the build log; then the launch sweep: at each LN_TIMED
    shape in bf16 every ``ln_candidates`` launch timed on the device (one
    CUDA graph of 50 calls), and the wrapper's picks (``FWD_WARPS``,
    ``backward_geometry``), timed twice, must be within SWEEP_SLACK of the
    fastest. Returns the sweep's table."""
    import torch
    from speechain_tpu_torch.ops import cuda_layernorm as cl
    sms = cl.sm_count(torch.device("cuda", torch.cuda.current_device()))
    shapes = [(N, Dn) for _, N, Dn in LN_TIMED] + [(2985, D), (77, TW_D),
                                                    (1, D), (8, 1024)]
    for N, Dn in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            got, want = cl.built_layout(N, Dn, dtype), cl.layout(N, Dn, dtype,
                                                                 sms)
            if got != want:
                raise RuntimeError(f"layer_norm ({N}, {Dn}) {dtype}: the "
                                   f"kernels launch {got}, the wrapper "
                                   f"reckons {want}")
    log(f"  layer_norm launches as reckoned at {len(shapes)} shapes x 2 "
        f"dtypes ({sms} SMs; encoder bf16: "
        f"{cl.layout(B * 199, D, torch.bfloat16, sms)})")
    if cl.KERNEL.build_log:
        log("  layer_norm registers (spill stores / loads, bytes): "
            + ", ".join(f"{n}<{','.join(map(str, t))}> {r} ({a}/{b})"
                        for n, t, r, a, b in ptxas_table(
                            cl.KERNEL.build_log, names=("ln_",))))
    else:
        log("  layer_norm registers not read: the library was built before")
    sweep, slow = [], []
    for label, N, Dn in LN_TIMED:
        x = rnd(N, Dn, scale=3.0, shift=1.0, dtype=torch.bfloat16)
        sc, bi = rnd(Dn, scale=0.5, shift=1.0), rnd(Dn, scale=0.1)
        g = rnd(N, Dn, dtype=torch.bfloat16)
        fwd_c, bwd_c = ln_candidates(N, Dn, sms)
        with torch.no_grad():
            _, mu, rstd = cl._launch_forward(x, sc, bi, 1e-6)
        fwd_pick = cl.FWD_WARPS
        bwd_pick = cl.backward_geometry(N, Dn, torch.bfloat16, sms)
        geometry = cl.backward_geometry

        def fwd_time(c):
            cl.FWD_WARPS = c
            return graph_time(lambda: cl._launch_forward(x, sc, bi, 1e-6,
                                                         stats=False),
                              reps=50)

        def bwd_time(c):
            cl.backward_geometry = lambda *a, c=c: c
            return graph_time(lambda: cl.layer_norm_backward(x, sc, mu, rstd,
                                                             g), reps=50)
        try:
            with torch.no_grad():
                for kind, cands, pick, timer in (
                        ("forward W", fwd_c, fwd_pick, fwd_time),
                        ("backward (P, W, R)", bwd_c, bwd_pick, bwd_time)):
                    times = {c: timer(c) for c in set(cands) | {pick}}
                    best = min(times, key=times.get)
                    again = timer(pick)
                    sweep.append(dict(shape=label, N=N, D=Dn, kind=kind,
                                      device_ms={str(k): v for k, v in
                                                 times.items()},
                                      picked=pick, fastest=best,
                                      picked_again_ms=again))
                    log(f"  layer_norm sweep {kind:<18} {label:<16} "
                        f"N={N:<5} D={Dn}: " + ", ".join(
                            f"{k}: {v:.4f}" for k, v in
                            sorted(times.items(), key=lambda kv: kv[1]))
                        + f"; picked {pick} ({times[pick] / times[best]:.2f}"
                        f"x the fastest, {best}; again {again:.4f})")
                    if min(times[pick], again) > SWEEP_SLACK * times[best]:
                        slow.append(f"{label} {kind}: picked {pick} "
                                    f"{times[pick]:.4f} ms, {best} "
                                    f"{times[best]:.4f}")
        finally:
            cl.FWD_WARPS, cl.backward_geometry = fwd_pick, geometry
    if slow:
        raise RuntimeError("layer_norm launch picks over SWEEP_SLACK: "
                           + "; ".join(slow))
    return sweep


def check_fused_route_kernels():
    """The LayerNorm kernels (rows 12-13) and the fused prenet core (rows
    14-15) against their plain versions, gradients against autograd of the
    plain version, float32 and bfloat16: LayerNorm at the conformer's N =
    3184 (encoder), 496 (training decoder), 256 (decode step), the
    transformer-wide width D = 512 and ragged N, at every case both
    directions bit-equal over REPEATS further launches, and at the timed
    ones the device ms by kernel and ``F.layer_norm``'s backward on the
    device (profiler); the prenet core as :func:`check_prenet_core` says;
    then the LayerNorm launches and their sweep
    (:func:`check_layer_norm_geometry`). Returns one record list per entry
    point, the path's bf16 call first, and the LayerNorm sweep."""
    import torch
    import torch.nn.functional as F
    from speechain_tpu_torch.ops import cuda_layernorm as cl
    from speechain_tpu_torch.ops import cuda_prenet as cp
    gen = torch.Generator(device="cpu").manual_seed(6)

    def rnd(*shape, scale=1.0, shift=0.0, dtype=torch.float32, grad=False):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(
            device=DEV, dtype=dtype).requires_grad_(grad)

    records = {"layer_norm": [], "layer_norm_backward": [],
               "prenet_core": [], "prenet_core_backward": []}

    # ---- LayerNorm (rows 12-13) ----------------------------------------
    ln_cases = (("encoder", B * 199, D, True), ("decoder", B * 31, D, True),
                ("decode step", B * BEAM, D, True),
                ("transformer-wide", B * 199, TW_D, True),
                ("ragged", 2985, D, False), ("ragged", 77, TW_D, False))
    for dtype in (torch.bfloat16, torch.float32):
        sz = dtype.itemsize
        dt = "float32" if dtype == torch.float32 else "bfloat16"
        tol = 1e-4 if dtype == torch.float32 else 2 ** -6
        for label, N, Dn, timed in ln_cases:
            x = rnd(N, Dn, scale=3.0, shift=1.0, dtype=dtype, grad=True)
            sc = rnd(Dn, scale=0.5, shift=1.0, grad=True)
            bi = rnd(Dn, scale=0.1, grad=True)
            g = rnd(N, Dn, dtype=dtype)
            ins = (x, sc, bi)
            yk = cl.fused_layer_norm(x, sc, bi)
            yp = cl.layer_norm_plain(x, sc, bi)
            call = f"layer_norm {label} N={N} D={Dn}"
            ferr = compare_all(call, [yk], [yp], tol)
            berr = compare_all(call + " backward",
                               torch.autograd.grad(yk, ins, g,
                                                   retain_graph=True),
                               torch.autograd.grad(yp, ins, g,
                                                   retain_graph=True), tol)
            fwd = dict(call=call, dtype=dt, shape=f"x ({N}, {Dn})",
                       max_abs_err=ferr, tol_rel=tol)
            bwd = dict(fwd, max_abs_err=berr)
            x_, s_, b_ = (t.detach() for t in ins)
            with torch.no_grad():
                # both forward paths (with and without mu / rstd) and the
                # backward, bit-equal launch after launch
                check_repeats(call + " " + dt,
                              lambda: cl.fused_layer_norm(x_, s_, b_))
                check_repeats(call + " with statistics " + dt,
                              lambda: cl._launch_forward(x_, s_, b_, 1e-6))
                _, mu, rstd = cl._launch_forward(x_, s_, b_, 1e-6)
                check_repeats(call + " backward " + dt,
                              lambda: cl.layer_norm_backward(x_, s_, mu,
                                                             rstd, g))
            if timed:
                with torch.no_grad():
                    fwd["ms"] = cuda_time(
                        lambda: cl.fused_layer_norm(x_, s_, b_))
                    fwd["plain_ms"] = cuda_time(
                        lambda: cl.layer_norm_plain(x_, s_, b_))
                    sl, bl = s_.to(dtype), b_.to(dtype)
                    fwd["library_ms"] = cuda_time(
                        lambda: F.layer_norm(x_, (Dn,), sl, bl, 1e-6))
                    bwd["ms"] = cuda_time(lambda: cl.layer_norm_backward(
                        x_, s_, mu, rstd, g))
                    fwd["device_ms"] = graph_time(
                        lambda: cl.fused_layer_norm(x_, s_, b_))
                    bwd["device_ms"] = graph_time(
                        lambda: cl.layer_norm_backward(x_, s_, mu, rstd, g))
                    fwd["library_device_ms"] = graph_time(
                        lambda: F.layer_norm(x_, (Dn,), sl, bl, 1e-6))
                    for r, fn in ((fwd, lambda: cl.fused_layer_norm(
                            x_, s_, b_)), (bwd, lambda: cl.layer_norm_backward(
                                x_, s_, mu, rstd, g))):
                        split = {}
                        r["device_ms_profiled"] = profiled_time(
                            fn, by_kernel=split)
                        r["device_ms_by_kernel"] = split
                bwd["plain_ms"] = grad_time(yp, ins, g)
                lib_in = [t.clone().requires_grad_() for t in (x_, sl, bl)]
                lib = F.layer_norm(lib_in[0], (Dn,), lib_in[1], lib_in[2],
                                   1e-6)
                bwd["library_ms"] = grad_time(lib, lib_in, g)
                # autograd through F.layer_norm runs outside a graph: its
                # device time from the profiler's kernel times
                bwd["library_device_ms"] = profiled_time(
                    lambda: torch.autograd.grad(lib, lib_in, g,
                                                retain_graph=True))
                for r, back in ((fwd, False), (bwd, True)):
                    r["bound_ms"], r["bound_by"] = bound(
                        *layer_norm_cost(N, Dn, sz, back), dt)
                for nm, r in (("fwd", fwd), ("bwd", bwd)):
                    log(f"  {call + ' ' + nm:<44} {dt:<8} err "
                        f"{r['max_abs_err']:.3e}  kernel {r['ms']:.4f} ms "
                        f"(device {r['device_ms']:.4f})  plain "
                        f"{r['plain_ms']:.4f} ms  F.layer_norm "
                        f"{r['library_ms']:.4f} ms"
                        + (f" (device {r['library_device_ms']:.4f})"
                           if "library_device_ms" in r else "")
                        + f"  bound {r['bound_ms']:.5f} ms "
                        f"({r['bound_by']})")
                    log(f"    {nm} device ms by kernel (profiler, "
                        f"{r['device_ms_profiled']:.4f}): " + ", ".join(
                            f"{k} {v:.4f}" for k, v in
                            r["device_ms_by_kernel"].items()))
            else:
                log(f"  {call:<44} {dt:<8} err fwd {ferr:.3e} bwd "
                    f"{berr:.3e} ok")
            records["layer_norm"].append(fwd)
            records["layer_norm_backward"].append(bwd)

    records.update(check_prenet_core(rnd))
    return records, check_layer_norm_geometry(rnd)


# prenet-core cases (label, B, T, F, C, timed): the path's mel (16, 801, 80)
# at every C the gate admits up to 512 (C 256 is conformer-small's, 512
# transformer-wide's), the reference test's odd shape, and the F2 extremes
# (F2 64: the widest conv2 rows the kernels take; F2 1: the tallest tile)
PATH_T = SECS * SR // 160 + 1
PRENET_CASES = (("path", B, PATH_T, 80, D, True),
                ("C 128", B, PATH_T, 80, 128, False),
                ("C 384", B, PATH_T, 80, 384, False),
                ("transformer-wide width", B, PATH_T, 80, TW_D, True),
                ("odd", 3, 37, 21, 128, False),
                ("F2 64", 2, 41, 259, 128, False),
                ("F2 1", 2, 301, 7, 128, False))
PRENET_PROFILED = (D, TW_D)        # C of the timed cases profiled by kernel


def check_prenet_core(rnd):
    """The fused prenet core (rows 14-15) against its plain version
    (gradients: autograd of the plain version; the mel's gradient must be
    exactly zero) at every PRENET_CASES shape, bfloat16 and float32; the
    backward's dw2 and A bit-equal over two runs; at the timed shapes the
    time per call and on the device (one CUDA graph), and at C 256 and 512
    the device ms by kernel (profiler) and the bf16 composition yardstick
    (the reference's XLA core, ``xla_prenet_core``: conv1 as one bf16
    product, conv2 by cuDNN; never on the port's path; per call and on
    the device from the profiler; backward: its autograd). Returns one record list per entry point, the
    path's bf16 call first."""
    import torch
    from speechain_tpu_torch.ops import cuda_prenet as cp
    records = {"prenet_core": [], "prenet_core_backward": []}
    check_prenet_layout()
    for dtype in (torch.bfloat16, torch.float32):
        sz = dtype.itemsize
        dt = "float32" if dtype == torch.float32 else "bfloat16"
        tol = 1e-4 if dtype == torch.float32 else 2 ** -6
        for label, Bq, T, Fm, C, timed in PRENET_CASES:
            _, _, T2, F2 = cp.geom(T, Fm)
            mel = rnd(Bq, T, Fm, dtype=dtype, grad=True)
            w1 = rnd(9, C, scale=1 / 3, grad=True)
            g1 = rnd(C, scale=0.2, shift=1.0, grad=True)
            b1 = rnd(C, scale=0.1, grad=True)
            w2 = rnd(9, C, C, scale=(9 * C) ** -0.5, grad=True)
            g = rnd(Bq, T2, F2, C, dtype=dtype)
            params = (w1, g1, b1, w2)
            ok = cp.fused_prenet_core(mel, *params, "LeakyReLU")
            op = cp.prenet_core_plain(mel, *params, "LeakyReLU")
            call = f"prenet_core {label} ({Bq}, {T}, {Fm}) C={C}"
            ferr = compare_all(call, [ok], [op], tol)
            gk = torch.autograd.grad(ok, (mel, *params), g,
                                     retain_graph=True)
            if int(torch.count_nonzero(gk[0])) != 0:
                raise RuntimeError(f"{call}: the mel gradient is not zero")
            berr = compare_all(call + " backward", gk[1:],
                               torch.autograd.grad(op, params, g,
                                                   retain_graph=True), tol)
            m_ = mel.detach()
            kp = cp._kernel_params(dtype, *(t.detach() for t in params))
            with torch.no_grad():
                runs = [cp.prenet_core_backward(m_, *kp, g, "LeakyReLU")
                        for _ in range(2)]
                # a kernel that reads shared memory before it is written
                # gives outputs that vary from run to run
                if not all(torch.equal(ok, cp._launch_forward(
                        m_, *kp, "LeakyReLU")) for _ in range(3)):
                    raise RuntimeError(f"{call}: the output differs "
                                       "between runs")
            for name, a, b in zip(("dw2", "A", "sum dy", "sum dy z"),
                                  *runs):
                if not torch.equal(a, b):
                    raise RuntimeError(f"{call}: {name} differs between "
                                       "two runs")
            fwd = dict(call=call, dtype=dt,
                       shape=f"mel ({Bq}, {T}, {Fm}) C={C}",
                       max_abs_err=ferr, tol_rel=tol, library_ms=None)
            bwd = dict(fwd, max_abs_err=berr)
            if timed:
                with torch.no_grad():
                    fwd["ms"] = cuda_time(
                        lambda: cp._launch_forward(m_, *kp, "LeakyReLU"),
                        reps=10)
                    fwd["plain_ms"] = cuda_time(
                        lambda: cp.prenet_core_plain(m_, *params,
                                                     "LeakyReLU"),
                        reps=5, warmup=1)
                    bwd["ms"] = cuda_time(lambda: cp.prenet_core_backward(
                        m_, *kp, g, "LeakyReLU"), reps=10)
                    fwd["device_ms"] = graph_time(
                        lambda: cp._launch_forward(m_, *kp, "LeakyReLU"),
                        reps=10)
                    bwd["device_ms"] = graph_time(
                        lambda: cp.prenet_core_backward(m_, *kp, g,
                                                        "LeakyReLU"),
                        reps=10)
                bwd["plain_ms"] = grad_time(op, params, g, reps=5, warmup=1)
                for r, back in ((fwd, False), (bwd, True)):
                    r["bound_ms"], r["bound_by"] = bound(
                        *prenet_cost(Bq, T, Fm, C, sz, back), dt)
                if dtype == torch.bfloat16 and C in PRENET_PROFILED:
                    prenet_yardsticks(m_, kp, params, g, fwd, bwd)
                for nm, r in (("fwd", fwd), ("bwd", bwd)):
                    log(f"  {call + ' ' + nm:<52} {dt:<8} err "
                        f"{r['max_abs_err']:.3e}  kernel {r['ms']:.4f} ms "
                        f"(device {r['device_ms']:.4f})  plain "
                        f"{r['plain_ms']:.4f} ms  bound "
                        f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
            else:
                log(f"  {call:<52} {dt:<8} err fwd {ferr:.3e} bwd "
                    f"{berr:.3e} ok")
            records["prenet_core"].append(fwd)
            records["prenet_core_backward"].append(bwd)
            del ok, op, gk, runs
    return records


def check_prenet_layout():
    """The bf16 kernels' built shared memory (static plus dynamic) and
    grids against the wrapper's reckoning (``tc_smem_bytes``,
    ``tc_grids``) at every PRENET_CASES shape; each prenet kernel's
    registers and spills from the build log."""
    import torch
    from speechain_tpu_torch.ops import cuda_prenet as cp
    sms = cp.sm_count(torch.device("cuda", torch.cuda.current_device()))
    for _, Bq, T, Fm, C, _ in PRENET_CASES:
        got = cp.built_layout(Bq, T, Fm, C)
        want = {"smem": cp.tc_smem_bytes(T, Fm),
                "grids": cp.tc_grids(Bq, T, Fm, C, sms)}
        if got != want:
            raise RuntimeError(f"prenet ({Bq}, {T}, {Fm}) C={C}: the kernels "
                               f"have {got}, the wrapper reckons {want}")
    log("  prenet bf16 shared memory and grids as reckoned at "
        f"{len(PRENET_CASES)} shapes (path: "
        f"{cp.tc_smem_bytes(PATH_T, 80)})")
    if not cp.KERNEL.build_log:        # built by an earlier run: no log
        log("  prenet registers not read: the library was built before")
        return
    rows = ptxas_table(cp.KERNEL.build_log, names=("prenet_",))
    if not any(r[0] == "prenet_fwd_tc" for r in rows):
        raise RuntimeError("the build log names no prenet_fwd_tc")
    log("  prenet registers (spill stores / loads, bytes): " + ", ".join(
        f"{n}{'<' + ','.join(map(str, t)) + '>' if t else ''} {r}"
        f" ({ss}/{sl})" for n, t, r, ss, sl in rows))


def prenet_yardsticks(m_, kp, params, g, fwd, bwd):
    """Into the records of one timed bf16 prenet-core case: each
    direction's device ms by kernel (profiler), and the composition
    yardstick's time per call and on the device (``xla_prenet_core`` on
    the patches; backward: its autograd in w1, g1, b1, w2)."""
    import torch
    from speechain_tpu_torch.ops import cuda_prenet as cp
    for r, fn in ((fwd, lambda: cp._launch_forward(m_, *kp, "LeakyReLU")),
                  (bwd, lambda: cp.prenet_core_backward(m_, *kp, g,
                                                        "LeakyReLU"))):
        split = {}
        with torch.no_grad():
            profiled_time(fn, reps=5, by_kernel=split)
        r["by_kernel_ms"] = split
    M = cp.build_patches_std(m_)
    with torch.no_grad():
        def comp_fwd():
            return cp.xla_prenet_core(M, *(t.detach() for t in params),
                                      "LeakyReLU")
        fwd["library_composition_ms"] = cuda_time(comp_fwd, reps=10)
        fwd["library_composition_device_ms"] = profiled_time(comp_fwd,
                                                             reps=5)
    comp_out = cp.xla_prenet_core(M, *params, "LeakyReLU")

    def comp_bwd():
        return torch.autograd.grad(comp_out, params, g, retain_graph=True)
    bwd["library_composition_ms"] = cuda_time(comp_bwd, reps=10)
    bwd["library_composition_device_ms"] = profiled_time(comp_bwd, reps=5)
    for nm, r in (("fwd", fwd), ("bwd", bwd)):
        log(f"    {nm} device ms by kernel: " + ", ".join(
            f"{k} {v:.4f}" for k, v in sorted(r["by_kernel_ms"].items(),
                                               key=lambda kv: -kv[1]))
            + f"; composition (bf16 product + cuDNN conv"
            + (", autograd" if r is bwd else "") + f") "
            f"{r['library_composition_ms']:.4f} ms a call, device "
            f"{r['library_composition_device_ms']:.4f}")


# --------------------------------------------------------------- phase 3

def phase_path(routes=None, tag="decode"):
    """The decode call at full size; ``routes`` (ARASRConfig fields) turns
    the opt-in routes on, whose launches must then be exactly predicted:
    one prenet core, and ENC_LN LayerNorms in the encoder pass plus DEC_LN
    in each decode step (priming runs none)."""
    import torch
    from speechain_tpu_torch.infer.asr import make_asr_decoder
    net = build_net(torch.bfloat16, seed=0, routes=routes)
    decode = make_asr_decoder(net, beam_size=BEAM, eos_filtering=True,
                              eos_threshold=-1e9)
    wave, wave_len = waves(B, seed=2)
    feat = torch.from_numpy(wave).cuda()
    feat_len = torch.from_numpy(wave_len).cuda()

    t0 = time.perf_counter()
    decode(feat, feat_len)                        # warm-up (cuBLAS, cuDNN)
    torch.cuda.synchronize()
    log(f"  warm-up decode {1e3 * (time.perf_counter() - t0):.1f} ms")

    reset_counts()
    held = held_mib()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = decode(feat, feat_len)
    torch.cuda.synchronize()
    total_ms = 1e3 * (time.perf_counter() - t0)
    launches = entry_counts()
    peak = torch.cuda.max_memory_allocated()

    repeat_ms = []                                # spread of the same run
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode(feat, feat_len)
        torch.cuda.synchronize()
        repeat_ms.append(1e3 * (time.perf_counter() - t0))
    busy = profile_device(lambda: decode(feat, feat_len), total_ms, tag)

    with torch.inference_mode():
        enc_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc_feat, enc_len, _ = net.encode(feat, feat_len)
            torch.cuda.synchronize()
            enc_ms.append(1e3 * (time.perf_counter() - t0))
    encode_ms = float(np.median(enc_ms))
    steps = int(out["steps"])
    step_ms = (total_ms - encode_ms) / max(steps, 1)

    hypo = out["hypo_text"]
    T_enc = enc_feat.shape[1]
    maxlen = max(int(T_enc / 3.0), 2)
    if tuple(hypo.shape) != (B, maxlen):
        raise RuntimeError(f"hypo_text shape {tuple(hypo.shape)}")
    if not (0 <= int(hypo.min()) and int(hypo.max()) < V):
        raise RuntimeError("hypo_text holds tokens outside the vocabulary")
    if not torch.isfinite(out["hypo_text_confid"]).all():
        raise RuntimeError("non-finite hypothesis scores")
    if not torch.isfinite(enc_feat.float()).all():
        raise RuntimeError("non-finite encoder output")
    if steps != maxlen - 1:
        raise RuntimeError(f"{steps} decode steps, expected {maxlen - 1} "
                           "(eos_threshold=-1e9 forbids early ends)")
    for name in DECODE_PATH:
        if launches[name] <= 0:
            raise RuntimeError(f"kernel {name} was not launched on the path")
    want = dict(layer_norm=ENC_LN + DEC_LN * steps if routes else 0,
                prenet_core=1 if routes else 0, layer_norm_backward=0,
                prenet_core_backward=0)
    for name, count in want.items():
        if launches[name] != count:
            raise RuntimeError(f"{name}: {launches[name]} launches in the "
                               f"decode call, predicted {count}")
    log(f"  {B} x {SECS} s, beam {BEAM}: total {total_ms:.1f} ms, encode "
        f"{encode_ms:.2f} ms, {steps} steps at {step_ms:.3f} ms/step, "
        f"{B / total_ms * 1e3:.2f} utt/s, realtime factor "
        f"{B * SECS / total_ms * 1e3:.1f}x, T_enc {T_enc}, peak memory "
        f"{peak / 2**20:.1f} MiB ({held:.1f} held before the call)")
    log(f"  repeats of the same decode: "
        f"{', '.join(f'{t:.1f}' for t in repeat_ms)} ms")
    log(f"  launches on the path: {json.dumps(launches)}")
    return dict(total_ms=total_ms, repeat_ms=repeat_ms, encode_ms=encode_ms,
                steps=steps, step_ms=step_ms, utt_per_s=B / total_ms * 1e3,
                realtime_factor=B * SECS / total_ms * 1e3,
                peak_mib=peak / 2**20, held_mib=held, T_enc=T_enc,
                launches=launches, device=busy)


# device kernels of the port, by entry point, as the profiler names them
PORT_KERNELS = {"logmel": ("logmel_tile",),
                "ffn": ("ffn_kernel", "ffn_fwd_tc"),
                "ffn_backward": ("ffn_bwd_rows", "wgrad_kernel",
                                 "colsum_kernel", "ffn_wgrad_tc"),
                "relpos_attention": ("relpos_fwd",),
                "relpos_attention_backward": ("relpos_bwd",),
                "convmod": ("convmod_kernel", "convmod_fwd_tc", "stats_reduce"),
                "convmod_backward": ("convmod_bwd",),
                "flash_attention": ("flash_fwd",),
                "flash_attention_backward": ("flash_bwd",),
                "layer_norm": ("ln_fwd_rows",),
                "layer_norm_backward": ("ln_bwd_rows", "ln_bwd_sums"),
                "prenet_core": ("prenet_fwd",),
                "prenet_core_backward": ("prenet_bwd", "prenet_sum_parts")}


def profile_device(fn, wall_ms: float, tag: str, host: bool = True):
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the device's busy share of the unprofiled wall time ``wall_ms``."""
    rows = device_kernels(fn, host=host)
    busy_ms = sum(r[0] for r in rows)
    ours = {}
    for ms, n, key in rows:
        for name, parts in PORT_KERNELS.items():
            if any(part in key for part in parts):
                ours[name] = ours.get(name, 0.0) + ms
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    with open(OUT_DIR / f"profile_{tag}.txt", "w") as f:
        f.write(f"device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall\n")
        for ms, n, key in rows:
            f.write(f"{ms:10.3f} ms {n:7d}x  {key}\n")
    log(f"  device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms wall "
        f"({100 * busy_ms / wall_ms:.1f}%, idle "
        f"{100 * (1 - busy_ms / wall_ms):.1f}%); ported kernels "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in ours.items()))
    for ms, n, key in rows[:12]:
        log(f"    {ms:9.3f} ms {n:6d}x  {key[:90]}")
    return dict(busy_ms=busy_ms, wall_ms=wall_ms,
                idle_share=1 - busy_ms / wall_ms, ported_ms=ours,
                top=[dict(ms=ms, count=n, kernel=key)
                     for ms, n, key in rows[:25]])


# --------------------------------------------------------------- phase 4

def phase_path_vs_cpu(routes=None):
    """A float32 2-utterance decode on the card and on the CPU, token-equal;
    with ``routes``, at FUSED_CHECK_SAMPLES samples, so that the encoder's
    400 rows (and the decode steps' 8) take the LayerNorm kernel."""
    import torch
    from speechain_tpu_torch.infer.asr import make_asr_decoder
    kw = dict(beam_size=4, eos_filtering=True, max_len=24)
    wave, wave_len = waves(2, seed=3, L=FUSED_CHECK_SAMPLES if routes
                           else SECS * SR)
    wave_len[1] -= 20000
    results = {}
    for device in ("cuda", "cpu"):
        net = build_net(torch.float32, seed=1, routes=routes)
        out = make_asr_decoder(net, device=device, **kw)(
            torch.from_numpy(wave), torch.from_numpy(wave_len))
        results[device] = {k: v.cpu() if hasattr(v, "cpu") else v
                           for k, v in out.items()}
    g, c = results["cuda"], results["cpu"]
    same = torch.equal(g["hypo_text"], c["hypo_text"])
    score_err = float((g["hypo_text_confid"] - c["hypo_text_confid"]).abs()
                      .max())
    log(f"  float32 decode, card vs cpu: hypo_text token-equal {same}, "
        f"score diff {score_err:.2e}; card hypo {g['hypo_text'].tolist()}")
    if not same:
        raise RuntimeError(f"card and CPU hypotheses differ:\n"
                           f"{g['hypo_text']}\n{c['hypo_text']}")
    if score_err > 1e-3:
        raise RuntimeError(f"card and CPU scores differ by {score_err}")
    return dict(token_equal=same, score_err=score_err)


# --------------------------------------------------------- phases 5 to 7

def transformer_wide_config(dtype, layers=(TW_ENC, TW_DEC), dropout=0.1,
                            specaug=True, param_dtype=None):
    """The recipe's transformer-wide ARASRConfig (bpe5k, 78 M
    parameters at full depth)."""
    from speechain_tpu_torch.models.ar_asr import ARASRConfig
    from speechain_tpu_torch.ops.feat_norm import FeatNormConfig
    from speechain_tpu_torch.ops.frontend import FrontendConfig
    from speechain_tpu_torch.ops.specaug import SpecAugmentConfig
    drop = dict(posenc_dropout=dropout, fdfwd_dropout=dropout,
                att_dropout=dropout, res_dropout=dropout)
    return ARASRConfig(
        vocab_size=TW_V,
        frontend=FrontendConfig(n_mels=80, preemphasis=0.97),
        feat_norm=FeatNormConfig(feat_dim=80),
        specaug=(SpecAugmentConfig(freq_mask_width=27, freq_mask_num=2,
                                   time_mask_width=0.05, time_mask_num=2)
                 if specaug else None),
        enc_prenet=dict(conv_dims=[TW_D, TW_D], conv_kernel=3,
                        conv_stride=2, conv_batchnorm=True,
                        conv_activation="LeakyReLU", lnr_dims=TW_D),
        encoder_type="transformer",
        encoder=dict(d_model=TW_D, num_heads=TW_H, num_layers=layers[0],
                     fdfwd_dim=TW_F, fdfwd_activation="GELU",
                     layernorm_first=True, **drop),
        dec_emb=dict(embedding_dim=TW_D),
        decoder=dict(d_model=TW_D, num_heads=TW_H, num_layers=layers[1],
                     fdfwd_dim=TW_F, fdfwd_activation="GELU",
                     emb_layernorm=True, emb_scale=False,
                     layernorm_first=True, **drop),
        ctc_weight=0.3, label_smoothing=0.2, dtype=dtype,
        param_dtype=param_dtype)


def conformer_small_train_config(dtype, layers=(ENC_LAYERS, DEC_LAYERS),
                                  dropout=0.1, specaug=True,
                                  param_dtype=None, routes=None):
    """The recipe's conformer-small ARASRConfig for training
    (recipes/asr/librispeech/train-clean-5/exp_cfg/
    bpe1k_conformer-small.yaml; bench.py:109-134 sets the same widths)."""
    from speechain_tpu_torch.models.ar_asr import ARASRConfig
    from speechain_tpu_torch.ops.feat_norm import FeatNormConfig
    from speechain_tpu_torch.ops.frontend import FrontendConfig
    from speechain_tpu_torch.ops.specaug import SpecAugmentConfig
    drop = dict(posenc_dropout=dropout, fdfwd_dropout=dropout,
                att_dropout=dropout, res_dropout=dropout)
    return ARASRConfig(
        vocab_size=V,
        frontend=FrontendConfig(n_mels=80, preemphasis=0.97),
        feat_norm=FeatNormConfig(feat_dim=80),
        specaug=(SpecAugmentConfig(freq_mask_width=27, freq_mask_num=2,
                                   time_mask_width=0.05, time_mask_num=2)
                 if specaug else None),
        enc_prenet=dict(conv_dims=[D, D], conv_kernel=3, conv_stride=2,
                        conv_batchnorm=True, conv_activation="LeakyReLU",
                        lnr_dims=D),
        encoder_type="conformer",
        encoder=dict(d_model=D, num_heads=H, num_layers=layers[0],
                     fdfwd_dim=F_DIM, fdfwd_activation="GELU",
                     depthwise_kernel_size=K_DW, layernorm_first=True,
                     **drop),
        dec_emb=dict(embedding_dim=D),
        decoder=dict(d_model=D, num_heads=H, num_layers=layers[1],
                     fdfwd_dim=F_DIM, fdfwd_activation="GELU",
                     emb_layernorm=True, emb_scale=False,
                     layernorm_first=True, **drop),
        ctc_weight=0.3, label_smoothing=0.1, dtype=dtype,
        param_dtype=param_dtype, **(routes or {}))


RECIPE_OPT = dict(optim_conf=dict(lr=2e-3, betas=(0.9, 0.98), eps=1e-9),
                  warmup_steps=16000, grad_clip=5.0)
CONFORMER_OPT = dict(optim_conf=dict(lr=2e-3, betas=(0.9, 0.98), eps=1e-9),
                     warmup_steps=25000)        # clip: build_optimizer's 5


def train_batch(n: int, seed: int, vocab: int = TW_V,
                samples: int = SECS * SR, tokens: int = TW_TEXT):
    """n random waveforms (8 s by default) and texts of ``tokens`` tokens
    (<sos/eos> = vocab - 1 at both ends), as torch CPU tensors."""
    import torch
    wave, wave_len = waves(n, seed, L=samples)
    rng = np.random.default_rng(seed + 100)
    text = rng.integers(1, vocab - 1, (n, tokens)).astype(np.int64)
    text[:, 0] = text[:, -1] = vocab - 1
    return dict(feat=torch.from_numpy(wave),
                feat_len=torch.from_numpy(wave_len),
                text=torch.from_numpy(text),
                text_len=torch.full((n,), tokens, dtype=torch.int64))


def build_train_net(cfg, seed: int):
    from speechain_tpu_torch.models.ar_asr import ARASRNet
    from speechain_tpu_torch.utils.weights import random_state_dict
    net = ARASRNet(cfg)
    net.load_state_dict(random_state_dict(net, seed), strict=True)
    return net


def phase_train_path(label, cfg, opt, vocab, launches_want, tag):
    """Full-size training steps through the entry points a user calls:
    launches per step (exactly ``launches_want``), ms/step, mel-frames/s
    and peak memory over 10 steps, and one profiled step."""
    import torch
    from speechain_tpu_torch.train.optim import build_optimizer
    from speechain_tpu_torch.train.state import (init_train_state,
                                                 make_arasr_step)
    t0 = time.perf_counter()
    net = build_train_net(cfg, seed=0)
    n_params = sum(p.numel() for p in net.parameters())
    tx = build_optimizer(**opt)
    state = init_train_state(net, tx, device=DEV)
    step = make_arasr_step(net, cfg, tx, device=DEV)
    batch = train_batch(B, seed=5, vocab=vocab)
    gen = torch.Generator().manual_seed(0)
    log(f"  {label}: {n_params / 1e6:.2f} M parameters, built in "
        f"{time.perf_counter() - t0:.1f} s")
    for _ in range(3):                              # warm-up
        state, m = step(state, batch, gen)
    torch.cuda.synchronize()

    reset_counts()                                  # the counted step
    state, m = step(state, batch, gen)
    torch.cuda.synchronize()
    launches = entry_counts()
    log(f"  launches in one step: {json.dumps(launches)}")
    for name, count in launches.items():
        if count != launches_want.get(name, 0):
            raise RuntimeError(f"{name}: {count} launches in a training "
                               f"step, predicted {launches_want.get(name, 0)}")

    held = held_mib()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        state, m = step(state, batch, gen)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / 10
    peak = torch.cuda.max_memory_allocated()
    metrics = {k: float(v) for k, v in m.items()}
    if not all(np.isfinite(v) for v in metrics.values()):
        raise RuntimeError(f"non-finite training metrics {metrics}")
    T_mel = SECS * SR // 160 + 1
    frames = B * T_mel / (step_ms / 1e3)
    log(f"  {B} x {SECS} s, {TW_TEXT} tokens: {step_ms:.2f} ms/step, "
        f"{frames:.0f} mel-frames/s, peak memory {peak / 2**20:.1f} MiB "
        f"({held:.1f} held before the steps), metrics {json.dumps(metrics)}")
    busy = profile_device(lambda: step(state, batch, gen), step_ms, tag)
    return dict(params=n_params, step_ms=step_ms, mel_frames_per_s=frames,
                peak_mib=peak / 2**20, held_mib=held, T_mel=T_mel,
                launches=launches, metrics=metrics, device=busy), (
                    net, cfg, batch, gen)


def phase_learning(net, cfg, batch, gen, make_step=None):
    """20 steps of ``make_step`` (default: make_arasr_step) at a constant
    5e-4 on one batch; the last loss must be 10 % below the first."""
    from speechain_tpu_torch.train.optim import build_optimizer
    from speechain_tpu_torch.train.state import (init_train_state,
                                                 make_arasr_step)
    tx = build_optimizer("const", optim_conf=dict(lr=5e-4,
                                                  betas=(0.9, 0.98),
                                                  eps=1e-9))
    state = init_train_state(net, tx, device=DEV)
    step = (make_step or make_arasr_step)(net, cfg, tx, device=DEV)
    losses = []
    for _ in range(20):
        state, m = step(state, batch, gen)
        losses.append(m["loss"])
    losses = [float(x) for x in losses]
    log(f"  20 steps at lr 5e-4 on one batch: loss {losses[0]:.3f} -> "
        f"{losses[-1]:.3f} ({100 * (1 - losses[-1] / losses[0]):.1f} % "
        f"lower); all: {', '.join(f'{x:.2f}' for x in losses)}")
    if not losses[-1] <= 0.9 * losses[0]:
        raise RuntimeError(f"the loss fell from {losses[0]} to "
                           f"{losses[-1]}, less than 10 %")
    return dict(losses=losses, drop=1 - losses[-1] / losses[0])


def phase_train_vs_cpu(cfg, opt, vocab, samples=SECS * SR,
                       tokens=TW_TEXT):
    """One step's loss and every gradient, and the parameters and
    BatchNorm running statistics after two steps, on the card and on the
    CPU (plain versions), float32.

    Gradient rule: each within 1e-3 of its max-norm (or of 1e-6 of the
    largest gradient entry, for gradients that are zero up to rounding,
    like the key-projection biases'). The prenet's LeakyReLUs have kinks: a
    pre-activation within ~1e-6 of 0 can take the other branch on the other
    device (the two log-Mel and convolution implementations round
    differently), which moves that position's whole term of the prenet's
    weight gradients by up to ~1e-2 of their max-norm. So the CPU pass
    takes the card's branch wherever the signs differ (straight-through:
    the value moves by less than the rounding, the slope is the card's),
    and the count of such positions is reported. On the fused prenet core
    the conv1 activation is inside the card's kernel, where no hook sees
    it: the card's pre-activations come from ``conv1_preact`` on the
    kernel's own inputs (the kernel's arithmetic, bit for bit), and the
    CPU's plain core takes their branch in the same way."""
    import torch
    import speechain_tpu_torch.nn.prenets as prenets
    from speechain_tpu_torch.ops import cuda_prenet
    from speechain_tpu_torch.models.ar_asr import arasr_loss
    from speechain_tpu_torch.ops.dropout import step_rng
    from speechain_tpu_torch.train.optim import build_optimizer
    from speechain_tpu_torch.train.state import (init_train_state,
                                                 make_arasr_step)
    batch = train_batch(2, seed=6, vocab=vocab, samples=samples,
                        tokens=tokens)
    batch["feat_len"][1] -= SECS * SR // 4
    batch["text_len"][1] = 20
    res = {}
    get_activation = prenets.get_activation
    core, core_act = cuda_prenet.fused_prenet_core, cuda_prenet.get_activation
    for side, dev in (("card", DEV), ("cpu", "cpu")):
        net = build_train_net(cfg, seed=3).to(dev).train()
        b = {k: v.to(dev) for k, v in batch.items()}
        pre, core_pre = [], []
        follow = iter(res["card"]["pre"]) if side == "cpu" else None
        core_follow = iter(res["card"]["core_pre"]) if side == "cpu" \
            else None

        def card_core(mel, w1, g1, b1, w2, act):
            with torch.no_grad():
                core_pre.append(cuda_prenet.conv1_preact(
                    mel, w1, g1, b1)[1].cpu())
            return core(mel, w1, g1, b1, w2, act)

        def cpu_core_act(name):
            act = core_act(name)

            def f(y):
                core_pre.append(y.detach().cpu())
                ref = next(core_follow)
                return act(y + (torch.where((y >= 0) != (ref >= 0), ref, y)
                                - y).detach())
            return f

        def capture(name):
            act = get_activation(name)

            def f(x):
                pre.append(x.detach().cpu())
                if follow is not None:
                    ref = next(follow)
                    x = x + (torch.where((x >= 0) != (ref >= 0), ref, x)
                             - x).detach()
                return act(x)
            return f

        prenets.get_activation = capture
        if side == "card":
            cuda_prenet.fused_prenet_core = card_core
        else:
            cuda_prenet.get_activation = cpu_core_act
        try:
            with step_rng(torch.Generator().manual_seed(0)):
                out = net(b["feat"], b["feat_len"], b["text"],
                          b["text_len"])
                loss, _ = arasr_loss(out, b["text"], b["text_len"], cfg)
        finally:
            prenets.get_activation = get_activation
            cuda_prenet.fused_prenet_core = core
            cuda_prenet.get_activation = core_act
        names = [n for n, _ in net.named_parameters()]
        grads = torch.autograd.grad(loss, list(net.parameters()))
        net = build_train_net(cfg, seed=3)
        tx = build_optimizer(**opt)
        state = init_train_state(net, tx, device=dev)
        step = make_arasr_step(net, cfg, tx, device=dev)
        gen = torch.Generator().manual_seed(0)
        state, m1 = step(state, batch, gen)
        state, _ = step(state, batch, gen)
        res[side] = dict(step_loss=float(m1["loss"]), pre=pre,
                         core_pre=core_pre,
                        grads={n: g.cpu() for n, g in zip(names, grads)},
                        params={n: p.detach().cpu()
                                for n, p in net.named_parameters()},
                        stats={n: b.detach().cpu()
                               for n, b in net.named_buffers()
                               if n.endswith(("running_mean",
                                              "running_var"))})
    c, h = res["card"], res["cpu"]
    flips = sum(int(((a >= 0) != (b >= 0)).sum())
                for a, b in zip(c["pre"], h["pre"]))
    core_flips = sum(int(((a >= 0) != (b >= 0)).sum())
                     for a, b in zip(c["core_pre"], h["core_pre"]))
    if len(c["core_pre"]) != len(h["core_pre"]):
        raise RuntimeError("the fused prenet core ran on one side only")
    loss_rel = abs(c["step_loss"] - h["step_loss"]) / abs(h["step_loss"])
    gscale = max(float(g.abs().max()) for g in h["grads"].values())
    worst, failed = {}, []
    for n, g in h["grads"].items():
        err = float((c["grads"][n] - g).abs().max())
        gmax = float(g.abs().max())
        tol = max(1e-3 * gmax, 1e-6 * gscale)
        worst[n] = err / max(gmax, 1e-30)
        if err > tol:
            failed.append(f"gradient {n}: card vs CPU {err} > {tol}")
    worst_p = 0.0
    for n, p in h["params"].items():
        err = float((c["params"][n] - p).abs().max())
        scale = max(float(p.abs().max()), 1e-6)
        worst_p = max(worst_p, err / scale)
        if err > 1e-4 * scale:
            failed.append(f"parameter {n} after 2 steps: card vs CPU {err} > "
                          f"{1e-4 * scale}")
    worst_s = 0.0
    for n, b in h["stats"].items():
        err = float((c["stats"][n] - b).abs().max())
        scale = max(float(b.abs().max()), 1e-6)
        worst_s = max(worst_s, err / scale)
        if err > 1e-4 * scale:
            failed.append(f"running statistic {n} after 2 steps: card vs "
                          f"CPU {err} > {1e-4 * scale}")
    if loss_rel > 1e-4:
        failed.append(f"card and CPU losses differ by {loss_rel}")
    ranked = sorted(((v, n) for n, v in worst.items()
                     if float(h["grads"][n].abs().max()) > 1e-6 * gscale),
                    reverse=True)
    log(f"  float32, 2 + 2 layers, 2 utterances: step loss card "
        f"{c['step_loss']:.6f} cpu {h['step_loss']:.6f} (rel {loss_rel:.2e})"
        f"; prenet pre-activations of opposite sign (the CPU takes the "
        f"card's branch): {flips} at the prenet's activations, "
        f"{core_flips} in the fused core's conv1 ({len(c['core_pre'])} "
        f"calls); largest gradient differences / max-norm: "
        + ", ".join(f"{n} {v:.2e}" for v, n in ranked[:4])
        + f"; parameters after 2 steps within {worst_p:.2e}, BatchNorm "
        f"running statistics ({len(h['stats'])}) within {worst_s:.2e}")
    if failed:
        raise RuntimeError("; ".join(failed))
    return dict(step_loss_card=c["step_loss"], step_loss_cpu=h["step_loss"],
                loss_rel=loss_rel, kink_flips=flips + core_flips,
                core_kink_flips=core_flips,
                fused_core_calls=len(c["core_pre"]),
                grad_rel_top=[dict(param=n, rel=v) for v, n in ranked[:8]],
                param_worst_rel=worst_p, stats_worst_rel=worst_s)


# --------------------------------------------------------- phases 14, 15

TTS_LAUNCHES = {"flash_attention": 8, "ffn": 8}   # 4 + 4 layers, one each
# card vs CPU HiFi-GAN waveform, x max(1, max|ref|): float32 on both
# sides differs by ~1.4e-6 (PERF.md); the vocoder's convolutions in TF32
# (the control phase 15 runs) move it by far more
TTS_WAVE_TOL = 1e-5


def tts_config(dtype, layers=(4, 4)):
    """bench.py _tts_bench's FastSpeech2 (recipes/tts/ljspeech/exp_cfg/
    fastspeech2.yaml's widths: d 384, F 1536; the benchmark's 4 heads and
    'linear' FFN), at ``layers`` encoder + decoder layers."""
    from speechain_tpu_torch.models.nar_tts import FastSpeech2Config
    from speechain_tpu_torch.ops.frontend import FrontendConfig
    enc, dec = layers
    return FastSpeech2Config(
        vocab_size=TTS_V,
        frontend=FrontendConfig(sr=22050, n_mels=80, win_length=0.05,
                                hop_length=0.0125, fmin=125.0, fmax=7600.0,
                                return_energy=True),
        enc_emb=dict(embedding_dim=TTS_D),
        encoder=dict(d_model=TTS_D, num_heads=TTS_H, num_layers=enc,
                     fdfwd_dim=TTS_F),
        decoder=dict(d_model=TTS_D, num_heads=TTS_H, num_layers=dec,
                     fdfwd_dim=TTS_F),
        max_frame_len=TTS_FRAMES, dtype=dtype)


def build_tts(dtype, seed: int, layers=(4, 4)):
    """FastSpeech2 + HiFi-GAN V1 (in_channels 80) with seeded random
    weights. The duration predictor's output bias is log(7) and its
    weight a tenth of its draw, so about 6 frames a token fill most of
    the 640 frames: with N(0, 1/fan_in) weights the predicted log
    durations are spread about 0, almost no frames, and the decoder would
    attend only masked rows."""
    from speechain_tpu_torch.models.nar_tts import FastSpeech2Net
    from speechain_tpu_torch.nn.vocoder_hifigan import HiFiGAN
    from speechain_tpu_torch.utils.weights import random_state_dict
    net = FastSpeech2Net(tts_config(dtype, layers))
    sd = random_state_dict(net, seed)
    sd["duration_predictor.pred_head.bias"][:] = float(np.log(7.0))
    sd["duration_predictor.pred_head.weight"] *= 0.1
    net.load_state_dict(sd, strict=True)
    voc = HiFiGAN(in_channels=80)
    voc.load_state_dict(random_state_dict(voc, seed + 1), strict=True)
    return net.eval(), voc.eval()


def tts_text(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return (rng.integers(2, TTS_V, (n, TTS_TOKENS)).astype(np.int64),
            np.full((n,), TTS_TOKENS, np.int64))


def wall_times(fn, reps: int = 5):
    """Wall ms of each of ``reps`` calls of ``fn``, each between two
    synchronisations of the card."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t1))
    return times


def check_synth_output(out, n: int):
    import torch
    feat, wave = out["hypo_feat"], out["wave"]
    if tuple(feat.shape) != (n, TTS_FRAMES, 80):
        raise RuntimeError(f"hypo_feat shape {tuple(feat.shape)}")
    if tuple(wave.shape) != (n, TTS_FRAMES * 256):
        raise RuntimeError(f"wave shape {tuple(wave.shape)}")
    if not (torch.isfinite(feat.float()).all() and torch.isfinite(wave).all()
            and float(wave.abs().max()) <= 1.0):
        raise RuntimeError("non-finite features or a waveform outside "
                           "[-1, 1]")
    lens = out["hypo_feat_len"]
    if not (int(lens.min()) >= 1 and int(lens.max()) <= TTS_FRAMES):
        raise RuntimeError(f"frame lengths {lens.tolist()}")
    if not torch.equal(out["wave_len"], lens * 256):
        raise RuntimeError("wave_len is not 256 x the frame length")


def phase_tts_path():
    """bench.py _tts_bench's synthesis through make_fastspeech2_synthesizer
    at full width and depth: launches exactly TTS_LAUNCHES, the wall ms of
    one call and of FastSpeech2 and HiFi-GAN alone, audio seconds per
    wall second, peak memory, one profiled call; the FFN kernel timed at
    the synthesis shapes (row 4 at D 384)."""
    import torch
    from speechain_tpu_torch.infer.tts import make_fastspeech2_synthesizer
    t0 = time.perf_counter()
    net, voc = build_tts(torch.bfloat16, seed=0)
    synth = make_fastspeech2_synthesizer(net, voc, max_frames=TTS_FRAMES)
    fs2 = make_fastspeech2_synthesizer(net, max_frames=TTS_FRAMES)
    text, text_len = (torch.from_numpy(a).cuda() for a in tts_text(TTS_B, 9))
    n_params = sum(p.numel() for p in net.parameters())
    n_voc = sum(p.numel() for p in voc.parameters())
    log(f"  FastSpeech2 {n_params / 1e6:.2f} M parameters (bf16), HiFi-GAN "
        f"V1 {n_voc / 1e6:.2f} M (float32), built in "
        f"{time.perf_counter() - t0:.1f} s; duration head bias log(7), "
        f"weight x 0.1 (about 6 frames a token)")
    for _ in range(2):
        out = synth(text, text_len)                    # warm-up
    torch.cuda.synchronize()

    reset_counts()
    held = held_mib()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = synth(text, text_len)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    launches = entry_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"  launches in one synthesis call: {json.dumps(launches)}")
    for name, count in launches.items():
        if count != TTS_LAUNCHES.get(name, 0):
            raise RuntimeError(f"{name}: {count} launches in a synthesis "
                               f"call, predicted {TTS_LAUNCHES.get(name, 0)}")
    check_synth_output(out, TTS_B)

    call_ms = wall_times(lambda: synth(text, text_len))
    fs2_ms = wall_times(lambda: fs2(text, text_len))
    mel = out["hypo_feat"].float()
    with torch.inference_mode():
        voc_ms = wall_times(lambda: voc(mel))
    med = float(np.median(call_ms))
    audio_s = TTS_B * TTS_FRAMES * 0.0125              # as _tts_bench
    lens = out["hypo_feat_len"].tolist()
    log(f"  {TTS_B} x {TTS_TOKENS} tokens -> {TTS_B} x {TTS_FRAMES} frames "
        f"(used {min(lens)}..{max(lens)}) -> {TTS_B} x {TTS_FRAMES * 256} "
        f"samples: call {med:.2f} ms (median of "
        f"{', '.join(f'{t:.2f}' for t in call_ms)}; first counted "
        f"{wall_ms:.2f}), FastSpeech2 {float(np.median(fs2_ms)):.2f} ms, "
        f"HiFi-GAN {float(np.median(voc_ms)):.2f} ms, "
        f"{audio_s / med * 1e3:.1f} audio s per wall s, peak memory "
        f"{peak / 2**20:.1f} MiB ({held:.1f} held before the call)")
    busy = profile_device(lambda: synth(text, text_len), med, "tts")
    busy_fs2 = profile_device(lambda: fs2(text, text_len),
                              float(np.median(fs2_ms)), "tts_fastspeech2")

    ffn_records = [ffn_case(label, N, TTS_D, TTS_F, "ReLU", 1.0, True, rate,
                            torch.bfloat16, False, 51)
                   for label, N in (("tts decoder", TTS_B * TTS_FRAMES),
                                    ("tts encoder", TTS_B * TTS_TOKENS))
                   for rate in (0.0, 0.1)]
    return dict(call_ms=med, call_ms_runs=call_ms, first_call_ms=wall_ms,
                fastspeech2_ms=float(np.median(fs2_ms)),
                hifigan_ms=float(np.median(voc_ms)),
                audio_s_per_wall_s=audio_s / med * 1e3, peak_mib=peak / 2**20,
                held_mib=held,
                frame_len=lens, launches=launches, params=n_params,
                vocoder_params=n_voc, device=busy,
                device_fastspeech2=busy_fs2), ffn_records


def phase_tts_vs_cpu():
    """float32 synthesis of 2 utterances at full width, 2 + 2 layers, on
    the card and with device="cpu" (the kernels' plain versions):
    durations equal, mel within 1e-4 and the waveform within TTS_WAVE_TOL
    of max(1, max|ref|); the vocoder also on the same (the CPU's) mel on
    both, which isolates its own card-vs-CPU difference. As a control,
    the vocoder runs once more on that mel with cuDNN's TF32 turned on,
    the lower precision the limit is there to catch: that reading must
    exceed the limit, or the limit could not tell the two apart."""
    import torch
    from speechain_tpu_torch.infer.tts import make_fastspeech2_synthesizer
    text, text_len = tts_text(2, 13)
    text_len[1] = TTS_TOKENS - 20
    text[1, TTS_TOKENS - 20:] = 0
    res = {}
    for device in ("cuda", "cpu"):
        net, voc = build_tts(torch.float32, seed=3, layers=(2, 2))
        out = make_fastspeech2_synthesizer(
            net, voc, device=device, max_frames=TTS_FRAMES)(
            torch.from_numpy(text), torch.from_numpy(text_len))
        res[device] = ({k: v.cpu() for k, v in out.items()}, voc)
    (g, gvoc), (c, _) = res["cuda"], res["cpu"]
    check_synth_output(g, 2)
    same_dur = torch.equal(g["used_duration"], c["used_duration"])
    same_len = torch.equal(g["hypo_feat_len"], c["hypo_feat_len"])
    mel_err = float((g["hypo_feat"] - c["hypo_feat"]).abs().max())
    mel_ref = max(1.0, float(c["hypo_feat"].abs().max()))
    wave_err = float((g["wave"] - c["wave"]).abs().max())
    wave_ref = max(1.0, float(c["wave"].abs().max()))
    with torch.inference_mode():
        voc_only = gvoc(c["hypo_feat"].cuda()).cpu()
    voc_err = float((voc_only - c["wave"]).abs().max())
    tf32 = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        with torch.inference_mode():
            voc_tf32 = gvoc(c["hypo_feat"].cuda()).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    tf32_err = float((voc_tf32 - c["wave"]).abs().max())
    log(f"  float32, 2 + 2 layers, 2 utterances ({text_len.tolist()} "
        f"tokens, {c['hypo_feat_len'].tolist()} frames): durations equal "
        f"{same_dur}, lengths equal {same_len}; mel max err {mel_err:.3e} "
        f"(tol {1e-4 * mel_ref:.3e}); wave max err {wave_err:.3e} (tol "
        f"{TTS_WAVE_TOL * wave_ref:.3e}); the vocoder alone on the CPU's "
        f"mel {voc_err:.3e}, with cuDNN TF32 on (control) {tf32_err:.3e}")
    if not (same_dur and same_len):
        raise RuntimeError("card and CPU durations differ")
    if mel_err > 1e-4 * mel_ref:
        raise RuntimeError(f"card and CPU mel differ by {mel_err}")
    if max(wave_err, voc_err) > TTS_WAVE_TOL * wave_ref:
        raise RuntimeError(f"card and CPU waveforms differ by "
                           f"{max(wave_err, voc_err)}")
    if tf32_err <= TTS_WAVE_TOL * wave_ref:
        raise RuntimeError(f"the TF32 control ({tf32_err}) is within the "
                           f"waveform limit, so the limit would not catch "
                           f"TF32")
    return dict(durations_equal=same_dur, mel_err=mel_err, wave_err=wave_err,
                vocoder_only_err=voc_err, vocoder_tf32_control_err=tf32_err,
                frame_len=c["hypo_feat_len"].tolist(),
                wave_tol_rel=TTS_WAVE_TOL)


# ----------------------------------------------------- phases 16 to 18

# FastSpeech2 trained as recipes/tts/ljspeech/exp_cfg/fastspeech2.yaml
# (d 384, 2 heads of 192, 4 + 4 layers, the 'conv' FFN): each layer's
# self-attention forward and backward go through the flash kernels, the
# FFN is two convolutions, and the targets come from the plain frontend
TTS_TRAIN_LAUNCHES = {"flash_attention": 8, "flash_attention_backward": 8}
TTS_SAMPLES = (TTS_FRAMES - 1) * 275          # 175,725 samples, 640 frames
TTS_OPT = dict(optim_conf=dict(lr=1e-3, betas=(0.9, 0.98), eps=1e-9),
               warmup_steps=6000)               # clip: build_optimizer's 5
TTS_GL_ITERS = 32
# card vs CPU Griffin-Lim waveform on the same mel from the same phases,
# x max|ref|, after GL_CHECK_ITERS iterations: the tolerance and iteration
# count of the CPU test's griffin_lim comparison. Each iteration carries
# the last one's rounding into the phases, and the quiet bins' phases
# amplify it: on the CPU, JAX against the port at 2 x 640 frames drifts
# ~1.4e-5 after 8 iterations and ~1.6e-4 after 32 (python -m
# tests.test_torch_port_griffin_lim)
GL_WAVE_TOL = 1e-4
GL_CHECK_ITERS = 8
# after TTS_GL_ITERS, on the same mel and through the whole synthesizer
# (whose mel differs by float32 rounding), x max|ref|: set between the
# sound readings on the H100 (7.8e-5 and 1.3e-4, PERF.md) and the two
# controls phase 18 computes on the CPU, which must fall outside it: one
# iteration fewer and the mel moved by 1e-5 N(0, 1) (1.6e-2 and 1.3e-1
# of max|ref| on the CPU)
GL_WAVE_TOL_32 = 5e-4


def tts_train_config(dtype, layers=(4, 4), dropout=0.2, ffn="conv",
                     heads=2, param_dtype=None):
    """The LJSpeech recipe's FastSpeech2Config (recipes/tts/ljspeech/
    exp_cfg/fastspeech2.yaml, as speechain_tpu/builders.py builds it):
    d 384, F 1536, ``ffn`` 'conv' (kernel 9, ReLU) with ``heads`` heads,
    dropout ``dropout`` in the transformers and 0.5 in the variance
    predictors and the postnet (its default) unless ``dropout`` is 0,
    global feature, pitch and energy norms, the 22.05 kHz frontend with
    energy; ``ffn="linear"`` with 4 heads is bench.py's TTS widths."""
    from speechain_tpu_torch.models.nar_tts import FastSpeech2Config
    from speechain_tpu_torch.ops.feat_norm import FeatNormConfig
    from speechain_tpu_torch.ops.frontend import FrontendConfig
    pdrop = 0.5 if dropout > 0 else 0.0
    layer = dict(d_model=TTS_D, num_heads=heads, fdfwd_dim=TTS_F,
                 fdfwd_type=ffn, fdfwd_activation="ReLU",
                 posenc_dropout=dropout, fdfwd_dropout=dropout,
                 att_dropout=dropout, res_dropout=dropout)
    if ffn == "conv":
        layer["fdfwd_args"] = {"kernel_size": 9}
    pred = dict(conv_dims=[256, 256], conv_kernel=3, conv_dropout=pdrop)
    return FastSpeech2Config(
        vocab_size=TTS_V,
        frontend=FrontendConfig(sr=22050, n_mels=80, win_length=0.05,
                                hop_length=0.0125, fmin=125.0, fmax=7600.0,
                                return_energy=True),
        feat_norm=FeatNormConfig(feat_dim=80),
        pitch_norm=FeatNormConfig(feat_dim=1),
        energy_norm=FeatNormConfig(feat_dim=1),
        enc_emb=dict(embedding_dim=TTS_D),
        encoder=dict(layer, num_layers=layers[0]),
        decoder=dict(layer, num_layers=layers[1]),
        duration_predictor=pred, pitch_predictor=pred, energy_predictor=pred,
        postnet=dict(conv_dims=[256] * 5, conv_kernel=5,
                     conv_dropout=pdrop),
        dtype=dtype, param_dtype=param_dtype)


def tts_train_batch(n: int, seed: int):
    """n seeded utterances: waveforms of TTS_SAMPLES samples (640 frames)
    of a few tones and noise, TTS_TOKENS tokens with teacher durations of
    0-12 frames (one in ten 0), frame-level pitch with unvoiced (0)
    frames, as torch CPU tensors."""
    import torch
    rng = np.random.default_rng(seed)
    t = np.arange(TTS_SAMPLES) / 22050.0
    f0 = rng.uniform(100.0, 300.0, (n, 1))
    wave = (0.3 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(
        2 * np.pi * 3 * f0 * t) + 0.05 * rng.standard_normal(
            (n, TTS_SAMPLES))).astype(np.float32)
    dur = rng.integers(1, 13, (n, TTS_TOKENS)).astype(np.float32)
    dur[rng.random((n, TTS_TOKENS)) < 0.1] = 0.0
    pitch = (f0 * rng.uniform(0.8, 1.2, (n, TTS_FRAMES))).astype(np.float32)
    pitch[rng.random((n, TTS_FRAMES)) < 0.2] = 0.0
    text, text_len = tts_text(n, seed + 1)
    full = lambda v: torch.full((n,), v, dtype=torch.int64)  # noqa: E731
    return dict(text=torch.from_numpy(text),
                text_len=torch.from_numpy(text_len),
                feat=torch.from_numpy(wave[..., None]),
                feat_len=full(TTS_SAMPLES), pitch=torch.from_numpy(pitch),
                pitch_len=full(TTS_FRAMES), duration=torch.from_numpy(dur),
                duration_len=torch.from_numpy(text_len))


def build_tts_train(cfg, seed: int):
    """FastSpeech2 with seeded random weights and BatchNorm statistics,
    and its feature norms as a new model's (no group seen): their first
    update takes the batch's statistics, so that on a repeated batch the
    targets stay put and only learning lowers the loss."""
    from speechain_tpu_torch.models.nar_tts import FastSpeech2Net
    from speechain_tpu_torch.utils.weights import random_state_dict
    net = FastSpeech2Net(cfg)
    sd = random_state_dict(net, seed)
    sd.update({k: v for k, v in net.state_dict().items() if ".stats." in k})
    net.load_state_dict(sd, strict=True)
    return net


def phase_tts_train():
    """The recipe's FastSpeech2 at full width and depth, bf16 compute on
    float32 master weights, 16 utterances of 640 frames through
    init_train_state / build_optimizer / make_fastspeech2_step: launches
    in one step (exactly TTS_TRAIN_LAUNCHES), ms a step (the mean of 10
    after 4 warm-ups), mel frames/s, peak memory and one profiled step."""
    import torch
    from speechain_tpu_torch.train.optim import build_optimizer
    from speechain_tpu_torch.train.state import (init_train_state,
                                                 make_fastspeech2_step)
    t0 = time.perf_counter()
    cfg = tts_train_config(torch.bfloat16, param_dtype=torch.float32)
    net = build_tts_train(cfg, seed=0)
    n_params = sum(p.numel() for p in net.parameters())
    tx = build_optimizer(**TTS_OPT)
    state = init_train_state(net, tx, device=DEV)
    step = make_fastspeech2_step(net, cfg, tx, device=DEV)
    batch = tts_train_batch(TTS_B, seed=21)
    gen = torch.Generator().manual_seed(0)
    log(f"  FastSpeech2 (recipe): {n_params / 1e6:.2f} M parameters, built "
        f"in {time.perf_counter() - t0:.1f} s")
    for _ in range(4):                              # warm-up
        state, m = step(state, batch, gen)
    torch.cuda.synchronize()

    reset_counts()                                  # the counted step
    state, m = step(state, batch, gen)
    torch.cuda.synchronize()
    launches = entry_counts()
    log(f"  launches in one step: {json.dumps(launches)}")
    for name, count in launches.items():
        if count != TTS_TRAIN_LAUNCHES.get(name, 0):
            raise RuntimeError(f"{name}: {count} launches in a FastSpeech2 "
                               f"step, predicted "
                               f"{TTS_TRAIN_LAUNCHES.get(name, 0)}")

    held = held_mib()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        state, m = step(state, batch, gen)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / 10
    peak = torch.cuda.max_memory_allocated()
    metrics = {k: float(v) for k, v in m.items()}
    if not all(np.isfinite(v) for v in metrics.values()):
        raise RuntimeError(f"non-finite training metrics {metrics}")
    frames = TTS_B * TTS_FRAMES / (step_ms / 1e3)
    log(f"  {TTS_B} x {TTS_FRAMES} frames, {TTS_TOKENS} tokens: "
        f"{step_ms:.2f} ms/step, {frames:.0f} mel-frames/s, peak memory "
        f"{peak / 2**20:.1f} MiB ({held:.1f} held before the steps), "
        f"metrics {json.dumps(metrics)}")
    busy = profile_device(lambda: step(state, batch, gen), step_ms,
                          "train_tts")
    return dict(params=n_params, step_ms=step_ms, mel_frames_per_s=frames,
                peak_mib=peak / 2**20, held_mib=held, launches=launches,
                metrics=metrics, device=busy), (net, cfg, batch, gen)


def tts_state_arrays(net):
    """Every parameter and running statistic (BatchNorm, the three feature
    norms) of ``net``, float32 on the CPU, by name."""
    import torch
    return {n: t.detach().float().cpu()
            for n, t in [*net.named_parameters(), *net.named_buffers()]
            if t.dtype != torch.bool}


def tts_first_moments(state):
    """Adam's flat first moment after the steps, split by parameter name
    (the order of ``net.parameters()``, as ``init_train_state`` flattens
    them), float32 on the CPU."""
    mu, out, offset = state.opt_state["mu"].cpu(), {}, 0
    for name, p in state.net.named_parameters():
        out[name] = mu[offset:offset + p.numel()].view(p.shape)
        offset += p.numel()
    if offset != mu.numel():
        raise RuntimeError(f"first moment of {mu.numel()} entries for "
                           f"{offset} parameter entries")
    return out


def phase_tts_train_vs_cpu():
    """Three float32 FastSpeech2 steps at dropout 0, 2 + 2 layers at full
    width, 2 utterances (one 160 frames short, with a padded tail, and
    shorter text), on the card and on the CPU, for the recipe's case
    ('conv' FFN, 2 heads) and bench.py's TTS widths ('linear' FFN, 4
    heads: rows 4/5 at D 384 in training): every step's loss within 1e-4
    relative, the parameters and running statistics after the 3 steps
    within 1e-4 of each array's largest magnitude, and the gradients.

    Noam's warm-up moves each parameter by ~1e-6 over these steps, far
    inside the parameters' tolerance, so the gradients are held through
    Adam's first moment: mu = 0.1 (0.81 g1 + 0.9 g2 + g3) of the clipped
    gradients, each parameter's within 1e-3 of its largest magnitude (or
    of 1e-6 of the largest moment, for moments zero up to rounding, like
    the key-projection biases'), phase 10's rule for gradients. A
    gradient of the wrong sign, or none, fails here."""
    import torch
    from speechain_tpu_torch.train.optim import build_optimizer
    from speechain_tpu_torch.train.state import (init_train_state,
                                                 make_fastspeech2_step)
    batch = tts_train_batch(2, seed=23)
    batch["feat_len"][1] -= 160 * 275
    batch["pitch_len"][1] -= 160
    batch["text_len"][1] = batch["duration_len"][1] = TTS_TOKENS - 30
    batch["duration"][1, TTS_TOKENS - 30:] = 0.0
    batch["text"][1, TTS_TOKENS - 30:] = 0
    out = {}
    for ffn, heads in (("conv", 2), ("linear", 4)):
        cfg = tts_train_config(torch.float32, layers=(2, 2), dropout=0.0,
                               ffn=ffn, heads=heads)
        res = {}
        for side, dev in (("card", DEV), ("cpu", "cpu")):
            net = build_tts_train(cfg, seed=4)
            start = {n: p.detach().clone() for n, p in net.named_parameters()}
            tx = build_optimizer(**TTS_OPT)
            state = init_train_state(net, tx, device=dev)
            step = make_fastspeech2_step(net, cfg, tx, device=dev)
            gen = torch.Generator().manual_seed(0)
            reset_counts()
            losses = []
            for _ in range(3):
                state, m = step(state, batch, gen)
                losses.append(float(m["loss"]))
            res[side] = dict(losses=losses, launches=entry_counts(),
                             arrays=tts_state_arrays(net),
                             moments=tts_first_moments(state))
            if side == "card":
                moved = sum(not torch.equal(res[side]["arrays"][n], p)
                            for n, p in start.items())
        c, h = res["card"], res["cpu"]
        # 2 + 2 layers: half of TTS_TRAIN_LAUNCHES a step, and with the
        # 'linear' FFN one FFN forward and backward a layer
        want = {k: 3 * v // 2 for k, v in TTS_TRAIN_LAUNCHES.items()}
        if ffn == "linear":
            want.update(ffn=3 * 4, ffn_backward=3 * 4)
        for name, count in c["launches"].items():
            if count != want.get(name, 0):
                raise RuntimeError(f"{name}: {count} launches in 3 float32 "
                                   f"steps ({ffn}), predicted "
                                   f"{want.get(name, 0)}")
        loss_rel = max(abs(a - b) / abs(b)
                       for a, b in zip(c["losses"], h["losses"]))
        worst, failed = 0.0, []
        for n, want_a in h["arrays"].items():
            err = float((c["arrays"][n] - want_a).abs().max())
            scale = max(float(want_a.abs().max()), 1e-6)
            worst = max(worst, err / scale)
            if err > 1e-4 * scale:
                failed.append(f"{n}: card vs CPU {err} > {1e-4 * scale}")
        mscale = max(float(m.abs().max()) for m in h["moments"].values())
        worst_m, worst_m_name, used, used_name = 0.0, "", 0.0, ""
        for n, want_m in h["moments"].items():
            err = float((c["moments"][n] - want_m).abs().max())
            mmax = float(want_m.abs().max())
            tol = max(1e-3 * mmax, 1e-6 * mscale)
            if err / tol > used:
                used, used_name = err / tol, n
            if mmax > 1e-6 * mscale and err / mmax > worst_m:
                worst_m, worst_m_name = err / mmax, n
            if err > tol:
                failed.append(f"first moment {n}: card vs CPU {err} > {tol}")
        n_params = len(h["moments"])
        if mscale == 0 or moved < n_params // 2:
            failed.append(f"{moved} of {n_params} parameters moved in 3 "
                          f"steps on the card (first moments up to "
                          f"{mscale})")
        log(f"  float32, 2 + 2 layers, {ffn} FFN, {heads} heads, 2 "
            f"utterances (640 and 480 frames): losses card "
            f"{', '.join(f'{x:.6f}' for x in c['losses'])} cpu "
            f"{', '.join(f'{x:.6f}' for x in h['losses'])} (worst rel "
            f"{loss_rel:.2e}); {len(h['arrays'])} parameters and statistics "
            f"after 3 steps within {worst:.2e} of their max; Adam's first "
            f"moments (the gradients) within {worst_m:.2e} of their max "
            f"(worst {worst_m_name}; at most {used:.2f} of a moment's "
            f"tolerance, {used_name}); {moved} of {n_params} parameters "
            f"moved; launches "
            f"{json.dumps({k: v for k, v in c['launches'].items() if v})}")
        if loss_rel > 1e-4:
            failed.append(f"card and CPU losses differ by {loss_rel}")
        if failed:
            raise RuntimeError("; ".join(failed[:8]))
        out[ffn] = dict(losses_card=c["losses"], losses_cpu=h["losses"],
                        loss_rel=loss_rel, worst_rel=worst,
                        moment_worst_rel=worst_m,
                        moment_worst=worst_m_name,
                        moment_tol_used=used, moment_tol_used_by=used_name,
                        moved=moved,
                        arrays=len(h["arrays"]), launches=c["launches"])
    return out


def phase_gl():
    """Phase 14's FastSpeech2 (bf16, 4 + 4 layers) through
    make_fastspeech2_synthesizer(vocoder="gl") at 16 x 640 frames and
    TTS_GL_ITERS iterations: launches (flash_attention 8, ffn 8, as
    phase 14), wall ms (call and Griffin-Lim alone) and audio s per wall
    s; then float32 on 2 utterances (2 + 2 layers), card against CPU from
    the same initial phases: durations equal, mel within 1e-4, Griffin-Lim
    on the CPU's mel within GL_WAVE_TOL of max|ref| after GL_CHECK_ITERS
    iterations and within GL_WAVE_TOL_32 after TTS_GL_ITERS, and the
    synthesizer's wave within GL_WAVE_TOL_32; the two controls (one
    iteration fewer, the mel moved by 1e-5 N(0, 1), both on the CPU)
    must fall outside GL_WAVE_TOL_32."""
    import torch
    from speechain_tpu_torch.infer.tts import make_fastspeech2_synthesizer
    from speechain_tpu_torch.ops.griffin_lim import logmel_to_wave
    net, _ = build_tts(torch.bfloat16, seed=0)
    synth = make_fastspeech2_synthesizer(net, "gl", max_frames=TTS_FRAMES,
                                         gl_iters=TTS_GL_ITERS)
    text, text_len = (torch.from_numpy(a).cuda() for a in tts_text(TTS_B, 9))
    for _ in range(2):
        out = synth(text, text_len)                    # warm-up
    torch.cuda.synchronize()
    reset_counts()
    out = synth(text, text_len)
    torch.cuda.synchronize()
    launches = entry_counts()
    for name, count in launches.items():
        if count != TTS_LAUNCHES.get(name, 0):
            raise RuntimeError(f"{name}: {count} launches in a gl synthesis "
                               f"call, predicted {TTS_LAUNCHES.get(name, 0)}")
    L = (TTS_FRAMES - 1) * 275
    wave, lens = out["wave"], out["hypo_feat_len"]
    if tuple(wave.shape) != (TTS_B, L) or not torch.isfinite(wave).all():
        raise RuntimeError(f"gl wave shape {tuple(wave.shape)} or "
                           f"non-finite samples")
    if not torch.equal(out["wave_len"], torch.clamp(lens * 275, max=L)):
        raise RuntimeError("gl wave_len is not min(frames x hop, L)")

    call_ms = wall_times(lambda: synth(text, text_len))
    mel = net.recover_feat(out["hypo_feat"]).float()
    with torch.inference_mode():
        gl_ms = wall_times(lambda: logmel_to_wave(mel, lens, net.cfg.frontend,
                                            n_iter=TTS_GL_ITERS))
    med = float(np.median(call_ms))
    audio_s = TTS_B * TTS_FRAMES * 0.0125
    log(f"  {TTS_B} x {TTS_TOKENS} tokens -> {TTS_B} x {TTS_FRAMES} frames "
        f"-> Griffin-Lim ({TTS_GL_ITERS} iterations, n_fft 1102) -> "
        f"{TTS_B} x {L} samples: call {med:.2f} ms (median of "
        f"{', '.join(f'{t:.2f}' for t in call_ms)}), Griffin-Lim alone "
        f"{float(np.median(gl_ms)):.2f} ms, {audio_s / med * 1e3:.1f} audio "
        f"s per wall s; launches {json.dumps({k: v for k, v in launches.items() if v})}")
    busy = profile_device(lambda: synth(text, text_len), med, "tts_gl")

    text2, text_len2 = tts_text(2, 13)
    text_len2[1] = TTS_TOKENS - 20
    text2[1, TTS_TOKENS - 20:] = 0
    phases = torch.rand((2, TTS_FRAMES, 552),
                        generator=torch.Generator().manual_seed(5))
    res = {}
    for device in ("cuda", "cpu"):
        net32, _ = build_tts(torch.float32, seed=3, layers=(2, 2))
        got = make_fastspeech2_synthesizer(
            net32, "gl", device=device, max_frames=TTS_FRAMES,
            gl_iters=TTS_GL_ITERS)(torch.from_numpy(text2),
                                   torch.from_numpy(text_len2),
                                   gl_phases=phases)
        res[device] = ({k: v.cpu() for k, v in got.items()}, net32)
    (g, gnet), (c, cnet) = res["cuda"], res["cpu"]
    same_dur = torch.equal(g["used_duration"], c["used_duration"])
    mel_err = float((g["hypo_feat"] - c["hypo_feat"]).abs().max())
    mel_ref = max(1.0, float(c["hypo_feat"].abs().max()))
    wave_err = float((g["wave"] - c["wave"]).abs().max())
    cmel, clen = cnet.recover_feat(c["hypo_feat"]), c["hypo_feat_len"]
    gl = {}
    for iters in (GL_CHECK_ITERS, TTS_GL_ITERS):     # the CPU's mel on both
        with torch.inference_mode():
            card = logmel_to_wave(cmel.cuda(), clen.cuda(), cnet.cfg.frontend,
                                  n_iter=iters, phases=phases)[0].cpu()
        cpu = (c["wave"] if iters == TTS_GL_ITERS else logmel_to_wave(
            cmel, clen, cnet.cfg.frontend, n_iter=iters, phases=phases)[0])
        gl[iters] = (float((card - cpu).abs().max()),
                     float(cpu.abs().max()))
    (gl_err, gl_ref), (gl32_err, wave_ref) = gl[GL_CHECK_ITERS], \
        gl[TTS_GL_ITERS]
    with torch.inference_mode():                    # the controls
        moved = cmel + 1e-5 * torch.randn(
            cmel.shape, generator=torch.Generator().manual_seed(6))
        controls = {
            f"{TTS_GL_ITERS - 1} iterations": logmel_to_wave(
                cmel, clen, cnet.cfg.frontend, n_iter=TTS_GL_ITERS - 1,
                phases=phases)[0],
            "mel + 1e-5 N(0, 1)": logmel_to_wave(
                moved, clen, cnet.cfg.frontend, n_iter=TTS_GL_ITERS,
                phases=phases)[0]}
    controls = {k: float((w - c["wave"]).abs().max()) / wave_ref
                for k, w in controls.items()}
    log(f"  float32, 2 + 2 layers, 2 utterances ({text_len2.tolist()} "
        f"tokens, {clen.tolist()} frames), the same initial phases: "
        f"durations equal {same_dur}; mel max err {mel_err:.3e} (tol "
        f"{1e-4 * mel_ref:.3e}); Griffin-Lim on the CPU's mel, "
        f"{GL_CHECK_ITERS} iterations {gl_err:.3e} (tol "
        f"{GL_WAVE_TOL * gl_ref:.3e}, max|ref| {gl_ref:.3e}), "
        f"{TTS_GL_ITERS} iterations {gl32_err:.3e}; the synthesizer's wave "
        f"({TTS_GL_ITERS} iterations) {wave_err:.3e} (tol both "
        f"{GL_WAVE_TOL_32 * wave_ref:.3e}, max|ref| {wave_ref:.3e}); "
        f"controls / max|ref| "
        + ", ".join(f"{k} {v:.3e}" for k, v in controls.items())
        + f" (must exceed {GL_WAVE_TOL_32:g})")
    if not (same_dur and torch.equal(g["wave_len"], c["wave_len"])):
        raise RuntimeError("card and CPU durations differ")
    if mel_err > 1e-4 * mel_ref:
        raise RuntimeError(f"card and CPU mel differ by {mel_err}")
    if gl_err > GL_WAVE_TOL * gl_ref:
        raise RuntimeError(f"card and CPU Griffin-Lim waveforms differ by "
                           f"{gl_err} after {GL_CHECK_ITERS} iterations")
    if gl32_err > GL_WAVE_TOL_32 * wave_ref:
        raise RuntimeError(f"card and CPU Griffin-Lim waveforms differ by "
                           f"{gl32_err} after {TTS_GL_ITERS} iterations")
    if wave_err > GL_WAVE_TOL_32 * wave_ref:
        raise RuntimeError(f"card and CPU synthesizer waveforms differ by "
                           f"{wave_err}")
    blind = [k for k, v in controls.items() if v <= GL_WAVE_TOL_32]
    if blind:
        raise RuntimeError(f"controls inside the waveform tolerance: {blind}")
    return dict(call_ms=med, call_ms_runs=call_ms,
                gl_ms=float(np.median(gl_ms)),
                audio_s_per_wall_s=audio_s / med * 1e3, launches=launches,
                frame_len=lens.tolist(), device=busy,
                vs_cpu=dict(durations_equal=same_dur, mel_err=mel_err,
                            gl_err=gl_err, gl_ref=gl_ref,
                            gl_iters=GL_CHECK_ITERS, gl32_err=gl32_err,
                            wave_err=wave_err, wave_ref=wave_ref,
                            wave_tol_rel=GL_WAVE_TOL,
                            wave_tol_rel_32=GL_WAVE_TOL_32,
                            controls=controls))


# ----------------------------------------------------- phases 19 to 22

# Transformer-TTS synthesis at 16 x 100 tokens with the stop head off:
# every row runs to its cap, 100 x 10 / 2 + 1 less one = 500 steps (1000
# frames); a step runs the decoder's 6 FFNs at N = 16 on the FFN kernel
# and attends its caches on the matrix path; the encoder's 6 layers run
# the FFN and flash-attention kernels once
ARTTS_STEPS = 500
ARTTS_SYNTH_LAUNCHES = {"ffn": 6 + 6 * ARTTS_STEPS, "flash_attention": 6}
# a training step: 6 + 6 FFNs, and flash attention for the encoder's 6
# self-attentions, the decoder's 6 causal self-attentions and the
# cross-attention of decoder layers 1-5 (layer 0's, which the attention
# guidance reads, takes the matrix path); each with its backward
ARTTS_TRAIN_LAUNCHES = {"ffn": 12, "ffn_backward": 12,
                        "flash_attention": 17,
                        "flash_attention_backward": 17}
ARTTS_OPT = dict(optim_conf=dict(lr=1e-3, betas=(0.9, 0.98), eps=1e-9),
                 warmup_steps=4000)              # clip: build_optimizer's 5
# card vs CPU synthesis (float32, the prenet's dropout on from the same
# seeds), x max(1, max|ref|): float32 rounding of the stacks, carried
# through 24 fed-back frames
ARTTS_SYNTH_TOL = 1e-4


def artts_config(dtype, layers=(6, 6), dropout=0.1, lnr_dropout=0.5,
                 post_dropout=0.5, param_dtype=None):
    """The LJSpeech recipe's ARTTSConfig (recipes/tts/ljspeech/exp_cfg/
    transformer_tts.yaml, as speechain_tpu/builders.py builds it): the 16
    kHz frontend, a global feature norm, r 2, the embedding and Conv1d
    prenet (3 x 512, kernel 5) at 512, the encoder d 512 / 8 heads / F
    2048 with posenc_scale, the decoder prenet [256, 256] whose width the
    decoder takes, the postnet 5 x 512 of kernel 5, L2 loss, stop weight 5
    and attention guidance sigma 0.2; dropout ``dropout`` in the
    transformers, ``lnr_dropout`` in the decoder prenet, ``post_dropout``
    in the postnet."""
    from speechain_tpu_torch.models.ar_tts import ARTTSConfig
    from speechain_tpu_torch.ops.feat_norm import FeatNormConfig
    from speechain_tpu_torch.ops.frontend import FrontendConfig
    stack = dict(posenc_dropout=dropout, posenc_scale=True, d_model=ARTTS_D,
                 num_heads=ARTTS_H, fdfwd_dim=ARTTS_F,
                 fdfwd_dropout=dropout, att_dropout=dropout,
                 res_dropout=dropout)
    return ARTTSConfig(
        vocab_size=ARTTS_V,
        frontend=FrontendConfig(sr=16000, n_mels=80, win_length=0.05,
                                hop_length=0.0125, fmin=125.0, fmax=7600.0),
        feat_norm=FeatNormConfig(feat_dim=80), reduction_factor=2,
        enc_emb=dict(embedding_dim=ARTTS_D),
        enc_prenet=dict(conv_dims=[ARTTS_D] * 3, conv_kernel=5, lnr_dims=-1),
        encoder=dict(stack, num_layers=layers[0]),
        dec_prenet=dict(lnr_dims=[ARTTS_W, ARTTS_W],
                        lnr_dropout=lnr_dropout),
        decoder=dict(stack, num_layers=layers[1]),
        postnet=dict(conv_dims=[512] * 5, conv_kernel=5,
                     conv_dropout=post_dropout),
        stop_pos_weight=5.0, feat_loss_type="L2", att_guid_sigma=0.2,
        dtype=dtype, param_dtype=param_dtype)


def build_artts(cfg, seed: int, stop_bias=None, fresh_norm=False):
    """ARTTSNet with seeded random weights; ``stop_bias`` sets the stop
    head's bias (far negative: no row stops before its cap);
    ``fresh_norm`` keeps the feature norm as a new model's, as
    ``build_tts_train`` does for training."""
    from speechain_tpu_torch.models.ar_tts import ARTTSNet
    from speechain_tpu_torch.utils.weights import random_state_dict
    net = ARTTSNet(cfg)
    sd = random_state_dict(net, seed)
    if stop_bias is not None:
        sd["stop_pred.bias"][:] = stop_bias
    if fresh_norm:
        sd.update({k: v for k, v in net.state_dict().items()
                   if ".stats." in k})
    net.load_state_dict(sd, strict=True)
    return net


def artts_text(n: int, seed: int):
    """n seeded texts of ARTTS_TOKENS tokens, as numpy (text, text_len)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(2, ARTTS_V, (n, ARTTS_TOKENS)).astype(np.int64),
            np.full((n,), ARTTS_TOKENS, np.int64))


def check_launches(launches: dict, want: dict, what: str) -> None:
    for name, count in launches.items():
        if count != want.get(name, 0):
            raise RuntimeError(f"{name}: {count} launches in {what}, "
                               f"predicted {want.get(name, 0)}")


def phase_artts_synth():
    """The recipe's Transformer-TTS (bf16, seeded random weights, the stop
    head off) through make_artts_synthesizer(net, "gl") on 16 x 100
    tokens: exactly ARTTS_STEPS decoder steps and ARTTS_SYNTH_LAUNCHES,
    1000 frames a row, Griffin-Lim at 32 iterations; wall ms of a call, of
    the autoregressive loop alone and of Griffin-Lim alone, ms a step,
    the postnet's recompute (once a step over the whole 16 x 501-frame
    buffer) timed alone, audio s per wall s, peak memory, and one profiled
    call."""
    import torch
    from speechain_tpu_torch.infer.tts import make_artts_synthesizer
    from speechain_tpu_torch.ops.griffin_lim import logmel_to_wave
    t0 = time.perf_counter()
    net = build_artts(artts_config(torch.bfloat16), seed=0, stop_bias=-1e4)
    n_params = sum(p.numel() for p in net.parameters())
    synth = make_artts_synthesizer(net, "gl", gl_iters=TTS_GL_ITERS)
    ar = make_artts_synthesizer(net)
    text, text_len = (torch.from_numpy(a).cuda()
                      for a in artts_text(ARTTS_SYNTH_B, 9))
    log(f"  Transformer-TTS {n_params / 1e6:.2f} M parameters (bf16), built "
        f"in {time.perf_counter() - t0:.1f} s; stop head bias -1e4")

    def gen():
        return torch.Generator().manual_seed(0)
    out = synth(text, text_len, generator=gen())            # warm-up
    torch.cuda.synchronize()
    reset_counts()
    held = held_mib()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = synth(text, text_len, generator=gen())
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    launches = entry_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"  launches in one synthesis call: "
        f"{json.dumps({k: v for k, v in launches.items() if v})}")
    check_launches(launches, ARTTS_SYNTH_LAUNCHES, "a Transformer-TTS call")
    F = ARTTS_TOKENS * 10 // 2 + 1
    feat, lens, wave = out["hypo_feat"], out["hypo_feat_len"], out["wave"]
    L = (2 * F - 1) * 200
    if out["steps"] != ARTTS_STEPS:
        raise RuntimeError(f"{out['steps']} decoder steps, predicted "
                           f"{ARTTS_STEPS}")
    if lens.tolist() != [2 * ARTTS_STEPS] * ARTTS_SYNTH_B:
        raise RuntimeError(f"frame lengths {lens.tolist()}")
    if (tuple(feat.shape) != (ARTTS_SYNTH_B, 2 * F, 80)
            or tuple(wave.shape) != (ARTTS_SYNTH_B, L)):
        raise RuntimeError(f"hypo_feat {tuple(feat.shape)}, wave "
                           f"{tuple(wave.shape)}")
    frame_max = feat.abs().amax(-1)                         # (B, 2F)
    if not (torch.isfinite(feat).all() and torch.isfinite(wave).all()):
        raise RuntimeError("non-finite features or waveform")
    if float(frame_max[:, 2 * ARTTS_STEPS:].max()) != 0.0 \
            or float(frame_max[:, :2 * ARTTS_STEPS].min()) == 0.0:
        raise RuntimeError("frames past the length not zero, or an "
                           "all-zero frame within it")
    if not torch.equal(out["wave_len"], torch.clamp(lens * 200, max=L)):
        raise RuntimeError("wave_len is not min(frames x hop, L)")

    call_ms = [first_ms] + wall_times(
        lambda: synth(text, text_len, generator=gen()), reps=1)
    ar_ms = wall_times(lambda: ar(text, text_len, generator=gen()), reps=1)
    mel = net.recover_feat(feat).float()
    with torch.inference_mode():
        gl_ms = wall_times(lambda: logmel_to_wave(
            mel, lens, net.cfg.frontend, n_iter=TTS_GL_ITERS), reps=3)
        buf = torch.randn(ARTTS_SYNTH_B, F, 160, device=DEV,
                          generator=torch.Generator(DEV).manual_seed(1))
        post_ms = cuda_time(lambda: net.apply_postnet(buf), reps=10)
    med = float(np.median(call_ms))
    ar_med = float(np.median(ar_ms))
    audio_s = ARTTS_SYNTH_B * 2 * ARTTS_STEPS * 0.0125
    post_share = post_ms * ARTTS_STEPS / ar_med
    log(f"  {ARTTS_SYNTH_B} x {ARTTS_TOKENS} tokens -> {ARTTS_STEPS} steps "
        f"-> {ARTTS_SYNTH_B} x {2 * ARTTS_STEPS} frames -> Griffin-Lim "
        f"({TTS_GL_ITERS} iterations): call {med:.1f} ms (mean of the "
        f"counted call and one more, {', '.join(f'{t:.1f}' for t in call_ms)}"
        f"), the loop alone {ar_med:.1f} ms "
        f"({ar_med / ARTTS_STEPS:.3f} ms a step), Griffin-Lim alone "
        f"{float(np.median(gl_ms)):.2f} ms, the postnet over the whole "
        f"buffer {post_ms:.4f} ms a step ({100 * post_share:.1f} % of the "
        f"loop at {ARTTS_STEPS} steps), {audio_s / med * 1e3:.1f} audio s "
        f"per wall s, peak memory {peak / 2**20:.1f} MiB ({held:.1f} held "
        f"before the call)")
    busy = profile_device(lambda: synth(text, text_len, generator=gen()),
                          med, "artts_synth", host=False)
    return dict(params=n_params, call_ms=med, call_ms_runs=call_ms,
                first_call_ms=first_ms, loop_ms=ar_med,
                ms_per_step=ar_med / ARTTS_STEPS, steps=out["steps"],
                gl_ms=float(np.median(gl_ms)), postnet_ms=post_ms,
                postnet_share=post_share,
                audio_s_per_wall_s=audio_s / med * 1e3,
                peak_mib=peak / 2**20, held_mib=held, launches=launches,
                device=busy)


def phase_artts_synth_vs_cpu():
    """float32 synthesis on the card and with device="cpu", 2 + 2 layers
    at full width, 2 utterances of 100 and 3 tokens, the prenet's dropout
    0.5 on both from the same generator seed, the stop head off and
    ``max_frames`` 24: the first row runs to 24 steps, the second to its
    cap, 15; lengths equal and the features within ARTTS_SYNTH_TOL of
    max(1, max|ref|). Control: the CPU run from another seed must differ
    by more, or the check could not see the dropout."""
    import torch
    from speechain_tpu_torch.infer.tts import make_artts_synthesizer
    text, text_len = artts_text(2, 13)
    text_len[1] = 3
    text[1, 3:] = 0
    res = {}
    for device, seed in (("cuda", 0), ("cpu", 0), ("cpu", 1)):
        net = build_artts(artts_config(torch.float32, layers=(2, 2)), seed=5,
                          stop_bias=-1e4)
        reset_counts()
        out = make_artts_synthesizer(net, device=device, max_frames=24)(
            torch.from_numpy(text), torch.from_numpy(text_len),
            generator=torch.Generator().manual_seed(seed))
        res[device, seed] = ({k: v.cpu() if torch.is_tensor(v) else v
                              for k, v in out.items()}, entry_counts())
    (g, launches), (c, _), (other, _) = (res["cuda", 0], res["cpu", 0],
                                        res["cpu", 1])
    check_launches(launches, {"ffn": 2 + 2 * 24, "flash_attention": 2},
                   "a float32 2 + 2-layer call")
    ref = max(1.0, float(c["hypo_feat"].abs().max()))
    err = float((g["hypo_feat"] - c["hypo_feat"]).abs().max())
    control = float((other["hypo_feat"] - c["hypo_feat"]).abs().max())
    same = torch.equal(g["hypo_feat_len"], c["hypo_feat_len"])
    log(f"  float32, 2 + 2 layers, 2 utterances ({text_len.tolist()} "
        f"tokens), prenet dropout 0.5: lengths card "
        f"{g['hypo_feat_len'].tolist()} cpu {c['hypo_feat_len'].tolist()}; "
        f"features max err {err:.3e} (tol {ARTTS_SYNTH_TOL * ref:.3e}); "
        f"control (CPU, another seed) {control:.3e}")
    if not same or c["hypo_feat_len"].tolist() != [48, 30]:
        raise RuntimeError("card and CPU lengths differ or are not 48, 30")
    if err > ARTTS_SYNTH_TOL * ref:
        raise RuntimeError(f"card and CPU features differ by {err}")
    if control <= ARTTS_SYNTH_TOL * ref:
        raise RuntimeError(f"the control ({control}) is within the "
                           "tolerance: the dropout does not show")
    return dict(lengths=c["hypo_feat_len"].tolist(), feat_err=err,
                tol_rel=ARTTS_SYNTH_TOL, control_err=control,
                launches=launches)


def artts_train_batch(n: int, seed: int, samples: int = ARTTS_SAMPLES):
    """n seeded utterances: waveforms of ``samples`` samples at 16 kHz (a
    few tones and noise) and ARTTS_TOKENS tokens, as torch CPU tensors."""
    import torch
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / 16000.0
    f0 = rng.uniform(100.0, 300.0, (n, 1))
    wave = (0.3 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(
        2 * np.pi * 3 * f0 * t) + 0.05 * rng.standard_normal(
            (n, samples))).astype(np.float32)
    text, text_len = artts_text(n, seed + 1)
    return dict(text=torch.from_numpy(text),
                text_len=torch.from_numpy(text_len),
                feat=torch.from_numpy(wave[..., None]),
                feat_len=torch.full((n,), samples, dtype=torch.int64))


def phase_artts_train():
    """The recipe's Transformer-TTS at full width and depth, bf16 compute
    on float32 master weights, 8 utterances of 120,000 samples and 100
    tokens through init_train_state / build_optimizer / make_artts_step:
    launches in one step (exactly ARTTS_TRAIN_LAUNCHES), ms a step (the
    mean of 10 after 4 warm-ups), mel frames/s, peak memory and one
    profiled step."""
    import torch
    from speechain_tpu_torch.train.optim import build_optimizer
    from speechain_tpu_torch.train.state import (init_train_state,
                                                 make_artts_step)
    t0 = time.perf_counter()
    cfg = artts_config(torch.bfloat16, param_dtype=torch.float32)
    net = build_artts(cfg, seed=0, fresh_norm=True)
    n_params = sum(p.numel() for p in net.parameters())
    tx = build_optimizer(**ARTTS_OPT)
    state = init_train_state(net, tx, device=DEV)
    step = make_artts_step(net, cfg, tx, device=DEV)
    batch = artts_train_batch(ARTTS_B, seed=31)
    gen = torch.Generator().manual_seed(0)
    log(f"  Transformer-TTS (recipe): {n_params / 1e6:.2f} M parameters, "
        f"built in {time.perf_counter() - t0:.1f} s")
    for _ in range(4):                              # warm-up
        state, m = step(state, batch, gen)
    torch.cuda.synchronize()
    reset_counts()                                  # the counted step
    state, m = step(state, batch, gen)
    torch.cuda.synchronize()
    launches = entry_counts()
    log(f"  launches in one step: "
        f"{json.dumps({k: v for k, v in launches.items() if v})}")
    check_launches(launches, ARTTS_TRAIN_LAUNCHES, "a Transformer-TTS step")

    held = held_mib()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        state, m = step(state, batch, gen)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / 10
    peak = torch.cuda.max_memory_allocated()
    metrics = {k: float(v) for k, v in m.items()}
    if not all(np.isfinite(v) for v in metrics.values()) \
            or "att_guid_loss" not in metrics:
        raise RuntimeError(f"training metrics {metrics}")
    n_frames = ARTTS_SAMPLES // 200 + 1
    frames = ARTTS_B * n_frames / (step_ms / 1e3)
    log(f"  {ARTTS_B} x {n_frames} frames ({ARTTS_DEC_T} decoder positions), "
        f"{ARTTS_TOKENS} tokens: {step_ms:.2f} ms/step, {frames:.0f} "
        f"mel-frames/s, peak memory {peak / 2**20:.1f} MiB ({held:.1f} held "
        f"before the steps), metrics {json.dumps(metrics)}")
    busy = profile_device(lambda: step(state, batch, gen), step_ms,
                          "train_artts")
    return dict(params=n_params, step_ms=step_ms, mel_frames_per_s=frames,
                peak_mib=peak / 2**20, held_mib=held, launches=launches,
                metrics=metrics, device=busy), (net, cfg, batch, gen)


def phase_artts_train_vs_cpu():
    """Three float32 Transformer-TTS steps at dropout 0, 2 + 2 layers at
    full width, 2 utterances (120,000 and 80,000 samples, the second with
    a padded tail, and 100 and 70 tokens), on the card and on the CPU: as
    phase 17, every step's loss within 1e-4 relative, the parameters and
    running statistics after the 3 steps within 1e-4 of each array's
    largest magnitude, and each parameter's Adam first moment (the
    gradients) within 1e-3 of its largest magnitude (or 1e-6 of the
    largest moment)."""
    import torch
    from speechain_tpu_torch.train.optim import build_optimizer
    from speechain_tpu_torch.train.state import (init_train_state,
                                                 make_artts_step)
    batch = artts_train_batch(2, seed=33)
    short = 2 * ARTTS_SAMPLES // 3
    batch["feat_len"][1] = short
    batch["feat"][1, short:] = 0.0
    batch["text_len"][1] = ARTTS_TOKENS - 30
    batch["text"][1, ARTTS_TOKENS - 30:] = 0
    cfg = artts_config(torch.float32, layers=(2, 2), dropout=0.0,
                       lnr_dropout=0.0, post_dropout=0.0)
    res = {}
    for side, dev in (("card", DEV), ("cpu", "cpu")):
        net = build_artts(cfg, seed=4, fresh_norm=True)
        start = {n: p.detach().clone() for n, p in net.named_parameters()}
        tx = build_optimizer(**ARTTS_OPT)
        state = init_train_state(net, tx, device=dev)
        step = make_artts_step(net, cfg, tx, device=dev)
        gen = torch.Generator().manual_seed(0)
        reset_counts()
        losses = []
        for _ in range(3):
            state, m = step(state, batch, gen)
            losses.append(float(m["loss"]))
        res[side] = dict(losses=losses, launches=entry_counts(),
                         arrays=tts_state_arrays(net),
                         moments=tts_first_moments(state))
        if side == "card":
            moved = sum(not torch.equal(res[side]["arrays"][n], p.cpu())
                        for n, p in start.items())
    c, h = res["card"], res["cpu"]
    check_launches(c["launches"], {"ffn": 3 * 4, "ffn_backward": 3 * 4,
                                   "flash_attention": 3 * 5,
                                   "flash_attention_backward": 3 * 5},
                   "3 float32 2 + 2-layer steps")
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(c["losses"], h["losses"]))
    worst, failed = 0.0, []
    for n, want_a in h["arrays"].items():
        err = float((c["arrays"][n] - want_a).abs().max())
        scale = max(float(want_a.abs().max()), 1e-6)
        worst = max(worst, err / scale)
        if err > 1e-4 * scale:
            failed.append(f"{n}: card vs CPU {err} > {1e-4 * scale}")
    mscale = max(float(m.abs().max()) for m in h["moments"].values())
    used, used_name = 0.0, ""
    for n, want_m in h["moments"].items():
        err = float((c["moments"][n] - want_m).abs().max())
        tol = max(1e-3 * float(want_m.abs().max()), 1e-6 * mscale)
        if err / tol > used:
            used, used_name = err / tol, n
        if err > tol:
            failed.append(f"first moment {n}: card vs CPU {err} > {tol}")
    n_params = len(h["moments"])
    if mscale == 0 or moved < n_params // 2:
        failed.append(f"{moved} of {n_params} parameters moved")
    if loss_rel > 1e-4:
        failed.append(f"card and CPU losses differ by {loss_rel}")
    log(f"  float32, 2 + 2 layers, 2 utterances ({ARTTS_SAMPLES // 200 + 1} "
        f"and {short // 200 + 1} frames): "
        f"losses card {', '.join(f'{x:.6f}' for x in c['losses'])} cpu "
        f"{', '.join(f'{x:.6f}' for x in h['losses'])} (worst rel "
        f"{loss_rel:.2e}); {len(h['arrays'])} parameters and statistics "
        f"within {worst:.2e} of their max; first moments at most "
        f"{used:.2f} of their tolerance ({used_name}); {moved} of "
        f"{n_params} parameters moved; launches "
        f"{json.dumps({k: v for k, v in c['launches'].items() if v})}")
    if failed:
        raise RuntimeError("; ".join(failed[:8]))
    return dict(losses_card=c["losses"], losses_cpu=h["losses"],
                loss_rel=loss_rel, worst_rel=worst, moment_tol_used=used,
                moment_tol_used_by=used_name, moved=moved,
                arrays=len(h["arrays"]), launches=c["launches"])


# ----------------------------------------------------- phases 23 to 25

# speaker embeddings, multi-speaker synthesis and its evaluation: the
# LibriTTS recipe (recipes/tts/libritts/exp_cfg/fastspeech2_multispk.yaml)
# at 16 kHz, 16 reference utterances of 3-10 s
SPK_B, SPK_SR = 16, 16000
SPK_TOL = 1e-4            # card vs CPU float32 embeddings, absolute
NORM_TOL = 1e-5           # |1 - ||embedding|||
EVAL_TOL_REL = 1e-3       # card vs CPU scores, relative
# the recipe's synthesis: 4 + 4 layers with 2 heads of 192 on the flash
# kernel (its FFN is 'conv', two convolutions); Griffin-Lim at n_fft 800
MULTISPK_LAUNCHES = {"flash_attention": 8}
MULTISPK_HOP = 200


def reference_waves(n: int, seed: int):
    """``n`` seeded waveforms of 3-10 s at SPK_SR: three harmonics of a
    wandering F0 (90-250 Hz), noise under them, and pauses."""
    rng = np.random.default_rng(seed)
    waves = []
    for _ in range(n):
        m = int(rng.uniform(3.0, 10.0) * SPK_SR)
        t = np.arange(m) / SPK_SR
        f0 = rng.uniform(90.0, 250.0) * (1.0 + 0.2 * np.sin(
            2 * np.pi * rng.uniform(0.2, 1.0) * t))
        ph = 2 * np.pi * np.cumsum(f0) / SPK_SR
        w = (0.3 * np.sin(ph) + 0.15 * np.sin(2 * ph)
             + 0.05 * np.sin(3 * ph)) * (np.sin(
                 2 * np.pi * rng.uniform(0.5, 1.5) * t) > -0.6)
        waves.append((w + 0.02 * rng.standard_normal(m)).astype(np.float32))
    return waves


def write_idx2wav(folder: Path, waves, sr: int) -> str:
    """One 16-bit .wav a waveform and an idx2wav listing them."""
    from speechain_tpu_torch.utils.fileio import write_idx2data_file, write_wav
    paths = {}
    for i, w in enumerate(waves):
        paths[f"utt{i:02d}"] = str(folder / f"utt{i:02d}.wav")
        write_wav(paths[f"utt{i:02d}"], w, sr)
    write_idx2data_file(paths, str(folder / "idx2wav"))
    return str(folder / "idx2wav")


def phase_spk_embed(work: Path):
    """16 references through spk_feat_extractor's main on the card (ECAPA
    with seeded random weights saved as a .pt, the log-Mel kernel at n_fft
    400): launches exactly logmel 16, wall and busy ms of the call, the
    log-Mel kernel's launches and device ms; every embedding of unit norm
    within NORM_TOL and within SPK_TOL of the same call with ``--device
    cpu``; x-vector once, as ECAPA; add_delta_features on the card
    against the CPU (1e-5 of max(1, max|ref|)). Returns the record and
    (references, idx2wav, card embeddings)."""
    import torch
    from speechain_tpu_torch.nn.speaker import EncoderClassifier
    from speechain_tpu_torch.ops.delta import add_delta_features
    from speechain_tpu_torch.ops.frontend import (FrontendConfig,
                                                  LogMelFrontend)
    from speechain_tpu_torch.pyscripts import spk_feat_extractor
    from speechain_tpu_torch.utils.fileio import read_idx2data_file
    from speechain_tpu_torch.utils.weights import random_state_dict
    refs = reference_waves(SPK_B, 23)
    idx2wav = write_idx2wav(work / "refer", refs, SPK_SR)
    ckpts = {}
    for model_type, seed in (("ecapa", 23), ("xvector", 24)):
        ckpts[model_type] = str(work / f"{model_type}.pt")
        torch.save(random_state_dict(EncoderClassifier(model_type), seed),
                   ckpts[model_type])

    def extract(model_type, device):
        out = work / f"spk_{model_type}_{device}"
        spk_feat_extractor.main([
            "--wav_path", idx2wav, "--save_path", str(out), "--spk_model",
            model_type, "--checkpoint", ckpts[model_type], "--device",
            device])
        idx2feat = read_idx2data_file(str(out / "idx2spk_feat"))
        if list(idx2feat) != list(read_idx2data_file(idx2wav)):
            raise RuntimeError(f"{model_type} {device}: idx2spk_feat keys "
                               f"{list(idx2feat)}")
        return np.stack([np.load(p) for p in idx2feat.values()])

    extract("ecapa", DEV)                                   # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    emb = extract("ecapa", DEV)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    launches = entry_counts()
    check_launches(launches, {"logmel": SPK_B}, "speaker extraction")
    secs = sum(len(w) for w in refs) / SPK_SR
    log(f"  {SPK_B} references ({secs:.1f} s of audio, "
        f"{min(len(w) for w in refs) / SPK_SR:.2f}..."
        f"{max(len(w) for w in refs) / SPK_SR:.2f} s) -> ECAPA: "
        f"{wall_ms:.1f} ms wall for the call (reading the .wav files and "
        f"writing the .npy files included); launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}")
    busy = profile_device(lambda: extract("ecapa", DEV), wall_ms,
                          "spk_embed")
    log(f"  row 1 (logmel) launches in the call: {launches['logmel']}")
    log(f"  row 1 (logmel) device ms in the call: "
        f"{busy['ported_ms'].get('logmel', 0.0):.4f}")
    res = dict(wall_ms=wall_ms, audio_s=secs, launches=launches,
               device=busy)
    for model_type, card in (("ecapa", emb),
                             ("xvector", extract("xvector", DEV))):
        cpu = extract(model_type, "cpu")
        norm_err = float(np.abs(np.linalg.norm(card, axis=1) - 1.0).max())
        err = float(np.abs(card - cpu).max())
        cos = card @ card.T
        log(f"  {model_type}: embeddings {card.shape}, max | |e| - 1 | "
            f"{norm_err:.2e} (tol {NORM_TOL:g}), card vs CPU max err "
            f"{err:.3e} (tol {SPK_TOL:g}); cosine between references "
            f"{cos[~np.eye(SPK_B, dtype=bool)].min():.4f}.."
            f"{cos[~np.eye(SPK_B, dtype=bool)].max():.4f}")
        if card.shape != (SPK_B, 192) or not np.isfinite(card).all():
            raise RuntimeError(f"{model_type}: embeddings {card.shape}")
        if norm_err > NORM_TOL or err > SPK_TOL:
            raise RuntimeError(f"{model_type}: norm error {norm_err}, card "
                               f"vs CPU {err}")
        res[model_type] = dict(norm_err=norm_err, vs_cpu_err=err)

    fe = LogMelFrontend(FrontendConfig(sr=SPK_SR, n_mels=80))
    w = torch.from_numpy(refs[0][None])
    feat, feat_len = fe(w.to(DEV), torch.tensor([w.shape[1]], device=DEV))
    got = add_delta_features(feat, feat_len)[0].cpu()
    want = add_delta_features(feat.cpu(), feat_len.cpu())[0]
    derr = float((got - want).abs().max())
    dtol = 1e-5 * max(1.0, float(want.abs().max()))
    log(f"  add_delta_features (order 2, N 2) on {tuple(feat.shape)} -> "
        f"{tuple(got.shape)}: card vs CPU {derr:.3e} (tol {dtol:.1e})")
    if got.shape != (1, feat.shape[1], 240) or derr > dtol:
        raise RuntimeError(f"add_delta_features: {tuple(got.shape)}, "
                           f"error {derr}")
    res["delta_err"] = derr
    return res, (refs, idx2wav, emb)


def libritts_config(dtype, layers=(4, 4)):
    """recipes/tts/libritts/exp_cfg/fastspeech2_multispk.yaml's
    FastSpeech2Config as synthesis uses it: d 384, 2 heads of 192, F 1536
    'conv' (kernel 9, ReLU), variance predictors [256, 256] kernel 3,
    postnet 5 x 256 kernel 5, 192-d pretrained speaker embeddings
    concatenated onto the encoder output, global feature, pitch and
    energy norms, the 16 kHz frontend (800 / 200, fmin 125, fmax 7600,
    energy); dropout 0 (evaluation mode runs none)."""
    from speechain_tpu_torch.models.nar_tts import FastSpeech2Config
    from speechain_tpu_torch.ops.feat_norm import FeatNormConfig
    from speechain_tpu_torch.ops.frontend import FrontendConfig
    layer = dict(d_model=TTS_D, num_heads=2, fdfwd_dim=TTS_F,
                 fdfwd_type="conv", fdfwd_activation="ReLU",
                 fdfwd_args={"kernel_size": 9})
    pred = dict(conv_dims=[256, 256], conv_kernel=3, conv_dropout=0.0)
    return FastSpeech2Config(
        vocab_size=TTS_V,
        frontend=FrontendConfig(sr=SPK_SR, n_mels=80, win_length=0.05,
                                hop_length=0.0125, fmin=125.0, fmax=7600.0,
                                return_energy=True),
        feat_norm=FeatNormConfig(feat_dim=80),
        pitch_norm=FeatNormConfig(feat_dim=1),
        energy_norm=FeatNormConfig(feat_dim=1),
        enc_emb=dict(embedding_dim=TTS_D),
        encoder=dict(layer, num_layers=layers[0]),
        decoder=dict(layer, num_layers=layers[1]),
        duration_predictor=pred, pitch_predictor=pred, energy_predictor=pred,
        postnet=dict(conv_dims=[256] * 5, conv_kernel=5, conv_dropout=0.0),
        spk_emb=dict(spk_emb_dim_pretrained=192, spk_emb_comb="concat"),
        max_frame_len=TTS_FRAMES, dtype=dtype)


def build_multispk(dtype, seed: int, feat_stats, layers=(4, 4)):
    """Multi-speaker FastSpeech2 with seeded random weights, the duration
    head as phase 14's (about 6 frames a token), and the feature norm
    holding ``feat_stats``, the references' log-Mel mean and std, as a
    model trained on them would. The feature head's and the postnet's
    last BatchNorm's weights and biases are a tenth of their draws: the
    normalized prediction then stays within a few tenths of 0, so the
    recovered mel keeps near the references' level and Griffin-Lim's
    waves near [-1, 1], where a .wav keeps them."""
    from speechain_tpu_torch.models.nar_tts import FastSpeech2Net
    from speechain_tpu_torch.utils.weights import random_state_dict
    net = FastSpeech2Net(libritts_config(dtype, layers))
    sd = random_state_dict(net, seed)
    sd["duration_predictor.pred_head.bias"][:] = float(np.log(7.0))
    sd["duration_predictor.pred_head.weight"] *= 0.1
    for name in ("feat_pred.weight", "feat_pred.bias",
                 "postnet.batchnorm_4.weight", "postnet.batchnorm_4.bias"):
        sd[name] *= 0.1
    sd["feat_norm.stats.mean"][:] = feat_stats[0]
    sd["feat_norm.stats.std"][:] = feat_stats[1]
    net.load_state_dict(sd, strict=True)
    return net.eval()


def reference_feat_stats(refs):
    """Per-bin mean and std of the references' log-Mel at the recipe's
    frontend (the plain pipeline on the CPU)."""
    import torch
    from speechain_tpu_torch.ops.frontend import frontend_impl
    cfg = libritts_config(torch.float32).frontend
    frames = []
    for w in refs:
        feat, feat_len, _, _ = frontend_impl(
            torch.from_numpy(w[None]), torch.tensor([len(w)]), cfg)
        frames.append(feat[0, : int(feat_len[0])])
    frames = torch.cat(frames)
    return frames.mean(0), frames.std(0)


def phase_multispk(work: Path, refs, emb):
    """The LibriTTS recipe's FastSpeech2 at full width and depth (bf16),
    conditioned on phase 23's ECAPA embeddings, 16 x 100 tokens through
    make_fastspeech2_synthesizer(net, "gl") (32 iterations, n_fft 800):
    launches exactly MULTISPK_LAUNCHES, wall ms (median of 5), busy ms and
    idle share (one profiled call), audio s per wall s; the waves written
    as .wav files for phase 25. Then float32 at 2 + 2 layers on 2
    utterances, card against CPU from the same Griffin-Lim phases:
    durations equal, mel within 1e-4 and the wave within GL_WAVE_TOL_32 of
    max|ref| (phase 18's limits). Returns the record and the idx2wav of
    the synthesized waves."""
    import torch
    from speechain_tpu_torch.infer.tts import make_fastspeech2_synthesizer
    stats = reference_feat_stats(refs)
    t0 = time.perf_counter()
    net = build_multispk(torch.bfloat16, 24, stats)
    synth = make_fastspeech2_synthesizer(net, "gl", max_frames=TTS_FRAMES,
                                         gl_iters=TTS_GL_ITERS)
    text, text_len = (torch.from_numpy(a).to(DEV)
                      for a in tts_text(SPK_B, 25))
    spk = torch.from_numpy(emb).to(DEV)
    n_params = sum(p.numel() for p in net.parameters())
    log(f"  FastSpeech2 (LibriTTS recipe, speaker embeddings concatenated) "
        f"{n_params / 1e6:.2f} M parameters (bf16), built in "
        f"{time.perf_counter() - t0:.1f} s")
    for _ in range(2):
        out = synth(text, text_len, spk_feat=spk)          # warm-up
    torch.cuda.synchronize()
    reset_counts()
    out = synth(text, text_len, spk_feat=spk)
    torch.cuda.synchronize()
    launches = entry_counts()
    check_launches(launches, MULTISPK_LAUNCHES, "a multi-speaker synthesis "
                   "call")
    L = (TTS_FRAMES - 1) * MULTISPK_HOP
    wave, wave_len = out["wave"], out["wave_len"]
    lens = out["hypo_feat_len"]
    if tuple(wave.shape) != (SPK_B, L) or not torch.isfinite(wave).all():
        raise RuntimeError(f"wave shape {tuple(wave.shape)} or non-finite "
                           "samples")
    if not torch.equal(wave_len, torch.clamp(lens * MULTISPK_HOP, max=L)):
        raise RuntimeError("wave_len is not min(frames x hop, L)")
    if int(lens.min()) < 1:
        raise RuntimeError(f"empty synthesis: frames {lens.tolist()}")
    call_ms = wall_times(lambda: synth(text, text_len, spk_feat=spk))
    med = float(np.median(call_ms))
    audio_s = float(wave_len.sum()) / SPK_SR
    peak = float(wave.abs().max())
    log(f"  {SPK_B} x {TTS_TOKENS} tokens -> {lens.tolist()} frames -> "
        f"Griffin-Lim ({TTS_GL_ITERS} iterations, n_fft 800) -> "
        f"{audio_s:.1f} s of audio (max |sample| {peak:.3f}): call "
        f"{med:.2f} ms (median of {', '.join(f'{t:.2f}' for t in call_ms)})"
        f", {audio_s / med * 1e3:.1f} audio s per wall s; launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}")
    busy = profile_device(lambda: synth(text, text_len, spk_feat=spk), med,
                          "multispk_gl")
    hyps = [wave[i, : int(wave_len[i])].float().cpu().numpy()
            for i in range(SPK_B)]
    idx2wav = write_idx2wav(work / "hypo", hyps, SPK_SR)

    text2, text_len2 = tts_text(2, 26)
    text_len2[1] = TTS_TOKENS - 20
    text2[1, TTS_TOKENS - 20:] = 0
    phases = torch.rand((2, TTS_FRAMES, 401),
                        generator=torch.Generator().manual_seed(27))
    res = {}
    for device in (DEV, "cpu"):
        net32 = build_multispk(torch.float32, 28, stats, layers=(2, 2))
        got = make_fastspeech2_synthesizer(
            net32, "gl", device=device, max_frames=TTS_FRAMES,
            gl_iters=TTS_GL_ITERS)(torch.from_numpy(text2),
                                   torch.from_numpy(text_len2),
                                   spk_feat=torch.from_numpy(emb[:2]),
                                   gl_phases=phases)
        res[device] = {k: v.cpu() for k, v in got.items()}
    g, c = res[DEV], res["cpu"]
    same_dur = torch.equal(g["used_duration"], c["used_duration"])
    mel_err = float((g["hypo_feat"] - c["hypo_feat"]).abs().max())
    mel_ref = max(1.0, float(c["hypo_feat"].abs().max()))
    wave_err = float((g["wave"] - c["wave"]).abs().max())
    wave_ref = float(c["wave"].abs().max())
    log(f"  float32, 2 + 2 layers, 2 utterances ({text_len2.tolist()} "
        f"tokens, {c['hypo_feat_len'].tolist()} frames), the same initial "
        f"phases: durations equal {same_dur}; mel max err {mel_err:.3e} "
        f"(tol {1e-4 * mel_ref:.3e}); wave max err {wave_err:.3e} (tol "
        f"{GL_WAVE_TOL_32 * wave_ref:.3e}, max|ref| {wave_ref:.3e})")
    if not (same_dur and torch.equal(g["wave_len"], c["wave_len"])):
        raise RuntimeError("card and CPU durations differ")
    if mel_err > 1e-4 * mel_ref:
        raise RuntimeError(f"card and CPU mel differ by {mel_err}")
    if wave_err > GL_WAVE_TOL_32 * wave_ref:
        raise RuntimeError(f"card and CPU waveforms differ by {wave_err}")
    return dict(call_ms=med, call_ms_runs=call_ms, audio_s=audio_s,
                audio_s_per_wall_s=audio_s / med * 1e3, launches=launches,
                frame_len=lens.tolist(), params=n_params, max_abs=peak,
                device=busy, vs_cpu=dict(durations_equal=same_dur,
                                         mel_err=mel_err, wave_err=wave_err,
                                         wave_ref=wave_ref)), idx2wav


class HostTimer:
    """Wall seconds spent in ``module.name`` while the context is open
    (the evaluation's DTW and pitch tracker, numpy on the host)."""

    def __init__(self, module, name: str):
        self.module, self.name, self.seconds = module, name, 0.0

    def __enter__(self):
        fn = self.orig = getattr(self.module, self.name)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds += time.perf_counter() - t0
        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def phase_tts_eval(work: Path, refer: str, hypo: str):
    """spk_sim_evaluation (ECAPA on phase 24's synthesized against phase
    23's reference waves) and tts_evaluation (MCD, MSD, log-F0 RMSE) on
    the card and with ``--device cpu``: every utterance scored by every
    metric; launches exactly logmel 2 x 16 and 4 x 16 (the log-Mel of
    each side for MCD and for MSD); each card score within EVAL_TOL_REL
    of the CPU's; wall seconds of each call and the host seconds in DTW
    and in pitch tracking."""
    from speechain_tpu_torch.pyscripts import (spk_sim_evaluation,
                                               tts_evaluation)
    from speechain_tpu_torch.utils import tts_eval, world_pitch
    import torch
    ckpt = str(work / "ecapa.pt")
    scores, res = {}, {}
    for device in (DEV, "cpu"):
        reset_counts()
        t0 = time.perf_counter()
        sim = spk_sim_evaluation.main([
            "--hypo_path", hypo, "--refer_path", refer, "--checkpoint",
            ckpt, "--result_path", str(work / f"sim_{device}"), "--device",
            device])
        torch.cuda.synchronize()
        sim_s = time.perf_counter() - t0
        sim_launches = entry_counts()
        t0 = time.perf_counter()
        with HostTimer(tts_eval, "dtw_path") as dtw, \
                HostTimer(world_pitch, "convert_wav_to_pitch") as pitch:
            ev = tts_evaluation.main([
                "--hypo_path", hypo, "--refer_path", refer, "--result_path",
                str(work / f"eval_{device}"), "--device", device])
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        launches = {k: v - sim_launches[k] for k, v in entry_counts().items()}
        scores[device] = dict(ev, ecapa_spk_sim=sim)
        res[device] = dict(spk_sim_s=sim_s, tts_eval_s=eval_s,
                           dtw_s=dtw.seconds, pitch_s=pitch.seconds,
                           launches_spk_sim=sim_launches,
                           launches_tts_eval=launches)
        log(f"  {device}: spk_sim_evaluation {sim_s:.2f} s, tts_evaluation "
            f"{eval_s:.2f} s (host: DTW {dtw.seconds:.2f} s, pitch "
            f"tracking {pitch.seconds:.2f} s); means "
            + ", ".join(f"{m} {np.mean(list(v.values())):.4f}"
                        for m, v in scores[device].items()))
        if device == DEV:
            check_launches(sim_launches, {"logmel": 2 * SPK_B},
                           "spk_sim_evaluation")
            check_launches(launches, {"logmel": 4 * SPK_B},
                           "tts_evaluation")
    worst = {}
    for metric, cpu in scores["cpu"].items():
        card = scores[DEV][metric]
        if len(card) != SPK_B or len(cpu) != SPK_B:
            raise RuntimeError(f"{metric}: {len(card)} utterances scored "
                               f"on the card, {len(cpu)} on the CPU, of "
                               f"{SPK_B}")
        worst[metric] = max(abs(card[k] - cpu[k]) / abs(cpu[k])
                            for k in cpu)
    log("  card vs CPU, worst relative difference: "
        + ", ".join(f"{m} {v:.2e}" for m, v in worst.items())
        + f" (tol {EVAL_TOL_REL:g})")
    bad = {m: v for m, v in worst.items() if not v <= EVAL_TOL_REL}
    if bad:
        raise RuntimeError(f"card and CPU scores differ: {bad}")
    return dict(card=res[DEV], cpu=res["cpu"], worst_rel=worst,
                means={m: float(np.mean(list(v.values())))
                       for m, v in scores[DEV].items()},
                launches=res[DEV]["launches_tts_eval"])


PHASES = ("2", "2b", "2c", "2d", "2e", "3", "4", "5", "6", "7", "8", "9",
          "10", "11", "12", "13", "14", "15", "16", "17", "18", "19", "20",
          "21", "22", "23", "24", "25")


def main(argv=None) -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated phases to run (phase 1 always "
                    "runs; phases 6, 9 and 12's learning check follow 5, 8 "
                    "and 12); a partial run prints no result lines")
    ap.add_argument("--logmel-ab", action="store_true",
                    help="only time the log-Mel kernel at every case "
                    "(logmel_ab) and print the device ms as one JSON line; "
                    "no result lines")
    args = ap.parse_args(argv)
    want = set(args.phases.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if args.logmel_ab:
        from speechain_tpu_torch.utils.device import set_fp32_matmul_exact
        set_fp32_matmul_exact()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        print(json.dumps({"card": smi, "logmel_device_ms": logmel_ab()}),
              flush=True)
        return 0
    from speechain_tpu_torch.ops import entry_points
    from speechain_tpu_torch.utils.device import set_fp32_matmul_exact
    set_fp32_matmul_exact()
    t_start = time.perf_counter()
    (OUT_DIR / "log.txt").unlink(missing_ok=True)
    res = {}
    log("== phase 1: identity and build")
    smi = phase_identity_and_build()
    records = {}
    if "2" in want:
        log("== phase 2: kernels against their plain versions")
        records = check_kernels()
        check_ragged_shapes()
        records["relpos_attention"] += check_long_relpos()
    if "2b" in want:
        log("== phase 2b: training kernels against their plain versions")
        train_records, ffn_train_fwd = check_training_kernels()
        records.update(train_records)
        records["ffn"] = records.get("ffn", []) + ffn_train_fwd
        res["ffn_kernels"] = check_ffn_instances()
    if "2c" in want:
        log("== phase 2c: conformer training kernels against their plain "
            "versions")
        conf_records = check_conformer_kernels()
        records["relpos_attention"] = (conf_records["relpos_attention"]
                                       + records.get("relpos_attention", []))
        records["ffn_backward"] = (records.get("ffn_backward", [])
                                   + conf_records["ffn_backward"])
        records["ffn"] = records.get("ffn", []) + conf_records["ffn"]
        records["relpos_attention_backward"] = \
            conf_records["relpos_attention_backward"]
        records["convmod_backward"] = conf_records["convmod_backward"]
        res["conformer_tc"] = check_conformer_tc(records)
    if "2d" in want:
        log("== phase 2d: the opt-in routes' kernels (LayerNorm, prenet "
            "core) against their plain versions")
        fused_records, res["layer_norm_sweep"] = check_fused_route_kernels()
        records.update(fused_records)
    if "2e" in want:
        log("== phase 2e: attention at every head width against the plain "
            "versions")
        from speechain_tpu_torch.ops import kernels
        width_records, res["ptxas"] = check_head_widths(
            [k.build_log for k in kernels()])
        for name, calls in width_records.items():
            records[name] = records.get(name, []) + calls
    if "3" in want:
        log("== phase 3: conformer-small beam-16 decoding on the card")
        res["path"] = phase_path()
    if "4" in want:
        log("== phase 4: the decode path against the CPU")
        res["path_vs_cpu"] = phase_path_vs_cpu()
    if "5" in want:
        log("== phase 5: transformer-wide training steps on the card")
        res["train"], (net, cfg, batch, gen) = phase_train_path(
            "transformer-wide", transformer_wide_config(
                torch.bfloat16, param_dtype=torch.float32), RECIPE_OPT,
            TW_V, TRAIN_PATH_LAUNCHES, "train")
        log("== phase 6: learning on one repeated batch")
        res["learning"] = phase_learning(net, cfg, batch, gen)
        del net
    if "7" in want:
        log("== phase 7: training on the card against the CPU")
        res["train_vs_cpu"] = phase_train_vs_cpu(
            transformer_wide_config(torch.float32, layers=(2, 2),
                                    dropout=0.0, specaug=False),
            RECIPE_OPT, TW_V)
    if "8" in want:
        log("== phase 8: conformer-small training steps on the card")
        res["conformer_train"], (net, cfg, batch, gen) = phase_train_path(
            "conformer-small", conformer_small_train_config(
                torch.bfloat16, param_dtype=torch.float32), CONFORMER_OPT,
            V, CONFORMER_TRAIN_LAUNCHES, "train_conformer")
        log("== phase 9: conformer learning on one repeated batch")
        res["conformer_learning"] = phase_learning(net, cfg, batch, gen)
        del net
    if "10" in want:
        log("== phase 10: conformer training on the card against the CPU")
        res["conformer_train_vs_cpu"] = phase_train_vs_cpu(
            conformer_small_train_config(torch.float32, layers=(2, 2),
                                         dropout=0.0, specaug=False),
            CONFORMER_OPT, V)
    if "11" in want:
        log("== phase 11: conformer-small beam-16 decoding with the "
            "LayerNorm and fused prenet routes on")
        res["fused_path"] = phase_path(FUSED_ROUTES, "decode_fused")
        res["fused_path_vs_cpu"] = phase_path_vs_cpu(FUSED_ROUTES)
    if "12" in want:
        log("== phase 12: conformer-small training with the LayerNorm and "
            "fused prenet routes on")
        res["fused_train"], (net, cfg, batch, gen) = phase_train_path(
            "conformer-small, fused routes", conformer_small_train_config(
                torch.bfloat16, param_dtype=torch.float32,
                routes=FUSED_ROUTES), CONFORMER_OPT, V,
            FUSED_TRAIN_LAUNCHES, "train_fused")
        log("== phase 12: learning on one repeated batch, fused routes")
        res["fused_learning"] = phase_learning(net, cfg, batch, gen)
        del net
    if "13" in want:
        log("== phase 13: fused-route training on the card against the CPU")
        res["fused_train_vs_cpu"] = phase_train_vs_cpu(
            conformer_small_train_config(torch.float32, layers=(2, 2),
                                         dropout=0.0, specaug=False,
                                         routes=FUSED_ROUTES),
            CONFORMER_OPT, V, samples=FUSED_CHECK_SAMPLES,
            tokens=TW_TEXT + 1)
    if "14" in want:
        log("== phase 14: FastSpeech2 + HiFi-GAN synthesis on the card")
        res["tts"], ffn_tts = phase_tts_path()
        records["ffn"] = records.get("ffn", []) + ffn_tts
    if "15" in want:
        log("== phase 15: synthesis on the card against the CPU")
        res["tts_vs_cpu"] = phase_tts_vs_cpu()
    if "16" in want:
        from speechain_tpu_torch.train.state import make_fastspeech2_step
        log("== phase 16: FastSpeech2 training steps on the card (the "
            "LJSpeech recipe)")
        res["tts_train"], (net, cfg, batch, gen) = phase_tts_train()
        log("== phase 16: FastSpeech2 learning on one repeated batch")
        res["tts_learning"] = phase_learning(net, cfg, batch, gen,
                                             make_fastspeech2_step)
        del net
    if "17" in want:
        log("== phase 17: FastSpeech2 training on the card against the CPU")
        res["tts_train_vs_cpu"] = phase_tts_train_vs_cpu()
    if "18" in want:
        log("== phase 18: Griffin-Lim synthesis on the card")
        res["tts_gl"] = phase_gl()
    if "19" in want:
        log("== phase 19: Transformer-TTS synthesis through Griffin-Lim on "
            "the card")
        res["artts_synth"] = phase_artts_synth()
    if "20" in want:
        log("== phase 20: Transformer-TTS synthesis on the card against the "
            "CPU")
        res["artts_synth_vs_cpu"] = phase_artts_synth_vs_cpu()
    if "21" in want:
        from speechain_tpu_torch.train.state import make_artts_step
        log("== phase 21: Transformer-TTS training steps on the card (the "
            "LJSpeech recipe)")
        res["artts_train"], (net, cfg, batch, gen) = phase_artts_train()
        log("== phase 21: Transformer-TTS learning on one repeated batch")
        res["artts_learning"] = phase_learning(net, cfg, batch, gen,
                                               make_artts_step)
        del net
    if "22" in want:
        log("== phase 22: Transformer-TTS training on the card against the "
            "CPU")
        res["artts_train_vs_cpu"] = phase_artts_train_vs_cpu()
    if want & {"23", "24", "25"}:             # 24 needs 23's, 25 24's output
        import shutil
        import tempfile
        work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
        try:
            log("== phase 23: speaker embeddings on the card (ECAPA, "
                "x-vector)")
            res["spk_embed"], (refs, refer, emb) = phase_spk_embed(work)
            if want & {"24", "25"}:
                log("== phase 24: multi-speaker FastSpeech2 (the LibriTTS "
                    "recipe) through Griffin-Lim on the card")
                res["multispk"], hypo = phase_multispk(work, refs, emb)
            if "25" in want:
                log("== phase 25: speaker similarity and objective TTS "
                    "evaluation, card against CPU")
                res["tts_eval"] = phase_tts_eval(work, refer, hypo)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    seconds = time.perf_counter() - t_start
    if want != set(PHASES):
        log(f"== partial run ({args.phases}) done in {seconds:.1f} s "
            f"({smi}); no result lines")
        return 0

    # the path each entry point is counted on: the conformer training step
    # for the default paths' kernels, the fused-route step for the rest
    fused_kernels = set(FUSED_TRAIN_LAUNCHES) - set(CONFORMER_TRAIN_LAUNCHES)
    entries = []
    for k, sym in entry_points():
        name = k.entry_name(sym)
        calls = records[name]
        main_call = calls[0]
        by_path = dict(
            decode=res["path"]["launches"][name],
            transformer_train_step=res["train"]["launches"][name],
            conformer_train_step=res["conformer_train"]["launches"][name],
            decode_fused=res["fused_path"]["launches"][name],
            conformer_train_step_fused=res["fused_train"]["launches"][name],
            tts_synth=res["tts"]["launches"][name],
            tts_train_step=res["tts_train"]["launches"][name],
            tts_gl_synth=res["tts_gl"]["launches"][name],
            artts_synth=res["artts_synth"]["launches"][name],
            artts_train_step=res["artts_train"]["launches"][name],
            spk_embed=res["spk_embed"]["launches"][name],
            multispk_gl_synth=res["multispk"]["launches"][name],
            tts_eval=res["tts_eval"]["launches"][name])
        entries.append(dict(
            name=name, route="cuda",
            source=f"speechain_tpu_torch/csrc/{k.source.name}",
            replaces=k.replaces[sym],
            launches=by_path["conformer_train_step_fused"
                             if name in fused_kernels
                             else "conformer_train_step"],
            max_abs_err=main_call["max_abs_err"], ms=main_call["ms"],
            plain_ms=main_call["plain_ms"], bound_ms=main_call["bound_ms"],
            bound_by=main_call["bound_by"],
            library_ms=main_call["library_ms"], dtype=main_call["dtype"],
            shape=main_call["shape"], launches_by_path=by_path,
            **{k: main_call[k] for k in (
                "device_ms", "library_device_ms", "library_composition_ms",
                "library_composition_device_ms") if k in main_call},
            calls=calls))
    summary = dict(card=smi, torch=torch.__version__,
                   cuda=torch.version.cuda, **res, kernels=entries,
                   seconds=seconds)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "summary.json").write_text(json.dumps(summary, indent=1))
    log(f"== done in {summary['seconds']:.1f} s ({smi})")
    print(json.dumps({"kernels": [{k: v for k, v in e.items()
                                   if k != "calls"} for e in entries]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
