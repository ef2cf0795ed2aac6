"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits nonzero):
  1. identity and build: the card's name and power limit, the torch/CUDA
     versions, and an ``nvcc`` build of every kernel from ``csrc/`` (one
     process per source, all started together);
  2. kernels against their plain PyTorch versions at the serving path's
     shapes (conformer-small, 16 utterances of 8 s, beam 16), in float32
     and bfloat16, with their times and bounds;
  3. the path: conformer-small at full width with seeded random weights,
     beam-16 decoding of 16 random 8 s waveforms through
     ``make_asr_decoder``, with every kernel's launch count;
  4. the path against the CPU: a 2-utterance float32 decode on the card
     and again with ``device="cpu"`` (the kernels' plain versions); the
     hypotheses must be token-equal.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Longer logs go to chiprun_out/.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

PEAK_BYTES = 3.35e12                 # H100 SXM HBM3, bytes/s
PEAK_OPS = {"bfloat16": 989e12,      # dense tensor-core rate
            "float32": 67e12}        # float32 outside the tensor cores
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out" / "chip_smoke"

# conformer-small (bench.py ARCH, recipes/asr/librispeech/train-clean-5/
# exp_cfg/bpe1k_conformer-small.yaml), decoded as bench.py _decode_bench
V, D, H, F_DIM, K_DW = 1000, 256, 4, 1024, 31
ENC_LAYERS, DEC_LAYERS = 12, 6
B, SECS, SR, BEAM = 16, 8, 16000, 16


def log(msg: str) -> None:
    print(msg, flush=True)


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


def bound(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def conformer_small_config(dtype):
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
        ctc_weight=0.3, dtype=dtype)


def build_net(dtype, seed: int = 0):
    from speechain_tpu_torch.models.ar_asr import ARASRNet
    from speechain_tpu_torch.utils.weights import random_state_dict
    net = ARASRNet(conformer_small_config(dtype))
    sd = random_state_dict(net, seed)
    # sharper output distribution than N(0, 1/fan_in) gives: keeps the
    # beam's top candidates apart by more than float32 summation order
    sd["postnet.linear.weight"] *= 8.0
    net.load_state_dict(sd, strict=True)
    return net.eval()


def waves(n: int, seed: int):
    rng = np.random.default_rng(seed)
    L = SECS * SR
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
    from speechain_tpu_torch.ops import (cuda_attention, cuda_convmod,
                                         cuda_ffn, cuda_logmel)
    from speechain_tpu_torch.ops.frontend import FrontendConfig
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(1)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen) * scale).to(
            device=dev, dtype=dtype)

    records = {}

    def compare(name, dtype, kernel_fn, plain_fn, tol_rel, nbytes, ops,
                shape, absolute=False):
        """Error against the plain version; the tolerance is tol_rel
        times max(1, max|plain|), or tol_rel itself when absolute."""
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
        log(f"  {name:<28} {dt:<8} {shape:<34} max_abs_err {err:.3e} "
            f"(tol {tol:.1e}) {'ok' if ok else 'FAIL'}  kernel {ms:.4f} ms"
            f"  plain {plain_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})"
            f"  library: no single PyTorch call")
        if not ok:
            raise RuntimeError(f"{name} {dt}: error {err} > {tol}")
        return dict(call=name, dtype=dt, shape=shape, max_abs_err=err,
                    tol=tol, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=None)

    # ---- log-Mel (float32 only: the frontend contract) ----------------
    cfg = FrontendConfig(n_mels=80, preemphasis=0.97)
    L = SECS * SR
    wave = rnd(B, L, scale=0.1)
    wave_len = torch.full((B,), L, dtype=torch.int32, device=dev)
    wave_len[1] = L - 12345
    T_mel = L // cfg.hop + 1
    nbytes = 4 * (B * L + cfg.fft * 2 * cfg.n_freqs + cfg.n_freqs * 80
                  + B * T_mel * 80) + 8 * B
    ops = B * T_mel * (2 * cfg.fft * 2 * cfg.n_freqs + 3 * cfg.n_freqs
                       + 2 * cfg.n_freqs * 80)
    records["logmel"] = [compare(
        "logmel", torch.float32,
        lambda: cuda_logmel.cuda_logmel(wave, wave_len, cfg)[0],
        lambda: cuda_logmel.logmel_plain(wave, wave_len, cfg)[0],
        1e-4, nbytes, ops, f"wave ({B}, {L}) -> ({B}, {T_mel}, 80)",
        absolute=True)]

    # ---- FFN: encoder macaron half, decode step, no-residual entry -----
    T_enc = ((T_mel - 3) // 2 + 1 - 3) // 2 + 1
    ffn_calls = []
    for dtype in (torch.bfloat16, torch.float32):
        s = dtype.itemsize
        w1 = rnd(F_DIM, D, scale=D ** -0.5, dtype=dtype)
        w2 = rnd(D, F_DIM, scale=F_DIM ** -0.5, dtype=dtype)
        b1, b2 = rnd(F_DIM, scale=0.1), rnd(D, scale=0.1)
        for label, N, alpha, with_res in (
                ("ffn_residual encoder", B * T_enc, 0.5, True),
                ("ffn_residual decode_step", B * BEAM, 1.0, True),
                ("ffn (no residual)", B * T_enc, 1.0, False)):
            x = rnd(N, D, dtype=dtype)
            res = rnd(N, D, dtype=dtype) if with_res else None
            nbytes = (s * (N * D + 2 * F_DIM * D + N * D
                           * (2 if with_res else 1)) + 4 * (F_DIM + D))
            ops = 2 * N * 2 * D * F_DIM
            ffn_calls.append(compare(
                label, dtype,
                lambda x=x, res=res, a=alpha: cuda_ffn.cuda_ffn(
                    x, w1, b1, w2, b2, "GELU", res, a),
                lambda x=x, res=res, a=alpha: cuda_ffn.ffn_plain(
                    x, w1, b1, w2, b2, "GELU", res, a),
                1e-4 if dtype == torch.float32 else 2 ** -6, nbytes, ops,
                f"x ({N}, {D}) F={F_DIM}"))
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
        nbytes = s * (4 * B * T_enc * D + (2 * T_enc - 1) * D) + 8 * D \
            + 4 * B * T_enc
        ops = B * H * 3 * 2 * T_enc * T_enc * (D // H)
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

        # s and ss sum B*T values: hold them relative to their size
        got, want = kern(), plain()
        stats_tol = 1e-4 if dtype == torch.float32 else 1e-2
        for g, w in zip(got[1:], want[1:]):
            rel = float((g - w).abs().max() / w.abs().max().clamp(min=1e-6))
            if rel > stats_tol:
                raise RuntimeError(f"convmod statistics off by {rel} "
                                   f"(tol {stats_tol}, relative)")
        conv_calls.append(compare(
            "conv_glu_dw", dtype, lambda: kern()[0], lambda: plain()[0],
            1e-4 if dtype == torch.float32 else 2 ** -6, nbytes, ops,
            f"x ({B}, {T_enc}, {D}) K={K_DW}"))
    records["convmod"] = conv_calls
    return records


def check_ragged_shapes():
    """Each kernel against its plain version at shapes that leave partial
    tiles (rows, frames, queries) in every kernel; errors only."""
    import torch
    from speechain_tpu_torch.ops import (cuda_attention, cuda_convmod,
                                         cuda_ffn, cuda_logmel)
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
    x, res = rnd(2985, D, dtype=bf), rnd(2985, D, dtype=bf)
    w1 = rnd(F_DIM, D, scale=D ** -0.5, dtype=bf)
    w2 = rnd(D, F_DIM, scale=F_DIM ** -0.5, dtype=bf)
    b1, b2 = rnd(F_DIM, scale=0.1), rnd(D, scale=0.1)
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
        ("ffn_residual N=2985", 2 ** -6, False,
         lambda: cuda_ffn.cuda_ffn(x, w1, b1, w2, b2, "GELU", res, 0.5),
         lambda: cuda_ffn.ffn_plain(x, w1, b1, w2, b2, "GELU", res, 0.5)),
        ("relpos_attention T=77, empty row", 2 ** -6, False,
         lambda: cuda_attention.cuda_relpos_attention(
             q, k, v, ph, bu, bv, D ** -0.5, H, mask),
         lambda: cuda_attention.relpos_attention_plain(
             q, k, v, ph, bu, bv, D ** -0.5, H, mask)),
        ("conv_glu_dw T=77", 2 ** -6, False,
         lambda: cuda_convmod.cuda_conv_glu_dw(cx, cw1, cb1, dwk, dwb)[0],
         lambda: cuda_convmod.conv_glu_dw_plain(cx, cw1, cb1, dwk, dwb)[0]),
    ]
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


# --------------------------------------------------------------- phase 3

def phase_path():
    import torch
    from speechain_tpu_torch.infer.asr import make_asr_decoder
    from speechain_tpu_torch.ops import kernels
    net = build_net(torch.bfloat16, seed=0)
    decode = make_asr_decoder(net, beam_size=BEAM, eos_filtering=True,
                              eos_threshold=-1e9)
    wave, wave_len = waves(B, seed=2)
    feat = torch.from_numpy(wave).cuda()
    feat_len = torch.from_numpy(wave_len).cuda()

    t0 = time.perf_counter()
    decode(feat, feat_len)                        # warm-up (cuBLAS, cuDNN)
    torch.cuda.synchronize()
    log(f"  warm-up decode {1e3 * (time.perf_counter() - t0):.1f} ms")

    for k in kernels():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = decode(feat, feat_len)
    torch.cuda.synchronize()
    total_ms = 1e3 * (time.perf_counter() - t0)
    launches = {k.name: k.launches for k in kernels()}
    peak = torch.cuda.max_memory_allocated()

    repeat_ms = []                                # spread of the same run
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode(feat, feat_len)
        torch.cuda.synchronize()
        repeat_ms.append(1e3 * (time.perf_counter() - t0))
    busy = profile_decode(decode, feat, feat_len, total_ms)

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
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"kernel {name} was not launched on the path")
    log(f"  {B} x {SECS} s, beam {BEAM}: total {total_ms:.1f} ms, encode "
        f"{encode_ms:.2f} ms, {steps} steps at {step_ms:.3f} ms/step, "
        f"{B / total_ms * 1e3:.2f} utt/s, realtime factor "
        f"{B * SECS / total_ms * 1e3:.1f}x, T_enc {T_enc}, peak memory "
        f"{peak / 2**20:.1f} MiB")
    log(f"  repeats of the same decode: "
        f"{', '.join(f'{t:.1f}' for t in repeat_ms)} ms")
    log(f"  launches on the path: {json.dumps(launches)}")
    return dict(total_ms=total_ms, repeat_ms=repeat_ms, encode_ms=encode_ms,
                steps=steps, step_ms=step_ms, utt_per_s=B / total_ms * 1e3,
                realtime_factor=B * SECS / total_ms * 1e3,
                peak_mib=peak / 2**20, T_enc=T_enc, launches=launches,
                device=busy)


def profile_decode(decode, feat, feat_len, wall_ms: float):
    """Device time by kernel over one decode (torch.profiler), and the
    device's busy share of the unprofiled wall time ``wall_ms``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        decode(feat, feat_len)
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
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    if busy_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    ours = {}
    for ms, n, key in rows:
        for name in ("logmel", "ffn", "relpos", "convmod", "stats_reduce"):
            if f"{name}_kernel" in key:
                ours[name] = ours.get(name, 0.0) + ms
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    with open(OUT_DIR / "profile.txt", "w") as f:
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

def phase_path_vs_cpu():
    import torch
    from speechain_tpu_torch.infer.asr import make_asr_decoder
    kw = dict(beam_size=4, eos_filtering=True, max_len=24)
    wave, wave_len = waves(2, seed=3)
    wave_len[1] -= 20000
    results = {}
    for device in ("cuda", "cpu"):
        net = build_net(torch.float32, seed=1)
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from speechain_tpu_torch.ops import kernels
    from speechain_tpu_torch.utils.device import set_fp32_matmul_exact
    set_fp32_matmul_exact()
    t_start = time.perf_counter()
    log("== phase 1: identity and build")
    smi = phase_identity_and_build()
    log("== phase 2: kernels against their plain versions")
    records = check_kernels()
    check_ragged_shapes()
    log("== phase 3: conformer-small beam-16 decoding on the card")
    path = phase_path()
    log("== phase 4: the path against the CPU")
    vs_cpu = phase_path_vs_cpu()

    entries = []
    for k in kernels():
        calls = records[k.name]
        main_call = calls[0]
        entries.append(dict(
            name=k.name, route="cuda",
            source=f"speechain_tpu_torch/csrc/{k.source.name}",
            replaces=k.replaces, launches=path["launches"][k.name],
            max_abs_err=main_call["max_abs_err"], ms=main_call["ms"],
            plain_ms=main_call["plain_ms"], bound_ms=main_call["bound_ms"],
            bound_by=main_call["bound_by"],
            library_ms=main_call["library_ms"], dtype=main_call["dtype"],
            shape=main_call["shape"], calls=calls))
    summary = dict(card=smi, torch=torch.__version__,
                   cuda=torch.version.cuda, path=path, path_vs_cpu=vs_cpu,
                   kernels=entries,
                   seconds=time.perf_counter() - t_start)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "summary.json").write_text(json.dumps(summary, indent=1))
    log(f"== done in {summary['seconds']:.1f} s ({smi})")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
