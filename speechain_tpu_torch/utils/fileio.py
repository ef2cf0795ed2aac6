"""Host-side data file I/O: idx2* metadata files and audio.

A copy of the parts of ``speechain_tpu/utils/fileio.py`` that the
evaluation entry points and the datasets use, and of
``pyscripts/wave_downsampler.py``'s ``resample``. Metadata are
whitespace-separated ``idx2{name}`` text files keyed by utterance index
(first token the index, the rest the value); audio is .wav (the stdlib
``wave`` layout, read with numpy) or .flac (the native decoder,
``native/``); arrays are .npy, .npz ({feat, sample_rate}) or entries of
a chunk file addressed ``chunk.npz:index`` (or an hdf5 chunk).
"""

from __future__ import annotations

import os
import struct
import wave
from typing import Dict, Union

import numpy as np


# --------------------------------------------------------------------------
# idx2* metadata files
# --------------------------------------------------------------------------

def read_idx2data_file(path: str, data_type: type = str
                       ) -> Dict[str, Union[str, int, float]]:
    """Read one ``idx2{name}`` file into an ordered dict. Lines are
    ``<idx> <value...>``; a value of several tokens stays one string."""
    out: Dict[str, Union[str, int, float]] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            idx, _, value = line.partition(" ")
            out[idx] = data_type(value) if data_type is not str else value
    return out


def write_idx2data_file(data: Dict[str, object], path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for idx, value in data.items():
            f.write(f"{idx} {value}\n")


# --------------------------------------------------------------------------
# audio
# --------------------------------------------------------------------------

def read_wav(path: str, int16: bool = False) -> tuple:
    """Read a PCM wav file -> (float32 waveform in [-1, 1], sample_rate).

    8/16/24/32-bit integer PCM and 32-bit float PCM; several channels are
    averaged to mono. ``int16``: 16-bit mono PCM comes back as its raw
    int16 samples (the frontend scales by the exact 2^-15,
    ``ops/frontend.py::to_float_wave``); other formats stay float32."""
    with open(path, "rb") as f:
        header = f.read(12)
        if header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            chunk_hdr = f.read(8)
            if len(chunk_hdr) < 8:
                break
            cid, csize = struct.unpack("<4sI", chunk_hdr)
            if cid == b"fmt ":
                fmt = f.read(csize)
            elif cid == b"data":
                data = f.read(csize)
            else:
                f.seek(csize + (csize & 1), os.SEEK_CUR)
            if fmt is not None and data is not None:
                break
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, n_channels, sample_rate, _, _, bits = struct.unpack(
        "<HHIIHH", fmt[:16])
    if audio_format == 3 or (audio_format == 0xFFFE and bits == 32):
        wav = np.frombuffer(data, dtype="<f4").astype(np.float32)
    elif bits == 16:
        if int16 and n_channels == 1:
            return np.frombuffer(data, dtype="<i2"), int(sample_rate)
        wav = np.frombuffer(data, dtype="<i2").astype(np.float32)
        wav *= np.float32(1.0 / 32768.0)
    elif bits == 32:
        wav = np.frombuffer(data, dtype="<i4").astype(np.float32) \
            / 2147483648.0
    elif bits == 8:
        wav = (np.frombuffer(data, dtype=np.uint8).astype(np.float32)
               - 128.0) / 128.0
    elif bits == 24:
        raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        ints = (raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16))
        ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
        wav = ints.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(
            f"{path}: unsupported PCM format ({audio_format}, {bits}bit)")
    if n_channels > 1:
        wav = wav.reshape(-1, n_channels).mean(axis=1)
    return wav, int(sample_rate)


def write_wav(path: str, wav: np.ndarray, sample_rate: int) -> None:
    """Write a float waveform in [-1, 1] as 16-bit PCM wav."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    pcm = np.clip(np.asarray(wav, dtype=np.float64), -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(int(sample_rate))
        w.writeframes(pcm.tobytes())


def read_flac(path: str, int16: bool = False) -> tuple:
    """Read a FLAC file through the native decoder
    (``native/flac_decoder.cpp``)."""
    from speechain_tpu_torch.utils import native_audio

    return native_audio.read_flac(path, int16=int16)


def read_data_by_path(path: str, return_sample_rate: bool = False,
                      prefer_int16: bool = False):
    """Read a .wav, .flac, .npy, .npz or chunk-addressed array (the sample
    rate is None where the file has none); ``prefer_int16`` passes the
    raw-PCM path through to :func:`read_wav` and :func:`read_flac`."""
    sample_rate = None
    if ":" in path and not os.path.exists(path):
        archive, _, index = path.rpartition(":")
        if archive.endswith((".hdf5", ".h5")):
            import h5py
            with h5py.File(archive, "r") as reader:
                data = np.array(reader[index])
        else:
            with np.load(archive) as z:
                data = z[index]
    elif path.endswith(".npy"):
        data = np.load(path)
    elif path.endswith(".npz"):
        with np.load(path) as z:
            data = z["feat"]
            if "sample_rate" in z:
                sample_rate = int(z["sample_rate"])
    elif path.endswith(".wav"):
        data, sample_rate = read_wav(path, int16=prefer_int16)
    elif path.endswith(".flac"):
        data, sample_rate = read_flac(path, int16=prefer_int16)
    else:
        raise ValueError(f"unsupported data file: {path}")
    data = np.asarray(data)
    if return_sample_rate:
        return data, sample_rate
    return data


def resample(wave: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resampling (scipy's ``resample_poly``) to float32."""
    if sr_in == sr_out:
        return wave
    from math import gcd

    from scipy.signal import resample_poly
    g = gcd(sr_in, sr_out)
    return resample_poly(wave, sr_out // g, sr_in // g).astype(np.float32)
