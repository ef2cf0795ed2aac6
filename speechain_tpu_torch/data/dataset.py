"""Host-side datasets keyed by ``idx2*`` metadata files.

A copy of ``speechain_tpu/data/dataset.py`` on the port's
``utils/fileio.py``. Rebuild of reference ``speechain/dataset/abs.py`` +
``speech_text.py``. Per-item loading (disk read / resample / pitch) runs
on host worker threads; collate pads to static shape buckets (the
reference pads each batch to its own lengths).
"""

from __future__ import annotations

import os
import random
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from speechain_tpu_torch.utils.fileio import read_idx2data_file, read_wav
from speechain_tpu_torch.utils.registry import register


def load_data_by_path(path: str) -> np.ndarray:
    """Load one piece of array data by file path (data_loading_util.py:21-89).

    Supports .wav (PCM via stdlib), .npy, .npz ({feat} key), and
    'chunk.npz:index' addressing for packaged features.
    """
    if ":" in path and not os.path.exists(path):
        chunk_path, _, inner = path.rpartition(":")
        with np.load(chunk_path) as z:
            return z[inner]
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".npz"):
        with np.load(path) as z:
            return z["feat"] if "feat" in z else z[list(z.keys())[0]]
    if path.endswith(".wav"):
        wave, _ = read_wav(path)
        return wave
    if path.endswith(".flac"):
        from speechain_tpu_torch.utils.fileio import read_flac
        wave, _ = read_flac(path)
        return wave
    raise ValueError(f"unsupported data file {path!r}")


def data_selection(data_index: List[str], selection_mode: str,
                   selection_num: Union[int, float, str, List],
                   meta_info: Optional[str] = None,
                   rng: Optional[random.Random] = None) -> List[str]:
    """Data selection strategies (dataset/abs.py:188-340).

    non-meta: 'order' | 'rev_order' | 'random' with float fraction or int
    count; meta: 'min' | 'max' | 'middle' with count or str threshold, or
    'group' with a LIST of metadata values to keep (e.g. speaker ids,
    dataset/abs.py:331-338 — instances whose metadata value is not in the
    list are removed).
    """
    arr = list(data_index)
    if meta_info is None:
        assert isinstance(selection_num, (int, float))
        if isinstance(selection_num, float):
            n = int(len(arr) * selection_num)
        elif selection_num < 0:
            n = -int(selection_num)
        else:
            n = int(selection_num)
        if selection_mode == "order":
            return arr[:n]
        if selection_mode == "rev_order":
            return arr[-n:]
        if selection_mode == "random":
            r = rng or random
            return [arr[r.randrange(len(arr))] for _ in range(n)]
        raise ValueError(selection_mode)

    meta = read_idx2data_file(meta_info)
    try:
        items = sorted(((k, float(v)) for k, v in meta.items()
                        if k in set(arr)), key=lambda kv: kv[1])
    except ValueError:
        items = [(k, v) for k, v in meta.items() if k in set(arr)]
    keys = [k for k, _ in items]
    vals = [v for _, v in items]

    if isinstance(selection_num, (list, tuple)):
        # values may have been float-coerced by the sort above while the
        # group list holds ints/strs — compare both ways
        def _in(v, groups):
            for g in groups:
                if str(v) == str(g):
                    return True
                try:
                    if float(v) == float(g):
                        return True
                except (TypeError, ValueError):
                    pass
            return False

        removed = [k for k, v in zip(keys, vals)
                   if not _in(v, selection_num)]
    elif isinstance(selection_num, str):
        thr = float(selection_num)
        if selection_mode == "min":
            removed = [k for k, v in zip(keys, vals) if v > thr]
        elif selection_mode == "max":
            removed = [k for k, v in zip(keys, vals) if v < thr]
        else:
            raise ValueError(selection_mode)
    else:
        n = (int(len(keys) * selection_num) if isinstance(selection_num, float)
             else abs(int(selection_num)))
        if selection_mode == "min":
            removed = keys[n:]
        elif selection_mode == "max":
            removed = keys[:-n] if n else keys
        elif selection_mode == "middle":
            half = (len(keys) - n) // 2
            removed = keys[:half] + (keys[-half:] if half else [])
        else:
            raise ValueError(selection_mode)
    removed_set = set(removed)
    return [k for k in arr if k not in removed_set]


class Dataset:
    """Metadata-dict dataset (dataset/abs.py:19-484).

    main_data: dict name -> idx2file path, an already-loaded dict, or a LIST
    of paths merged in order (the reference's multi-corpus form, e.g.
    librispeech + libritts idx2wav lists,
    utilbox/data_loading_util.py:91-180).
    """

    def __init__(self, main_data: Dict[str, Union[str, Dict, List]],
                 data_selection: Optional[List] = None, **conf):
        self.main_data: Dict[str, Dict[str, str]] = {}
        for name, src in main_data.items():
            if isinstance(src, dict):
                self.main_data[name] = dict(src)
            elif isinstance(src, (list, tuple)):
                merged: Dict[str, str] = {}
                for p in src:
                    merged.update(p if isinstance(p, dict)
                                  else read_idx2data_file(p))
                self.main_data[name] = merged
            else:
                self.main_data[name] = read_idx2data_file(src)
        # intersect indices across all main_data entries
        keys = None
        for d in self.main_data.values():
            keys = set(d) if keys is None else keys & set(d)
        self.data_index: List[str] = [k for k in
                                      list(self.main_data.values())[0]
                                      if k in keys]
        if data_selection is not None:
            for args in data_selection:
                mode, num = args[0], args[1]
                meta = args[2] if len(args) > 2 else None
                self.data_index = globals()["data_selection"](
                    self.data_index, mode, num, meta)
            sel = set(self.data_index)
            for name in self.main_data:
                self.main_data[name] = {k: v for k, v in
                                        self.main_data[name].items() if k in sel}
        self.dataset_init_fn(**conf)

    def dataset_init_fn(self, **conf):
        pass

    def get_data_index(self) -> List[str]:
        return list(self.data_index)

    def remove_data_by_index(self, index: str):
        for d in self.main_data.values():
            d.pop(index, None)
        if index in self.data_index:
            self.data_index.remove(index)

    def extract_main_data_fn(self, main_data: Dict[str, str]) -> Dict[str, Any]:
        """Per-item hook: map {name: raw value} -> loaded sample dict."""
        return dict(main_data)

    def __len__(self):
        return len(self.data_index)

    def __getitem__(self, index: str) -> Optional[Dict[str, Any]]:
        sample = {name: d[index] for name, d in self.main_data.items()}
        out = self.extract_main_data_fn(sample)
        if out is None:
            # hook dropped the utterance (e.g. all-unvoiced pitch,
            # speech_text.py:313); the loader removes it from the batch
            return None
        out["index"] = index
        return out


@register("dataset.speech_text", "speech_text.SpeechTextDataset")
class SpeechTextDataset(Dataset):
    """The ASR/TTS workhorse (dataset/speech_text.py:25-650).

    Per item: load waveform (wav/npy/npz) or precomputed feature, pass text
    through as string (tokenized downstream), optional speaker id / speaker
    feature / pitch / duration loading.

    Options mirroring the reference: ``use_speed_perturb`` (random resample
    from perturb_range, speech_text.py:85-92), ``min_wave_len`` filtering.
    """

    def dataset_init_fn(self, use_speed_perturb: bool = False,
                        perturb_range: Sequence[float] = (0.9, 1.0, 1.1),
                        sample_rate: int = 16000,
                        unk_mask_prob: float = 0.0,
                        use_g2p: bool = False,
                        lexicon_path: Optional[str] = None,
                        remove_sil: bool = False,
                        wave_int16: bool = True,
                        pitch_conf: Optional[Dict] = None, **conf):
        self.use_speed_perturb = use_speed_perturb
        self.perturb_range = list(perturb_range)
        self.sample_rate = sample_rate
        # raw-PCM fast path (see the wav branch in extract_main_data_fn)
        self.wave_int16 = bool(wave_int16)
        # word-level <unk> masking for robust-ASR training
        # (speech_text.py:447-498)
        self.unk_mask_prob = float(unk_mask_prob)
        # trim <space>-marked silence at both ends (speech_text.py:371-445)
        self.remove_sil = remove_sil
        # on-the-fly G2P of raw text (speech_text.py:83,336-342)
        self.use_g2p = use_g2p
        self._g2p = None
        if use_g2p and lexicon_path:
            from speechain_tpu_torch.data.tokenizer import (
                GraphemeToPhonemeTokenizer)
            # lexicon-only usage: bypass vocab loading
            g = GraphemeToPhonemeTokenizer.__new__(
                GraphemeToPhonemeTokenizer)
            g.lexicon = {}
            g.tokenizer_init_fn(lexicon_path=lexicon_path)
            self._g2p = g
        # on-the-fly WORLD pitch extraction (speech_text.py:93-104,307-313);
        # the reference delegates to pyworld dio+stonemask, here the in-repo
        # re-implementation (utils/world_pitch.py)
        self._pitch_extract_fn = None
        if pitch_conf is not None:
            from functools import partial

            from speechain_tpu_torch.utils.world_pitch import convert_wav_to_pitch
            pc = dict(pitch_conf)
            if "sr" in pc:
                assert int(pc.pop("sr")) == int(sample_rate), \
                    "pitch_conf sr must match sample_rate"
            if "continuous_f0" in pc:  # reference kwarg name
                pc["do_continuous_f0"] = bool(pc.pop("continuous_f0"))
            self._pitch_extract_fn = partial(convert_wav_to_pitch,
                                             sr=int(sample_rate), **pc)
        self._rng = random.Random(0)

    def _maybe_downsample(self, wave: np.ndarray, src_sr: int) -> np.ndarray:
        """On-the-fly downsampling when the file's rate exceeds the
        configured one (speech_text.py:279-293)."""
        if src_sr is None or src_sr <= self.sample_rate:
            return wave
        from speechain_tpu_torch.utils.fileio import resample
        return resample(wave, src_sr, self.sample_rate)

    def _apply_unk_mask(self, text: str) -> str:
        """Randomly replace whole words by <unk> (speech_text.py:447-498)."""
        words = text.split()
        out = [("<unk>" if self._rng.random() < self.unk_mask_prob else w)
               for w in words]
        return " ".join(out)

    @staticmethod
    def _trim_silence(sample: Dict[str, Any]) -> Dict[str, Any]:
        """Trim leading/trailing <space> phonemes plus the proportional
        audio/pitch span (speech_text.py:371-445). Requires list-format
        phoneme text and durations."""
        text = sample.get("text")
        if not (isinstance(text, str) and text.strip().startswith("[")):
            return sample
        from speechain_tpu_torch.data.tokenizer import GraphemeToPhonemeTokenizer
        phonemes = GraphemeToPhonemeTokenizer.parse_phoneme_list(text)
        dur = sample.get("duration")
        if phonemes is None or dur is None or len(phonemes) != len(dur):
            return sample
        if phonemes[0] != "<space>" and phonemes[-1] != "<space>":
            return sample
        total = float(np.sum(dur))
        front = tail = 0.0
        while phonemes and phonemes[0] == "<space>":
            front += float(dur[0])
            phonemes, dur = phonemes[1:], dur[1:]
        while phonemes and phonemes[-1] == "<space>":
            tail += float(dur[-1])
            phonemes, dur = phonemes[:-1], dur[:-1]
        if not phonemes:
            return sample
        sample["text"] = "[" + ", ".join(f"'{p}'" for p in phonemes) + "]"
        sample["duration"] = np.asarray(dur, np.float32)
        f_frac, t_frac = front / total, tail / total
        for key in ("feat", "pitch"):
            if key in sample:
                arr = sample[key]
                a = int(f_frac * len(arr))
                b = int(t_frac * len(arr))
                sample[key] = arr[a: len(arr) - b if b else len(arr)]
        return sample

    def set_epoch_seed(self, seed: int):
        self._rng = random.Random(seed)

    def raw_audio_paths(self, indices: List[str]) -> Optional[List[str]]:
        """Audio file paths for the native batch-assembler fast path, or
        None when any per-item audio transform is active (perturbation,
        silence trimming, non-PCM containers) and the Python path must run.
        """
        if ("wav" not in self.main_data or not self.wave_int16
                or self.use_speed_perturb or self.remove_sil
                or self._pitch_extract_fn is not None):
            return None
        wavs = self.main_data["wav"]
        paths = []
        for i in indices:
            p = wavs.get(i)
            if p is None or not (p.endswith(".wav") or p.endswith(".flac")):
                return None
            paths.append(p)
        return paths

    def getitem_without(self, index: str, skip=("wav",)) -> Dict[str, Any]:
        """__getitem__ with some main_data entries excluded (the fast path
        loads audio natively and only needs the host-side fields here)."""
        sample = {name: d[index] for name, d in self.main_data.items()
                  if name not in skip}
        out = self.extract_main_data_fn(sample)
        out["index"] = index
        return out

    def _speed_perturb(self, wave: np.ndarray) -> np.ndarray:
        factor = self._rng.choice(self.perturb_range)
        if factor == 1.0:
            return wave
        # linear-interpolation resample (host-side augmentation;
        # the reference uses torchaudio's polyphase resampler)
        n_out = int(round(len(wave) / factor))
        src = np.linspace(0.0, len(wave) - 1.0, n_out)
        lo = np.floor(src).astype(np.int64)
        hi = np.minimum(lo + 1, len(wave) - 1)
        w = src - lo
        return ((1.0 - w) * wave[lo] + w * wave[hi]).astype(np.float32)

    def extract_main_data_fn(self, main_data: Dict[str, str]) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for name, value in main_data.items():
            if name == "wav":
                from speechain_tpu_torch.utils.fileio import read_data_by_path
                # keep 16-bit PCM as int16 when no host-side resampling is
                # needed: the device frontend scales by the exact 2^-15
                # (ops/frontend.to_float_wave), halving host work + transfer
                wave, src_sr = read_data_by_path(
                    value, return_sample_rate=True,
                    prefer_int16=self.wave_int16)
                if wave.dtype == np.int16 and (
                        self.use_speed_perturb
                        or (src_sr is not None
                            and src_sr > self.sample_rate)):
                    wave = wave.astype(np.float32)
                    wave *= np.float32(1.0 / 32768.0)
                if wave.dtype != np.int16:
                    wave = np.asarray(wave, np.float32).reshape(-1)
                    wave = self._maybe_downsample(wave, src_sr)
                    if self.use_speed_perturb:
                        wave = self._speed_perturb(wave)
                else:
                    wave = wave.reshape(-1)
                out["feat"] = wave[:, None]
            elif name == "feat":
                out["feat"] = load_data_by_path(value).astype(np.float32)
            elif name == "text":
                text = value
                if self.use_g2p and self._g2p is not None \
                        and not text.strip().startswith("["):
                    text = "[" + ", ".join(
                        f"'{p}'" for p in self._g2p.g2p(text)) + "]"
                if self.unk_mask_prob > 0.0:
                    text = self._apply_unk_mask(text)
                out["text"] = text
            elif name == "spk_ids":
                out["spk_ids"] = value
            elif name == "spk_feat":
                out["spk_feat"] = load_data_by_path(value).astype(np.float32)
            elif name == "pitch":
                out["pitch"] = load_data_by_path(value).astype(np.float32)
            elif name == "duration":
                out["duration"] = np.asarray(
                    [float(d) for d in str(value).split()], dtype=np.float32)
            else:
                out[name] = value
        if (self._pitch_extract_fn is not None and "pitch" not in out
                and "feat" in out and out["feat"].shape[-1] == 1):
            wave = out["feat"][:, 0]
            if wave.dtype == np.int16:
                wave = wave.astype(np.float32) * np.float32(1.0 / 32768.0)
            pitch = self._pitch_extract_fn(wave)
            if not np.any(pitch > 0):
                # all-unvoiced utterance: drop it, as the reference does
                # when interpolation raises IndexError (speech_text.py:313)
                return None
            out["pitch"] = pitch
        if self.remove_sil:
            out = self._trim_silence(out)
        return out


@register("dataset.random_spk_feat", "speech_text.RandomSpkFeatDataset")
class RandomSpkFeatDataset(SpeechTextDataset):
    """Reference-speaker embedding picker for TTS synthesis
    (speech_text.py:529-648): each item gets a randomly drawn speaker
    embedding from a pool, optionally mixing up (averaging) several
    embeddings.

    When a sibling ``idx2spk`` file exists next to the ``spk_feat`` file,
    balancing happens at the SPEAKER level (reference speech_text.py:560-583:
    least-frequently-used speaker first, then a random utterance embedding of
    that speaker); ``use_aver_feat`` additionally substitutes the speaker's
    average embedding from the sibling ``spk2aver_{model}_spk_feat`` file
    (reference :576-583,625-633). Without ``idx2spk`` the pool is flat and
    balancing is per embedding key.
    """

    def dataset_init_fn(self, spk_feat: Union[str, List[str], None] = None,
                        use_aver_feat: bool = True,
                        mixup_number: int = 1, **conf):
        super().dataset_init_fn(**conf)
        assert spk_feat is not None, "RandomSpkFeatDataset needs spk_feat"
        if not isinstance(spk_feat, (list, tuple)):
            spk_feat = [spk_feat]
        self.spk_feat_paths: Dict[str, str] = {}
        self.idx2spk: Dict[str, str] = {}
        self.spk2aver_spk_feat: Dict[str, str] = {}
        for sf in spk_feat:
            self.spk_feat_paths.update(read_idx2data_file(sf))
            meta_dir = os.path.dirname(sf)
            spk_path = os.path.join(meta_dir, "idx2spk")
            if os.path.exists(spk_path):
                self.idx2spk.update(read_idx2data_file(spk_path))
            if use_aver_feat:
                # idx2{model}_spk_feat -> spk2aver_{model}_spk_feat
                model = os.path.basename(sf).split("2")[-1].split("_")[0]
                aver = os.path.join(meta_dir, f"spk2aver_{model}_spk_feat")
                if os.path.exists(aver):
                    self.spk2aver_spk_feat.update(read_idx2data_file(aver))
        self.spk_feat_keys = list(self.spk_feat_paths)
        self.spk2feat_keys: Optional[Dict[str, List[str]]] = None
        if self.idx2spk:
            self.spk2feat_keys = {}
            for k in self.spk_feat_keys:
                spk = self.idx2spk.get(k)
                if spk is not None:
                    self.spk2feat_keys.setdefault(spk, []).append(k)
            self.spk_pick_counts = {s: 0 for s in sorted(self.spk2feat_keys)}
        else:
            self.spk_pick_counts = {k: 0 for k in self.spk_feat_keys}
        self.mixup_number = mixup_number

    def _pick_balanced(self, weight: int = 1) -> str:
        # frequency balancing: prefer least-picked entries. The pick count
        # advances by the utterance's text length when known (reference
        # get_min_indices_by_freq freq_weights=len(text),
        # speech_text.py:560-583) so long utterances "use up" a speaker
        # faster on length-varied corpora.
        min_count = min(self.spk_pick_counts.values())
        cands = [k for k, c in self.spk_pick_counts.items() if c == min_count]
        key = self._rng.choice(cands)
        self.spk_pick_counts[key] += max(1, int(weight))
        return key

    def _pick_spk(self, weight: int = 1):
        """-> (spk_feat_id, spk_id or None, embedding path)."""
        if self.spk2feat_keys is None:
            key = self._pick_balanced(weight)
            return key, None, self.spk_feat_paths[key]
        spk_id = self._pick_balanced(weight)
        if spk_id in self.spk2aver_spk_feat:
            # reference names the pick 'aver_spk_feat' (speech_text.py:629)
            return "aver_spk_feat", spk_id, self.spk2aver_spk_feat[spk_id]
        key = self._rng.choice(self.spk2feat_keys[spk_id])
        return key, spk_id, self.spk_feat_paths[key]

    def extract_main_data_fn(self, main_data: Dict[str, str]) -> Dict[str, Any]:
        out = super().extract_main_data_fn(main_data)
        if out is None:
            # parent dropped the utterance (all-unvoiced pitch,
            # speech_text.py:313) — propagate the drop instead of crashing
            return None
        weight = len(out["text"]) if "text" in out else 1
        feats, refs, spks = [], [], []
        for _ in range(self.mixup_number):
            key, spk_id, path = self._pick_spk(weight)
            refs.append(key)
            if spk_id is not None:
                spks.append(spk_id)
            feats.append(load_data_by_path(path).astype(
                np.float32).reshape(-1))
        out["spk_feat"] = np.mean(np.stack(feats), axis=0)
        out["spk_feat_ids"] = "+".join(sorted(refs) if len(refs) > 1
                                       else refs)
        if spks:
            out["spk_ids"] = "+".join(sorted(spks) if len(spks) > 1
                                      else spks)
        return out
