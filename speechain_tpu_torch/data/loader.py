"""Host loading pipeline: batch assembly with static-shape buckets, text
tokenization, background prefetch, multi-stream zipping.

A copy of ``speechain_tpu/data/loader.py``; :func:`device_prefetch`
makes the step's torch tensors ahead of the consumer.

The reference's torch DataLoader path (iterator/abs.py:428-439 +
model/abs.py:497-546 batch_preprocess_fn), rebuilt: item reads run in a
thread pool, collate pads time/length/batch axes up to bucket grids so a
step sees a handful of shapes, tokenization happens here on host (the
reference tokenizes text strings inside Model.forward).

Multi-stream batches (MultiDataLoader semantics, runner.py:918-975): zip the
named loaders and stop at the shortest — per-domain sub-batch dicts feed one
step.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator as PyIterator, List, Optional

import numpy as np

from speechain_tpu_torch.data.iterator import Iterator, bucket_len


def pad_to(arr: np.ndarray, length: int, axis: int = 0,
           value: float = 0.0) -> np.ndarray:
    if arr.shape[axis] >= length:
        return arr
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, length - arr.shape[axis])
    return np.pad(arr, pad, constant_values=value)


def collate_speech_text(samples: List[Dict[str, Any]],
                        tokenizer=None,
                        time_bucket: int = 1600,
                        token_bucket: int = 16,
                        batch_bucket: int = 8,
                        text_no_sos: bool = False,
                        text_no_eos: bool = False,
                        spk2idx: Optional[Dict[str, int]] = None
                        ) -> Dict[str, np.ndarray]:
    """Pad a list of samples into one static-shaped batch dict.

    feat time axis rounds up to a multiple of ``time_bucket`` (raw waveforms:
    use ~0.1 s = 1600 samples; mel feats: ~64 frames), text length to
    ``token_bucket``, batch size to ``batch_bucket``. Padding rows carry
    feat_len = text_len = 0 and are ignored by the criteria.
    """
    out: Dict[str, Any] = {}
    B = len(samples)
    B_pad = bucket_len(B, batch_bucket, batch_bucket)

    if "feat" in samples[0]:
        feats = [s["feat"] for s in samples]
        T = bucket_len(max(f.shape[0] for f in feats), time_bucket, time_bucket)
        D = feats[0].shape[-1]
        # int16 PCM rows stay int16 (frontend converts on device with the
        # exact 2^-15 scale); any float row promotes the whole batch
        dtype = (np.int16 if all(f.dtype == np.int16 for f in feats)
                 else np.float32)
        feat = np.zeros((B_pad, T, D), dtype)
        feat_len = np.zeros((B_pad,), np.int32)
        for i, f in enumerate(feats):
            feat[i, :f.shape[0]] = f
            feat_len[i] = f.shape[0]
        out["feat"], out["feat_len"] = feat, feat_len

    if "text" in samples[0]:
        assert tokenizer is not None, "text batches need a tokenizer"
        ids = [tokenizer.text2tensor(s["text"], no_sos=text_no_sos,
                                     no_eos=text_no_eos) for s in samples]
        L = bucket_len(max(len(t) for t in ids), token_bucket, token_bucket)
        text = np.full((B_pad, L), tokenizer.ignore_idx, np.int32)
        text_len = np.zeros((B_pad,), np.int32)
        for i, t in enumerate(ids):
            text[i, :len(t)] = t
            text_len[i] = len(t)
        out["text"], out["text_len"] = text, text_len
        out["raw_text"] = [s["text"] for s in samples]

    if "spk_feat" in samples[0]:
        sf = np.stack([s["spk_feat"].reshape(-1) for s in samples])
        out["spk_feat"] = pad_to(sf, B_pad, axis=0)
    if "spk_ids" in samples[0]:
        out["raw_spk_ids"] = [s["spk_ids"] for s in samples]
        if spk2idx is not None:
            # close-set lookup table ids (SpeakerEmbedPrenet spk_num path;
            # reference model/ar_tts.py:156-171 spk_list -> spk2idx)
            ids = np.zeros((B_pad,), np.int32)
            for i, s in enumerate(samples):
                ids[i] = spk2idx.get(str(s["spk_ids"]), 0)
            out["spk_ids"] = ids
    if "pitch" in samples[0]:
        ps = [s["pitch"].reshape(-1) for s in samples]
        # pitch is at the mel frame rate; share the feat time axis only when
        # feat is itself a frame-level feature (not a raw waveform)
        feat_is_frames = "feat" in out and out["feat"].shape[-1] > 1
        T = out["feat"].shape[1] if feat_is_frames else bucket_len(
            max(len(p) for p in ps), 64, 64)
        pitch = np.zeros((B_pad, T), np.float32)
        pitch_len = np.zeros((B_pad,), np.int32)
        for i, p in enumerate(ps):
            pitch[i, :min(len(p), T)] = p[:T]
            pitch_len[i] = min(len(p), T)
        out["pitch"], out["pitch_len"] = pitch, pitch_len
    if "duration" in samples[0]:
        ds = [s["duration"] for s in samples]
        L = out["text"].shape[1] if "text" in out else bucket_len(
            max(len(d) for d in ds), token_bucket, token_bucket)
        dur = np.zeros((B_pad, L), np.float32)
        dur_len = np.zeros((B_pad,), np.int32)
        for i, d in enumerate(ds):
            dur[i, :min(len(d), L)] = d[:L]
            dur_len[i] = min(len(d), L)
        out["duration"], out["duration_len"] = dur, dur_len

    out["indices"] = [s["index"] for s in samples]
    out["n_real"] = B
    return out


_PROC_STATE: Dict[str, Any] = {}


def _proc_init(dataset, collate_fn):
    _PROC_STATE["ds"] = dataset
    _PROC_STATE["collate"] = collate_fn
    _PROC_STATE["seed"] = None


def _proc_load(task):
    indices, epoch_seed = task
    ds = _PROC_STATE["ds"]
    if epoch_seed is not None and _PROC_STATE["seed"] != epoch_seed \
            and hasattr(ds, "set_epoch_seed"):
        ds.set_epoch_seed(epoch_seed)
        _PROC_STATE["seed"] = epoch_seed
    samples = [ds[i] for i in indices]
    samples = [s for s in samples if s is not None]  # hook-dropped items
    if not samples:
        return None
    return _PROC_STATE["collate"](samples)


class EpochLoader:
    """Iterate one epoch of batches: fetch items in a thread pool, collate,
    and prefetch ahead of the consumer.

    ``num_worker_procs > 0`` switches item loading + collation to a
    persistent process pool (the torch-DataLoader-workers analog,
    iterator/abs.py:428-439): numpy reads and pad-copies are GIL-bound, so
    threads cannot scale them — processes can. The dataset and collate_fn
    are shipped to the workers once at pool creation; augmentation RNG then
    lives per-process (same per-epoch seed, draws depend on which worker
    serves a batch)."""

    def __init__(self, iterator: Iterator, collate_fn: Callable,
                 num_workers: int = 4, prefetch: int = 2,
                 num_worker_procs: int = 0):
        self.iterator = iterator
        self.collate_fn = collate_fn
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.num_worker_procs = int(num_worker_procs or 0)
        self._proc_pool = None

    def _get_proc_pool(self):
        if self._proc_pool is None:
            import atexit
            from concurrent.futures import ProcessPoolExecutor
            self._proc_pool = ProcessPoolExecutor(
                self.num_worker_procs, initializer=_proc_init,
                initargs=(self.iterator.dataset, self.collate_fn))
            # shut the pool down before interpreter teardown (a GC'd
            # executor at exit spews a harmless but noisy weakref error)
            atexit.register(self.close)
        return self._proc_pool

    def close(self):
        if self._proc_pool is not None:
            self._proc_pool.shutdown(wait=False, cancel_futures=True)
            self._proc_pool = None

    def _proc_epoch(self, batches, epoch_seed) -> PyIterator[Dict]:
        pool = self._get_proc_pool()
        window = max(self.prefetch, self.num_worker_procs) + 1
        pending = []
        it = iter(batches)
        try:
            for idxs in it:
                pending.append(pool.submit(_proc_load, (idxs, epoch_seed)))
                if len(pending) >= window:
                    res = pending.pop(0).result()
                    if res is not None:
                        yield res
            while pending:
                res = pending.pop(0).result()
                if res is not None:
                    yield res
        finally:
            for f in pending:
                f.cancel()

    def _fast_audio_batch(self, indices: List[str]) -> Optional[Dict]:
        """Native batch assembly (native/batch_assembler.cpp): one C call
        reads + decodes + pad-packs the whole audio batch, bypassing the
        per-utterance Python path. Falls back (returns None) whenever any
        per-item transform or unsupported container is involved."""
        ds = self.iterator.dataset
        raw_paths = getattr(ds, "raw_audio_paths", None)
        data_len = self.iterator.data_len
        if raw_paths is None or data_len is None:
            return None
        paths = raw_paths(indices)
        if paths is None:
            return None
        lens = [data_len.get(i) for i in indices]
        if any(ln is None for ln in lens):
            return None
        kw = getattr(self.collate_fn, "keywords", None) or {}
        time_bucket = kw.get("time_bucket") or 1600
        batch_bucket = kw.get("batch_bucket") or 8
        t_pad = bucket_len(max(lens), time_bucket, time_bucket)
        b_pad = bucket_len(len(indices), batch_bucket, batch_bucket)
        try:
            from speechain_tpu_torch.utils.native_audio import batch_read_i16
            res = batch_read_i16(paths, t_pad, b_pad,
                                 expected_sr=getattr(ds, "sample_rate", 0))
        except Exception:
            return None
        if res is None:
            return None
        feat, feat_len = res
        samples = [ds.getitem_without(i, skip=("wav",)) for i in indices]
        batch = self.collate_fn(samples)
        batch["feat"], batch["feat_len"] = feat, feat_len
        return batch

    def _load_batch(self, indices: List[str], pool) -> Dict[str, Any]:
        fast = self._fast_audio_batch(indices)
        if fast is not None:
            return fast
        if pool is not None:
            samples = list(pool.map(self.iterator.dataset.__getitem__, indices))
        else:
            samples = [self.iterator.dataset[i] for i in indices]
        # a None sample was dropped by a dataset hook (all-unvoiced pitch,
        # dataset/speech_text.py:313); remove it from the batch
        samples = [s for s in samples if s is not None]
        if not samples:
            return None
        return self.collate_fn(samples)

    def epoch(self, epoch: int = 0, start_step: int = 0) -> PyIterator[Dict]:
        batches = self.iterator.get_batch_indices(epoch)[start_step:]
        if self.num_worker_procs > 0:
            yield from self._proc_epoch(batches, self.iterator.seed + epoch)
            return
        if hasattr(self.iterator.dataset, "set_epoch_seed"):
            self.iterator.dataset.set_epoch_seed(self.iterator.seed + epoch)
        pool = (ThreadPoolExecutor(self.num_workers)
                if self.num_workers > 0 else None)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()

        abort = threading.Event()

        def producer():
            try:
                for idxs in batches:
                    if abort.is_set():
                        break
                    batch = self._load_batch(idxs, pool)
                    if batch is not None:  # batch emptied by dropped items
                        q.put(batch)
            except RuntimeError:
                pass  # pool shut down by an early-exiting consumer
            finally:
                q.put(stop)

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                yield item
        finally:
            # consumer may exit early (e.g. next(...) on the first batch):
            # signal the producer, drain its pending put, then shut down
            abort.set()
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            if pool is not None:
                pool.shutdown(wait=False)

    def __len__(self):
        return len(self.iterator)


def device_prefetch(batch_iter, convert, depth: int = 2):
    """Convert (e.g. numpy -> torch tensors on the device) up to ``depth``
    batches ahead of the consumer.

    A copy from pinned memory with ``non_blocking=True`` returns before it
    lands, so converting ahead leaves the copies queued behind the running
    step instead of in front of the next one (the reference's DataLoader
    worker prefetch, iterator/abs.py:428-439).
    """
    import collections

    queue_: "collections.deque" = collections.deque()
    it = iter(batch_iter)
    try:
        for _ in range(depth):
            queue_.append(convert(next(it)))
    except StopIteration:
        pass
    while queue_:
        out = queue_.popleft()
        try:
            queue_.append(convert(next(it)))
        except StopIteration:
            pass
        yield out


class MultiLoader:
    """Named multi-stream zipping (the reference's multi-dataloader batches,
    runner.py:918-975): yields {name: batch_dict}, length = min over
    streams."""

    def __init__(self, loaders: Dict[str, EpochLoader]):
        self.loaders = loaders

    def epoch(self, epoch: int = 0, start_step: int = 0):
        iters = {name: ld.epoch(epoch, start_step)
                 for name, ld in self.loaders.items()}
        try:
            while True:
                batch = {}
                for name, it in iters.items():
                    nxt = next(it, None)
                    if nxt is None:
                        return
                    batch[name] = nxt
                yield batch
        finally:
            # the shortest stream ends the epoch: close the others so their
            # producer threads/process pools are released immediately
            for it in iters.values():
                it.close()

    def __len__(self):
        return min(len(ld) for ld in self.loaders.values())
