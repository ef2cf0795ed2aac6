"""A copy of ``speechain_tpu/data/iterator.py``.

Batching iterators: length-sorted views, block (token-budget) batching,
epoch-seeded shuffling, data-parallel sharding, static shape buckets.

Rebuild of reference ``speechain/iterator/abs.py`` + ``block.py``:
- sorting by an ``idx2*_len`` file, ascending/descending (abs.py:137-195);
- default fixed-``batch_size`` batching (abs.py:265-315) and BlockIterator's
  ``batch_len`` total-length budget batching (block.py:24-65);
- ``ngpu``-multiple padding of batches (abs.py:207-222) becomes padding to a
  multiple of the data-mesh size;
- data-parallel slicing ``batch[start::stride]`` with rank0 taking the
  smallest slice when descending (abs.py:224-240);
- ``batches_per_epoch`` clipping/cycling (abs.py:352-420) and epoch-seeded
  shuffle (abs.py:422-423).

Static shapes: :func:`bucket_len` rounds sequence lengths up to a small
set of buckets, so a step sees a handful of shapes instead of one per
length.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence

import numpy as np

from speechain_tpu_torch.utils.fileio import read_idx2data_file
from speechain_tpu_torch.utils.registry import register, resolve


def bucket_len(n: int, multiple: int = 64, min_len: int = 64) -> int:
    """Round ``n`` up to the bucket grid: multiples of ``multiple``."""
    if n <= min_len:
        return min_len
    return ((n + multiple - 1) // multiple) * multiple


@register("iterator.abs", "abs.Iterator")
class Iterator:
    """Owns a Dataset and a batching view List[List[str]]."""

    def __init__(self, dataset_type: str = None, dataset_conf: Dict = None,
                 dataset=None, data_len: Optional[str] = None,
                 group_info: Optional[Dict] = None,
                 is_descending: Optional[bool] = True, shuffle: bool = True,
                 seed: int = 0, batches_per_epoch: Optional[int] = None,
                 data_parallel_size: int = 1, data_parallel_rank: int = 0,
                 **iter_conf):
        if dataset is None:
            dataset_cls = resolve("dataset." + dataset_type
                                  if "." not in dataset_type else dataset_type)
            dataset = dataset_cls(**(dataset_conf or {}))
        self.dataset = dataset
        self.is_descending = is_descending
        self.shuffle = shuffle
        self.seed = seed
        self.batches_per_epoch = batches_per_epoch
        self.dp_size = data_parallel_size
        self.dp_rank = data_parallel_rank

        self.data_len: Optional[Dict[str, int]] = None
        if data_len is not None:
            if isinstance(data_len, dict):
                self.data_len = dict(data_len)
            elif isinstance(data_len, (list, tuple)):
                # multi-corpus form: merge several idx2*_len files
                self.data_len = {}
                for p in data_len:
                    self.data_len.update(
                        p if isinstance(p, dict)
                        else read_idx2data_file(p, int))
            else:
                self.data_len = read_idx2data_file(data_len, int)
            ds_keys = set(self.dataset.get_data_index())
            for k in set(self.data_len) - ds_keys:
                self.data_len.pop(k)
            for k in ds_keys - set(self.data_len):
                self.dataset.remove_data_by_index(k)

        sorted_data = self.dataset.get_data_index()
        if self.data_len is not None and self.is_descending is not None:
            sorted_data = [k for k, _ in sorted(
                self.data_len.items(), key=lambda kv: kv[1],
                reverse=self.is_descending)]
        self.sorted_data = sorted_data

        self.batches = self.batches_generate_fn(
            self.sorted_data, self.data_len, **iter_conf)
        assert len(self.batches) > 0, "no batches generated"

        # pad each batch to a multiple of the data-parallel size
        # (abs.py:207-222: carry the remainder into the next batch)
        if self.dp_size > 1:
            carry: List[str] = []
            fixed: List[List[str]] = []
            for batch in self.batches:
                batch = carry + batch
                carry = []
                rem = len(batch) % self.dp_size
                if rem:
                    carry = batch[-rem:]
                    batch = batch[:-rem]
                if batch:
                    fixed.append(batch)
            if carry:
                fixed.append(carry)
            self.batches = [b for b in fixed if b]
            # rank sharding (abs.py:224-240): descending order gives rank0
            # the smallest slice to balance padding waste
            start = (self.dp_size - self.dp_rank - 1
                     if self.is_descending in (True, None) else self.dp_rank)
            self.batches = [b[start::self.dp_size] for b in self.batches]
            self.batches = [b for b in self.batches if b]

        self.group_info = None
        if group_info is not None:
            self.group_info = {name: read_idx2data_file(path)
                               if not isinstance(path, dict) else dict(path)
                               for name, path in group_info.items()}

    def batches_generate_fn(self, data_index: List[str],
                            data_len: Optional[Dict[str, int]],
                            batch_size: Optional[int] = None) -> List[List[str]]:
        """Default: fixed-size batches (abs.py:265-315)."""
        bs = int(batch_size) if batch_size else 1
        return [data_index[i:i + bs] for i in range(0, len(data_index), bs)]

    def get_batch_indices(self, epoch: int = 0) -> List[List[str]]:
        """The epoch's batching view: shuffled (epoch-seeded) and clipped or
        cycled to ``batches_per_epoch`` (abs.py:352-423)."""
        batches = list(self.batches)
        bpe = self.batches_per_epoch
        if bpe is not None and bpe != len(batches):
            if bpe < len(batches):
                # sliding window over epochs so all data is seen eventually
                start = (epoch * bpe) % len(batches)
                take = batches[start:start + bpe]
                if len(take) < bpe:
                    take += batches[:bpe - len(take)]
                batches = take
            else:
                reps = -(-bpe // len(batches))
                batches = (batches * reps)[:bpe]
        if self.shuffle:
            rng = random.Random(self.seed + epoch)
            rng.shuffle(batches)
        return batches

    def get_group_info(self, index: str) -> Dict[str, str]:
        if self.group_info is None:
            return {}
        return {name: d.get(index) for name, d in self.group_info.items()}

    def __len__(self):
        return (self.batches_per_epoch if self.batches_per_epoch is not None
                else len(self.batches))


@register("iterator.block", "block.BlockIterator")
class BlockIterator(Iterator):
    """Length-budget batching: fill until sum(len) >= batch_len
    (block.py:24-65) — the main training batching strategy."""

    def batches_generate_fn(self, data_index: List[str],
                            data_len: Optional[Dict[str, int]],
                            batch_len: Optional[int] = None) -> List[List[str]]:
        assert batch_len is not None and data_len is not None, \
            "BlockIterator requires batch_len and a data_len file"
        batch_len = int(batch_len)
        batches, cur, cur_frames = [], [], 0
        for index in data_index:
            cur.append(index)
            cur_frames += data_len[index]
            if cur_frames >= batch_len:
                batches.append(cur)
                cur, cur_frames = [], 0
        if cur:
            batches.append(cur)
        return batches
