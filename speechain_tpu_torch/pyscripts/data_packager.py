"""Package per-utterance feature files into npz chunks.

Rebuild of reference ``datasets/pyscripts/data_packager.py``: groups
features into chunk files addressed ``chunk_N.npz:idx`` or
``chunk_N.hdf5:idx`` (the formats understood by
utils/fileio.read_data_by_path / data/dataset.load_data_by_path) to cut
filesystem pressure for large datasets.

A copy of
``speechain_tpu/pyscripts/data_packager.py`` on the port's utilities:
the same flags and the same output files; host code only.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from speechain_tpu_torch.utils.fileio import (
    read_data_by_path,
    read_idx2data_file,
    write_idx2data_file,
)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", required=True, help="idx2feat-style file")
    p.add_argument("--save_path", required=True)
    p.add_argument("--chunk_size", type=int, default=1000)
    p.add_argument("--comp_format", default="npz", choices=["npz", "hdf5"])
    args = p.parse_args(argv)

    idx2data = read_idx2data_file(args.data_path)
    os.makedirs(args.save_path, exist_ok=True)
    items = list(idx2data.items())
    new_idx2data = {}
    for c in range(0, len(items), args.chunk_size):
        chunk = items[c:c + args.chunk_size]
        chunk_path = os.path.join(
            args.save_path,
            f"chunk_{c // args.chunk_size}.{args.comp_format}")
        if args.comp_format == "hdf5":
            import h5py
            with h5py.File(chunk_path, "w") as w:
                for idx, path in chunk:
                    w.create_dataset(idx, data=read_data_by_path(path))
        else:
            np.savez(chunk_path, **{idx: read_data_by_path(path)
                                    for idx, path in chunk})
        for idx, _ in chunk:
            new_idx2data[idx] = f"{chunk_path}:{idx}"
    name = os.path.basename(args.data_path)
    write_idx2data_file(new_idx2data, os.path.join(args.save_path, name))
    print(f"packaged {len(new_idx2data)} items into "
          f"{-(-len(items) // args.chunk_size)} chunks")


if __name__ == "__main__":
    main()
