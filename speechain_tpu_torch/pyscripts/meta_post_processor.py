"""Metadata post-processing: merge per-subset idx2 files into combined
subsets (e.g. LibriSpeech train-960 = train-clean-100 + train-clean-360 +
train-other-500).

Rebuild of reference ``datasets/meta_post_processor.py:10`` +
``datasets/{librispeech,libritts}/meta_post_processor.py`` (subset union
maps at librispeech/meta_post_processor.py:57-69): instead of one subclass
per dataset, this is one CLI with the known combination maps built in and a
``--combine name=member1,member2`` grammar for custom unions. Every
``idx2*`` file present in ALL members is concatenated into the combined
subset directory (indices are disjoint across members by construction of
the corpora).

A copy of
``speechain_tpu/pyscripts/meta_post_processor.py`` on the port's utilities:
the same flags and the same output files; host code only.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Dict, List

# reference subset unions (librispeech/meta_post_processor.py:57-69,
# libritts analog)
DATASET_COMBINES: Dict[str, Dict[str, List[str]]] = {
    "librispeech": {
        "train-clean-460": ["train-clean-100", "train-clean-360"],
        "train-960": ["train-clean-100", "train-clean-360",
                      "train-other-500"],
        "dev": ["dev-clean", "dev-other"],
    },
    "libritts": {
        "train-clean-460": ["train-clean-100", "train-clean-360"],
        "train-960": ["train-clean-100", "train-clean-360",
                      "train-other-500"],
        "dev": ["dev-clean", "dev-other"],
    },
}


def merge_subsets(src_path: str, target: str, members: List[str]) -> bool:
    """Concatenate every idx2* file shared by all members into
    ``src_path/target``. Returns False (no-op) if a member is missing."""
    member_dirs = [os.path.join(src_path, m) for m in members]
    if not all(os.path.isdir(d) for d in member_dirs):
        return False
    shared = None
    for d in member_dirs:
        names = {os.path.basename(p) for p in glob.glob(os.path.join(d, "idx2*"))
                 if os.path.isfile(p)}
        shared = names if shared is None else (shared & names)
    if not shared:
        return False
    out_dir = os.path.join(src_path, target)
    os.makedirs(out_dir, exist_ok=True)
    for name in sorted(shared):
        with open(os.path.join(out_dir, name), "w", encoding="utf-8") as out:
            for d in member_dirs:
                with open(os.path.join(d, name), encoding="utf-8") as f:
                    for line in f:
                        if line.strip():
                            out.write(line if line.endswith("\n")
                                      else line + "\n")
    return True


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--src_path", required=True,
                   help="dataset dump root holding the per-subset dirs")
    p.add_argument("--dataset", default=None,
                   choices=sorted(DATASET_COMBINES),
                   help="apply this dataset's built-in combination map")
    p.add_argument("--combine", action="append", default=[],
                   help="custom union 'name=member1,member2' (repeatable)")
    args = p.parse_args(argv)

    plan: Dict[str, List[str]] = {}
    if args.dataset:
        plan.update(DATASET_COMBINES[args.dataset])
    for spec in args.combine:
        name, _, members = spec.partition("=")
        if not members:
            raise ValueError(f"bad --combine spec {spec!r}; "
                             "expected name=member1,member2")
        plan[name] = [m.strip() for m in members.split(",") if m.strip()]
    if not plan:
        raise ValueError("nothing to do: pass --dataset and/or --combine")

    for target, members in plan.items():
        done = merge_subsets(args.src_path, target, members)
        print(f"{target} <- {'+'.join(members)}: "
              f"{'merged' if done else 'skipped (missing members)'}")


if __name__ == "__main__":
    main()
