"""Speaker-similarity evaluation: cosine similarity between the speaker
embeddings of synthesized and reference audio.

Counterpart of ``speechain_tpu/pyscripts/spk_sim_evaluation.py``: embeds
both waveform sets with ECAPA-TDNN or x-vector (``nn/speaker.py``),
computes each utterance's cosine similarity, and writes
``idx2{model}_spk_sim`` and an ``overall_results.md`` summary. Either side
may instead be pre-extracted embeddings (an idx2spk_feat of .npy files)::

    python -m speechain_tpu_torch.pyscripts.spk_sim_evaluation \\
        --hypo_path synth/idx2wav --refer_path data/idx2wav \\
        --checkpoint encoder.pth [--result_path out] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np

from speechain_tpu_torch.pyscripts.spk_feat_extractor import make_embedder
from speechain_tpu_torch.utils.fileio import (read_data_by_path,
                                              read_idx2data_file)
from speechain_tpu_torch.utils.reports import (md_table, topn_bad_cases,
                                               write_idx2_file)


def _embed_all(idx2path: Dict[str, str], is_feat: bool, embed
               ) -> Dict[str, np.ndarray]:
    if is_feat:
        return {i: np.asarray(read_data_by_path(p), np.float32).reshape(-1)
                for i, p in idx2path.items()}
    return {i: embed(read_data_by_path(p)).reshape(-1)
            for i, p in idx2path.items()}


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> float:
    denom = float(np.linalg.norm(a) * np.linalg.norm(b))
    return float(np.dot(a, b) / denom) if denom > 0 else 0.0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--hypo_path", required=True,
                   help="idx2wav (or idx2spk_feat with --hypo_is_feat) of "
                        "synthesized audio")
    p.add_argument("--refer_path", required=True,
                   help="idx2wav (or idx2spk_feat with --refer_is_feat) of "
                        "reference audio")
    p.add_argument("--hypo_is_feat", action="store_true")
    p.add_argument("--refer_is_feat", action="store_true")
    p.add_argument("--spk_model", default="ecapa",
                   choices=["ecapa", "xvector"])
    p.add_argument("--checkpoint", default=None,
                   help="the speaker encoder's torch .pt/.pth state dict; "
                        "required unless both sides are pre-extracted")
    p.add_argument("--sr", type=int, default=16000)
    p.add_argument("--result_path", default=None)
    p.add_argument("--topn_num", type=int, default=30)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    embed = None
    if not (args.hypo_is_feat and args.refer_is_feat):
        if not args.checkpoint:
            raise ValueError("--checkpoint is required to embed raw "
                             "waveforms")
        embed = make_embedder(args.spk_model, args.checkpoint, args.sr,
                              args.device)

    idx2hypo = read_idx2data_file(args.hypo_path)
    idx2refer = read_idx2data_file(args.refer_path)
    h_emb = _embed_all(idx2hypo, args.hypo_is_feat, embed)
    r_emb = _embed_all(idx2refer, args.refer_is_feat, embed)

    idx2sim = {i: cosine_similarity(h_emb[i], r_emb[i])
               for i in h_emb if i in r_emb}
    result_path = args.result_path or os.path.dirname(
        os.path.abspath(args.hypo_path))
    os.makedirs(result_path, exist_ok=True)
    metric = f"{args.spk_model}_spk_sim"
    write_idx2_file({k: f"{v:.4f}" for k, v in idx2sim.items()},
                    os.path.join(result_path, f"idx2{metric}"))

    vals = np.array(list(idx2sim.values()), np.float64)
    lines = ["# Speaker similarity evaluation", "",
             md_table(["metric", "#utts", "mean", "std"],
                      [[metric, len(vals),
                        f"{vals.mean():.4f}" if len(vals) else "n/a",
                        f"{vals.std():.4f}" if len(vals) else "n/a"]]),
             "", f"## Top-{args.topn_num} least similar",
             md_table(["idx", metric],
                      [[i, f"{v:.4f}"] for i, v in
                       topn_bad_cases(idx2sim, args.topn_num, mode="min")]),
             ""]
    with open(os.path.join(result_path, "overall_results.md"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(lines))
    print(f"wrote {result_path}/overall_results.md "
          f"(mean {metric}={vals.mean():.4f} over {len(vals)} utts)"
          if len(vals) else "no shared indices between hypo and refer")
    return idx2sim


if __name__ == "__main__":
    main()
