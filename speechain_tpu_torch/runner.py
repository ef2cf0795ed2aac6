"""CLI entry point: config-driven training and evaluation (counterpart of
``speechain_tpu/runner.py``).

The same experiment surface: ``--config`` exp_cfg YAML (with !ref tags)
holding ``data_cfg`` / ``train_cfg`` / ``infer_cfg``, CLI flags over the
YAML over the defaults; an epoch loop with validation every
``valid_per_epochs``, best-model selection, pruning, N-best averaging,
early stopping and the resume checkpoint; ``--test`` decodes the test
sets (ASR: beam search with CTC and LM fusion or teacher forcing, CER /
WER reports; LM: perplexity; TTS: FastSpeech2 or the KV-cached
Transformer-TTS, Griffin-Lim, the waves and their MCD / log-F0 RMSE);
``infer_cfg: weight_quant: int8`` serves ASR and Transformer-TTS on int8
weights (``infer/quantize.py``).

On one card, in one process. The run goes on the CUDA card; ``--platform
cpu`` is the only way onto the CPU (the kernels' plain versions), and
without a card and without it the runner raises. Randomness: the weights
come from :func:`~speechain_tpu_torch.utils.weights.init_state_dict`
seeded with the run's seed; each epoch's step draws (dropout seeds,
SpecAugment) come in order from a ``torch.Generator`` seeded from (seed,
epoch), as the reference folds the epoch into its key
(``jax.random.fold_in``), so an epoch run after ``--resume`` is the epoch
run straight through.

Not ported, and raising ``NotImplementedError`` with the ROADMAP item
that ports them: meshes other than one data-parallel card,
``--coordinator`` / ``--num_hosts`` / ``--n_devices`` > 1 (A8); a train
set of several named loaders (the chain's multi-domain step, A7); orbax
checkpoints as ``pretrained_model`` or ``lm_model_path`` (A6); the
validation snapshots of ``train/visualizer.py`` (A9) are logged as not
ported and write no figures.

Usage::

    python -m speechain_tpu_torch.runner --config exp_cfg.yaml --train
    python -m speechain_tpu_torch.runner --config exp_cfg.yaml --test \\
        --test_model 10_loss_average
"""

from __future__ import annotations

import argparse
import json
import os
import time
from functools import partial
from typing import Any, Dict

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="speechain_tpu_torch runner")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--data_cfg", type=str, default=None,
                   help="standalone data_cfg yaml replacing the exp_cfg's "
                        "data_cfg block (recipes/**/data_cfg/*.yaml)")
    p.add_argument("--train", action="store_true")
    p.add_argument("--test", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--dry_run", action="store_true",
                   help="data-loading-only epochs (runner.py:338)")
    p.add_argument("--no_optim", action="store_true",
                   help="forward-only steps (runner.py:347)")
    p.add_argument("--result_path", type=str, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--same_proc_seed", action="store_true",
                   help="kept for the reference's surface: one process "
                        "here, so every seed is the same")
    p.add_argument("--num_epochs", type=int, default=None)
    p.add_argument("--valid_per_epochs", type=int, default=None)
    p.add_argument("--report_per_steps", type=int, default=None)
    p.add_argument("--accum_grad", type=int, default=None)
    p.add_argument("--grad_clip", type=float, default=None)
    p.add_argument("--use_bf16", action="store_true", default=None)
    p.add_argument("--early_stopping_patience", type=int, default=None)
    p.add_argument("--last_model_num", type=int, default=None)
    p.add_argument("--best_model_num", type=int, default=None)
    p.add_argument("--test_model", type=str, default=None)
    p.add_argument("--ignore_train_exception", action="store_true",
                   help="skip steps that raise (e.g. device OOM) instead of "
                        "aborting the epoch (runner.py:1079-1092)")
    p.add_argument("--ignore_test_exception", action="store_true",
                   help="skip evaluation batches that raise "
                        "(runner.py:1521-1531)")
    p.add_argument("--n_devices", type=int, default=None,
                   help="one card only (more: ROADMAP A8)")
    p.add_argument("--mesh", type=str, default=None,
                   help="device-mesh axis sizes, e.g. 'data=1'; only one "
                        "data-parallel card is ported (other meshes: "
                        "ROADMAP A8)")
    p.add_argument("--batch_bucket", type=int, default=8)
    p.add_argument("--time_bucket", type=int, default=None)
    p.add_argument("--token_bucket", type=int, default=16)
    p.add_argument("--profile_steps", type=int, default=0,
                   help="capture a torch.profiler trace of N train steps "
                        "(after 3 warm-up steps) into result_path/profile: "
                        "trace.json (chrome://tracing), key_averages.txt and "
                        "summary.json (device busy ms of the steps' wall)")
    p.add_argument("--num_workers", type=int, default=4,
                   help="host loader worker threads (reference DataLoader "
                        "num_workers)")
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="kept for the reference's surface: the port has no "
                        "scanned dispatch, so K steps run one by one, which "
                        "is numerically the same")
    p.add_argument("--num_worker_procs", type=int, default=0,
                   help="host loader worker PROCESSES (collate included); "
                        "use on multi-core hosts where the GIL caps the "
                        "thread loader")
    p.add_argument("--coordinator", type=str, default=None,
                   help="multi-host launch (ROADMAP A8)")
    p.add_argument("--num_hosts", type=int, default=1,
                   help="multi-host launch (ROADMAP A8)")
    p.add_argument("--host_id", type=int, default=None,
                   help="multi-host launch (ROADMAP A8)")
    p.add_argument("--platform", type=str, default=None,
                   help="'cpu' runs on the CPU (the kernels' plain "
                        "versions); by default the run needs a CUDA card")
    return p.parse_args(argv)


DEFAULTS = dict(seed=0, num_epochs=100, valid_per_epochs=1,
                report_per_steps=100, accum_grad=1, grad_clip=5.0,
                use_bf16=False, early_stopping_patience=10,
                last_model_num=1, best_model_num=5)
PROFILE_WARMUP = 3          # steps before a --profile_steps window opens


def set_random_seeds(seed: int, same_proc_seed: bool = False) -> int:
    """Global host-side seeding (reference runner.py:1575-1589):
    PYTHONHASHSEED, python ``random`` and numpy. One process, so every
    process's seed is ``seed`` with or without ``same_proc_seed``; the
    step's draws come from the epoch's generator
    (:func:`epoch_generator`). Returns the effective seed."""
    import random as _random

    os.environ["PYTHONHASHSEED"] = str(seed)
    _random.seed(seed)
    np.random.seed(seed % (2 ** 32))
    return seed


def epoch_generator(seed: int, epoch: int):
    """The epoch's ``torch.Generator`` (on the CPU), seeded from (seed,
    epoch): the port's ``jax.random.fold_in(rng, epoch)``."""
    import torch
    state = np.random.SeedSequence([int(seed), int(epoch)]).generate_state(
        2, np.uint32)
    return torch.Generator().manual_seed(
        (int(state[0]) << 32 | int(state[1])) & ((1 << 63) - 1))


# model families share a train-loop skeleton but differ in batch keys and
# step factories
FAMILY_BATCH_KEYS = {
    # spk_ids double as feat-norm group ids (group granularity,
    # module/norm/feat_norm.py) when the dataset declares speakers
    "asr": ("feat", "feat_len", "text", "text_len", "spk_ids",
            "group_ids"),
    "lm": ("text", "text_len"),
    # the speaker inputs where the recipe's data gives them: an embedding
    # (spk_feat) or a table's ids (spk_ids, with customize_conf.spk_list)
    "artts": ("text", "text_len", "feat", "feat_len", "spk_feat",
              "spk_ids"),
    "fastspeech2": ("text", "text_len", "feat", "feat_len", "pitch",
                    "pitch_len", "duration", "duration_len", "spk_feat",
                    "spk_ids"),
}
TTS_FAMILIES = ("artts", "fastspeech2")


def model_family(mtype: str) -> str:
    t = mtype.lower()
    if "nar_tts" in t or "fastspeech" in t:
        return "fastspeech2"
    if "ar_tts" in t or "artts" in t:
        return "artts"
    if t == "lm" or t.startswith("lm."):
        return "lm"
    return "asr"


def family_step_factory(family: str, device):
    """step factory (net, cfg, tx, train=...) of ``family`` on ``device``
    (the LM's without label smoothing, as the reference's)."""
    from speechain_tpu_torch.train import state as S
    if family == "asr":
        return lambda net, cfg, tx, train: S.make_arasr_step(
            net, cfg, tx, train=train, device=device)
    if family == "lm":
        return lambda net, cfg, tx, train: S.make_lm_step(
            net, tx, train=train, device=device)
    if family == "artts":
        return lambda net, cfg, tx, train: S.make_artts_step(
            net, cfg, tx, train=train, device=device)
    if family == "fastspeech2":
        return lambda net, cfg, tx, train: S.make_fastspeech2_step(
            net, cfg, tx, train=train, device=device)
    raise ValueError(family)


def merge_config(args) -> Dict[str, Any]:
    """CLI > exp_cfg yaml > defaults (runner.py:2045-2091)."""
    from speechain_tpu_torch.utils.yamlref import load_yaml
    exp_cfg = load_yaml(args.config)
    merged = dict(DEFAULTS)
    for k in DEFAULTS:
        if k in exp_cfg and exp_cfg[k] is not None:
            merged[k] = exp_cfg[k]
        v = getattr(args, k, None)
        if v is not None:
            merged[k] = v
    merged["result_path"] = (args.result_path or exp_cfg.get("result_path")
                             or os.path.join(
                                 os.path.dirname(os.path.abspath(args.config)),
                                 "exp"))
    merged["data_cfg"] = exp_cfg["data_cfg"]
    if getattr(args, "data_cfg", None):
        standalone = load_yaml(args.data_cfg)
        if "data_cfg" not in standalone:
            raise KeyError(f"{args.data_cfg} must define a data_cfg block "
                           "(recipes/**/data_cfg/*.yaml schema)")
        merged["data_cfg"] = standalone["data_cfg"]
    merged["train_cfg"] = exp_cfg["train_cfg"]
    merged["infer_cfg"] = exp_cfg.get("infer_cfg", {})
    merged["test_model"] = args.test_model or exp_cfg.get("test_model")
    merged["loss_weights"] = exp_cfg.get("loss_weights")
    merged["visual_snapshot_interval"] = exp_cfg.get(
        "visual_snapshot_interval", 5)
    merged["visual_snapshot_number"] = exp_cfg.get(
        "visual_snapshot_number", 3)
    return merged


def expand_infer_cfg(infer_cfg) -> Dict[str, Dict]:
    """infer_cfg grammar (reference runner.py:1323-1403): a flat dict is one
    unnamed run; {shared_args, exclu_args: [dict, ...]} expands into one
    named run per exclusive-arg combination; a dict of named dicts runs
    each as-is."""
    if not infer_cfg:
        return {"": {}}
    if "exclu_args" in infer_cfg:
        shared = dict(infer_cfg.get("shared_args", {}))
        runs = {}
        for combo in infer_cfg["exclu_args"]:
            name = "_".join(f"{k}={v}" for k, v in sorted(combo.items()))
            runs[name] = {**shared, **combo}
        return runs
    if all(isinstance(v, dict) for v in infer_cfg.values()) and infer_cfg:
        return {str(k): dict(v) for k, v in infer_cfg.items()}
    return {"": dict(infer_cfg)}


def build_data(data_cfg: Dict, split: str, tokenizer, *, batch_bucket=8,
               time_bucket=None, token_bucket=16, num_workers=4,
               num_worker_procs=0, spk2idx=None):
    """data_cfg[split] -> EpochLoader or MultiLoader (runner.py:549-659)."""
    from speechain_tpu_torch.data.loader import (EpochLoader, MultiLoader,
                                                 collate_speech_text)
    from speechain_tpu_torch.utils.registry import resolve

    spec = data_cfg[split]
    tb = time_bucket or 1600

    def one(spec_one):
        it_cls = resolve("iterator." + spec_one["type"]
                         if "." not in spec_one["type"] else spec_one["type"])
        it = it_cls(**dict(spec_one.get("conf", {})))
        collate = partial(collate_speech_text, tokenizer=tokenizer,
                          time_bucket=tb, token_bucket=token_bucket,
                          batch_bucket=batch_bucket, spk2idx=spk2idx)
        return EpochLoader(it, collate, num_workers=num_workers,
                           num_worker_procs=num_worker_procs)

    if "type" in spec:
        return one(spec)
    return MultiLoader({name: one(s) for name, s in spec.items()})


def resolve_platform(platform):
    """The run's device: the card, or the CPU only for ``--platform
    cpu``."""
    from speechain_tpu_torch.utils.device import resolve_device
    if platform in (None, "cuda", "gpu"):
        return resolve_device(None)
    if platform == "cpu":
        return resolve_device("cpu")
    raise ValueError(f"unknown --platform {platform!r} (cpu, cuda or gpu)")


def check_single_card(args, train_cfg=None):
    """Raise for what ROADMAP A8 ports: more than one card or host, or a
    mesh other than one data-parallel card."""
    if args.coordinator or args.num_hosts > 1 or args.host_id:
        raise NotImplementedError(
            "multi-host training is not ported (ROADMAP A8)")
    if args.n_devices is not None and args.n_devices > 1:
        raise NotImplementedError(
            "more than one card is not ported (ROADMAP A8)")
    spec = args.mesh or (train_cfg or {}).get("parallel")
    if spec is None:
        return
    pairs = ([kv.partition("=")[::2] for kv in
              spec.replace(" ", "").split(",") if kv]
             if isinstance(spec, str) else list(dict(spec).items()))
    for axis, size in pairs:
        if not ((axis == "data" and int(size) == 1)
                or (axis in ("model", "seq", "pipe") and int(size) == 1)
                or (axis in ("micro", "fsdp") and int(size) == 0)):
            raise NotImplementedError(
                f"mesh {spec!r}: only one data-parallel card is ported "
                "(ROADMAP A8)")


def read_port_model(path: str):
    """The state dict of a port model: an epoch or averaged model's
    directory (``models/<name>/model.pt``). Another directory is taken
    for an orbax checkpoint of the JAX package, which raises (ROADMAP
    A6)."""
    from speechain_tpu_torch.train.checkpoint import MODEL_FILE, load_model
    path = os.path.abspath(path)
    if os.path.exists(os.path.join(path, MODEL_FILE)):
        return load_model(path)
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} holds no {MODEL_FILE}; reading the JAX package's orbax "
            "checkpoints is not ported (ROADMAP A6)")
    raise FileNotFoundError(f"no model under {path}")


def rename_keys(state: Dict, mapping: Dict[str, str]) -> Dict:
    """Rename keys by longest-prefix match (the reference's
    ``model_para_renamer.rename_tree``); a prefix may be written as a flax
    path (``a/b``) or a state-dict name (``a.b``)."""
    pairs = sorted(((str(o).replace("/", "."), str(n).replace("/", "."))
                    for o, n in mapping.items()), key=lambda kv: -len(kv[0]))
    out = {}
    for name, value in state.items():
        for old, new in pairs:
            if name == old or name.startswith(old + "."):
                name = new + name[len(old):]
                break
        out[name] = value
    return out


def load_pretrained(net, spec: Dict, logger) -> None:
    """Merge a pretrained port model into ``net`` (model/abs.py:171-234
    semantics): ``mapping`` renames source keys; ``strict`` (default True)
    requires every loaded tensor to find a target of its shape."""
    src = read_port_model(spec["path"])
    if spec.get("mapping"):
        src = rename_keys(src, spec["mapping"])
    dst = net.state_dict()
    merged, loaded, skipped = dict(dst), 0, []
    for name, value in src.items():
        if name in dst and tuple(dst[name].shape) == tuple(value.shape):
            merged[name] = value
            loaded += 1
        else:
            skipped.append(name)
    if skipped and spec.get("strict", True):
        raise KeyError(f"pretrained keys without a target: {skipped[:10]}")
    if skipped:
        logger.warning("pretrained: skipped %d unmatched keys", len(skipped))
    net.load_state_dict(merged, strict=True)
    logger.info("pretrained: loaded %d tensors from %s", loaded,
                spec["path"])


def _tokenizer_of(customize: Dict):
    from speechain_tpu_torch.builders import build_tokenizer
    return build_tokenizer(customize.get("token_type", "char"),
                           customize.get("token_path"))


class _Profiler:
    """The ``--profile_steps`` window: after ``PROFILE_WARMUP`` steps,
    torch.profiler over ``steps`` steps, each timed on the host clock to
    its metrics' read; on close it writes trace.json, key_averages.txt and
    summary.json (device busy ms, the steps' wall ms) under ``out_dir``."""

    def __init__(self, steps: int, out_dir: str, device, logger):
        self.steps, self.out_dir, self.logger = steps, out_dir, logger
        self.device = device
        self.prof, self.seen, self.walls = None, 0, []

    def before_step(self):
        if not self.steps or self.prof is not None \
                or self.seen != PROFILE_WARMUP:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.logger.info("profiler trace started (steps %d-%d)", self.seen,
                         self.seen + self.steps - 1)

    def after_step(self, wall_s: float):
        self.seen += 1
        if self.prof is None or len(self.walls) >= self.steps:
            return
        self.walls.append(wall_s)
        if len(self.walls) == self.steps:
            self.close()

    def close(self):
        if self.prof is None or self.out_dir is None:
            return
        import torch
        from torch.autograd import DeviceType
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        os.makedirs(self.out_dir, exist_ok=True)
        self.prof.export_chrome_trace(os.path.join(self.out_dir,
                                                   "trace.json"))
        rows = self.prof.key_averages()
        with open(os.path.join(self.out_dir, "key_averages.txt"), "w") as f:
            f.write(rows.table(sort_by="self_cpu_time_total", row_limit=60))
        busy_us = sum(getattr(e, "self_device_time_total", 0) for e in rows
                      if e.device_type == DeviceType.CUDA)
        summary = dict(steps=len(self.walls),
                       wall_ms=1e3 * sum(self.walls),
                       device_busy_ms=busy_us / 1e3, device=str(self.device))
        with open(os.path.join(self.out_dir, "summary.json"), "w") as f:
            json.dump(summary, f)
        self.logger.info("profiler trace written to %s (%s)", self.out_dir,
                         summary)
        self.out_dir = None


def train_main(cfg: Dict, args):
    import torch

    from speechain_tpu_torch.builders import build_model, build_spk2idx
    from speechain_tpu_torch.data.loader import MultiLoader, device_prefetch
    from speechain_tpu_torch.train.checkpoint import (BestModelTracker,
                                                      CheckpointManager)
    from speechain_tpu_torch.train.monitor import (TrainValidMonitor,
                                                   model_summary,
                                                   setup_logger)
    from speechain_tpu_torch.train.optim import build_optimizers
    from speechain_tpu_torch.train.state import _to_device, init_train_state
    from speechain_tpu_torch.utils.weights import init_state_dict

    check_single_card(args, cfg["train_cfg"])
    device = resolve_platform(args.platform)
    result_path = cfg["result_path"]
    os.makedirs(result_path, exist_ok=True)
    logger = setup_logger(os.path.join(result_path, "train.log"))
    seed = set_random_seeds(int(cfg["seed"]),
                            same_proc_seed=bool(args.same_proc_seed))

    model_cfg = cfg["train_cfg"]["model"]
    model_conf = model_cfg.get("model_conf", {}) or {}
    customize = model_conf.get("customize_conf", {}) or {}
    family = model_family(model_cfg["model_type"])
    make_step = family_step_factory(family, device)
    tokenizer = _tokenizer_of(customize)
    bf16 = bool(cfg["use_bf16"])
    net, net_cfg, mtype = build_model(
        model_cfg, tokenizer.vocab_size,
        torch.bfloat16 if bf16 else torch.float32,
        param_dtype=torch.float32 if bf16 else None)

    loaders = {}
    for split in ("train", "valid"):
        if split not in cfg["data_cfg"]:
            continue
        loaders[split] = build_data(
            cfg["data_cfg"], split, tokenizer,
            batch_bucket=args.batch_bucket,
            time_bucket=args.time_bucket, token_bucket=args.token_bucket,
            num_workers=args.num_workers,
            num_worker_procs=args.num_worker_procs,
            spk2idx=build_spk2idx(customize.get("spk_list")))
        if isinstance(loaders[split], MultiLoader):
            raise NotImplementedError(
                "several named loaders (the chain's multi-domain step) are "
                "not ported (ROADMAP A7)")

    net.load_state_dict(init_state_dict(net, seed), strict=True)
    n_params = sum(p.numel() for p in net.parameters())
    logger.info("model %s: %.2fM parameters", mtype, n_params / 1e6)
    logger.info("%s", model_summary(dict(net.named_parameters()),
                                    name=mtype))

    # pretrained-model loading with key mapping (model/abs.py:171-234)
    pretrained = model_conf.get("pretrained_model") or []
    if isinstance(pretrained, dict):
        pretrained = [pretrained]
    for spec in pretrained:
        load_pretrained(net, spec, logger)

    steps_per_epoch = max(len(loaders["train"]), 1)
    tx = build_optimizers(cfg["train_cfg"].get("optim_sches", {}),
                          steps_per_epoch=steps_per_epoch,
                          accum_grad=cfg["accum_grad"],
                          grad_clip=cfg["grad_clip"])
    state = init_train_state(net, tx, device=device)
    jtrain = make_step(net, net_cfg, tx, train=True)
    jvalid = make_step(net, net_cfg, tx, train=False)
    logger.info("device: %s (%s)", device, torch.cuda.get_device_name(0)
                if device.type == "cuda" else "the kernels' plain versions")
    if int(args.steps_per_dispatch or 1) > 1:
        logger.info("--steps_per_dispatch %d: the port runs the steps one by "
                    "one (numerically the same)", args.steps_per_dispatch)

    ckpt = CheckpointManager(result_path)
    tracker = BestModelTracker(
        rules=[("loss", "min", cfg["best_model_num"])],
        last_n=cfg["last_model_num"],
        early_stopping_patience=cfg["early_stopping_patience"])
    monitor = TrainValidMonitor(result_path, logger,
                                report_per_steps=cfg["report_per_steps"])
    if int(cfg.get("visual_snapshot_number", 3) or 0) > 0:
        logger.info("validation snapshots (train/visualizer.py) are not "
                    "ported yet (ROADMAP A9): no figures are written")
    start_epoch = 1
    if args.resume and ckpt.has_checkpoint():
        state, meta = ckpt.restore_train_state(state)
        if meta:
            start_epoch = meta.get("epoch", 0) + 1
            if "monitor" in meta:
                monitor.load_state_dict(meta["monitor"])
            if "tracker" in meta:
                tracker.load_state_dict(meta["tracker"])
        logger.info("resumed from epoch %d", start_epoch - 1)

    keys = FAMILY_BATCH_KEYS[family]

    def to_device_batch(b, epoch):
        out = {k: _to_device(torch.from_numpy(np.asarray(v)), device)
               for k, v in b.items() if k in keys and v is not None}
        out["epoch"] = torch.tensor(epoch, dtype=torch.int32, device=device)
        return out

    profiler = _Profiler(max(0, int(args.profile_steps or 0)),
                         os.path.join(result_path, "profile"), device,
                         logger)
    for epoch in range(start_epoch, cfg["num_epochs"] + 1):
        gen = epoch_generator(seed, epoch)
        t_ep = time.time()
        if args.dry_run:
            train_iter = loaders["train"].epoch(epoch)
        else:
            train_iter = device_prefetch(loaders["train"].epoch(epoch),
                                         partial(to_device_batch,
                                                 epoch=epoch))
        for db in train_iter:
            profiler.before_step()
            t_step = time.perf_counter()
            with monitor.measure_time("step_time"):
                if args.dry_run:
                    continue
                try:
                    if args.no_optim:
                        _, metrics = jvalid(state, db, gen)
                    else:
                        state, metrics = jtrain(state, db, gen)
                except Exception:
                    # step-level fault tolerance (runner.py:1079-1092)
                    if not args.ignore_train_exception:
                        raise
                    logger.exception("step skipped after exception")
                    continue
            monitor.train_step(metrics)
            profiler.after_step(time.perf_counter() - t_step)
        monitor.finish_train_epoch(epoch)
        monitor.record_trainable_scalars(dict(state.net.named_parameters()),
                                         epoch)
        monitor.log_device_memory()

        if epoch % cfg["valid_per_epochs"] == 0 and not args.dry_run \
                and "valid" in loaders:
            for batch in loaders["valid"].epoch(epoch):
                _, metrics = jvalid(state, to_device_batch(batch, epoch),
                                    gen)
                monitor.valid_step(metrics)
            valid_summary = monitor.finish_valid_epoch(epoch)

            ckpt.save_epoch_model(epoch, state.net)
            decision = tracker.update(epoch, valid_summary)
            ckpt.prune_epochs(decision["keep"])
            # best/latest registry (the reference's symlink farm,
            # monitor.py:929-957, as a json index)
            with open(os.path.join(ckpt.models_dir, "registry.json"),
                      "w") as f:
                json.dump(dict(best=decision["best"],
                               keep=decision["keep"], latest=epoch,
                               records=tracker.records), f, indent=1)
            ckpt.save_train_state(state, extra=dict(
                epoch=epoch, monitor=monitor.state_dict(),
                tracker=tracker.state_dict()))
            if decision["early_stop"]:
                logger.info("early stopping at epoch %d", epoch)
                break
        logger.info("epoch %d done in %.1fs", epoch, time.time() - t_ep)
    profiler.close()

    # final N-best average (monitor.py:1031-1121)
    decision = tracker.update(cfg["num_epochs"] + 1, {})
    best = decision["best"].get(tracker.rules[0][0], [])
    if len(best) > 1:
        ckpt.average_models(best, [n for n, _ in net.named_parameters()],
                            name=f"{tracker.rules[0][0]}_average")
    ckpt.close()   # land + commit the save in flight
    monitor.close()
    logger.info("training finished")
    return state


def load_test_model(net, state: Dict, name: str) -> None:
    """Load the test model's ``state`` into ``net``. An averaged model
    holds the parameters alone, as the reference's does
    (``speechain_tpu/train/checkpoint.py:196``); a net that also needs
    BatchNorm or feature-norm statistics cannot run from it, and this
    raises, where the reference's ``test_main`` fails inside flax (ROADMAP
    §C)."""
    from speechain_tpu_torch.train.checkpoint import mutable_buffer
    res = net.load_state_dict(state, strict=False)
    if res.unexpected_keys:
        raise KeyError(f"model {name!r} holds tensors the net does not "
                       f"have: {res.unexpected_keys[:10]}")
    params = {n for n, _ in net.named_parameters()}
    missing_params = [k for k in res.missing_keys if k in params]
    if missing_params:
        raise KeyError(f"model {name!r} lacks parameters: "
                       f"{missing_params[:10]}")
    missing_stats = [k for k in res.missing_keys if mutable_buffer(k)]
    if missing_stats:
        raise ValueError(
            f"model {name!r} holds the averaged parameters alone, as the "
            "reference's average_models saves them, and this net also needs "
            f"its running statistics ({len(missing_stats)} buffers, e.g. "
            f"{missing_stats[0]}): decode from an epoch model or 'latest' "
            "(the reference's test_main cannot decode it either)")


def _test_sets(cfg):
    return {k: v for k, v in cfg["data_cfg"].items()
            if k not in ("train", "valid")} or {"valid": None}


def test_main(cfg: Dict, args):
    from speechain_tpu_torch.builders import build_model
    from speechain_tpu_torch.train.checkpoint import CheckpointManager
    from speechain_tpu_torch.train.monitor import setup_logger

    check_single_card(args)
    device = resolve_platform(args.platform)
    result_path = cfg["result_path"]
    logger = setup_logger(os.path.join(result_path, "test.log"))
    model_cfg = cfg["train_cfg"]["model"]
    customize = (model_cfg.get("model_conf", {}) or {}).get(
        "customize_conf", {}) or {}
    family = model_family(model_cfg["model_type"])
    tokenizer = _tokenizer_of(customize)
    net, net_cfg, _ = build_model(model_cfg, tokenizer.vocab_size)

    ckpt = CheckpointManager(result_path)
    name = cfg.get("test_model") or "latest"
    if name == "latest":
        state = ckpt.restore_net_state()
    elif name.replace("epoch_", "").isdigit():
        state = ckpt.restore_epoch_model(int(name.replace("epoch_", "")))
    else:
        state = read_port_model(os.path.join(result_path, "models", name))
    load_test_model(net, state, name)
    net.to(device).eval()
    if family in TTS_FAMILIES:
        return tts_test_main(cfg, args, net, net_cfg, tokenizer, customize,
                             name, logger, device)
    if family == "lm":
        return lm_test_main(cfg, args, net, tokenizer, name, logger, device)
    return asr_test_main(cfg, args, net, tokenizer, customize, name, logger,
                         device)


def quantize_for_serving(net, infer_cfg, logger):
    """``infer_cfg: weight_quant: int8`` (reference runner.py:903-919): the
    int8 weights of ``net``'s large parameters (``infer/quantize.py``),
    with the resident-size report; None without ``weight_quant``."""
    from speechain_tpu_torch.infer.quantize import (quantize_net,
                                                    quantize_state_dict,
                                                    quantized_bytes)
    wq = infer_cfg.get("weight_quant")
    if not wq:
        return None
    if str(wq).lower() != "int8":
        raise ValueError(f"weight_quant must be 'int8', got {wq!r}")
    min_elems = int(infer_cfg.get("weight_quant_min_elems", 8192))
    qweights = quantize_net(net, min_elems)
    now, deq = quantized_bytes({**net.state_dict(), **qweights})
    logger.info("weight_quant=int8: resident variables %.1f MiB "
                "(float: %.1f MiB)", now / 2**20, deq / 2**20)
    return qweights


def asr_test_main(cfg, args, net, tokenizer, customize, name, logger,
                  device):
    """ASR evaluation over the test sets for every infer_cfg run
    (runner.py:1323-1548): beam search (CTC and LM fusion) or teacher
    forcing; idx2hypo_text / idx2cer / idx2wer, overall_results.md,
    bad-case reports; resumable through ``tmp_progress.json``."""
    import torch

    from speechain_tpu_torch.builders import build_lm
    from speechain_tpu_torch.infer.asr import (make_asr_decoder,
                                               make_asr_teacher_scorer)
    from speechain_tpu_torch.infer.quantize import serve_quantized
    from speechain_tpu_torch.utils.metrics import batch_error_rates
    from speechain_tpu_torch.utils.reports import (write_bad_case_reports,
                                                   write_idx2_file,
                                                   write_test_reports)
    from speechain_tpu_torch.utils.yamlref import load_yaml

    result_path = cfg["result_path"]
    lm_bundle = {}

    def _load_lm(infer_cfg):
        """External LM for joint decoding (model/ar_asr.py:796-846:
        lm_model_cfg yaml + lm_model_path weights from customize_conf, with
        infer_cfg overrides; loaded once per test session)."""
        if "net" in lm_bundle:
            return lm_bundle["net"]
        lm_conf = (infer_cfg.get("lm_model_cfg")
                   or customize.get("lm_model_cfg"))
        lm_path = (infer_cfg.get("lm_model_path")
                   or customize.get("lm_model_path"))
        if lm_conf is None or lm_path is None:
            raise KeyError("ASR-LM joint decoding needs lm_model_cfg and "
                           "lm_model_path (in infer_cfg or model "
                           "customize_conf)")
        state = read_port_model(lm_path)
        if isinstance(lm_conf, str):
            lm_conf = load_yaml(lm_conf)
        for key in ("train_cfg", "model", "module_conf"):
            if isinstance(lm_conf, dict) and key in lm_conf:
                lm_conf = lm_conf[key]
        lm_net, _ = build_lm(lm_conf, tokenizer.vocab_size)
        load_test_model(lm_net, state, lm_path)
        logger.info("external LM loaded from %s", lm_path)
        lm_bundle["net"] = lm_net
        return lm_net

    all_results = {}
    for run_name, infer_cfg in expand_infer_cfg(
            cfg.get("infer_cfg") or {}).items():
        qweights = quantize_for_serving(net, infer_cfg, logger)
        lm_kwargs = {}
        if float(infer_cfg.get("lm_weight", 0.0)) > 0.0:
            lm_kwargs = dict(
                lm_net=_load_lm(infer_cfg),
                lm_weight=float(infer_cfg["lm_weight"]),
                lm_temperature=float(infer_cfg.get("lm_temperature", 1.0)),
                lm_window_size=infer_cfg.get("lm_window_size"),
                ilm_sub_weight=float(infer_cfg.get("ilm_sub_weight", 0.0)))
        teacher = bool(infer_cfg.get("teacher_forcing", False))
        if teacher:
            decode_fn = make_asr_teacher_scorer(
                net, device=device,
                temperature=float(infer_cfg.get("temperature", 1.0)))
        else:
            decode_fn = make_asr_decoder(
                net, device=device,
                beam_size=int(infer_cfg.get("beam_size", 4)),
                temperature=float(infer_cfg.get("temperature", 1.0)),
                ctc_weight=float(infer_cfg.get("ctc_weight", 0.0)),
                ctc_temperature=float(infer_cfg.get("ctc_temperature", 1.0)),
                length_penalty=float(infer_cfg.get("length_penalty", 1.0)),
                min_f2t_ratio=float(infer_cfg.get("min_f2t_ratio", 3.0)),
                eos_filtering=bool(infer_cfg.get("eos_filtering", False)),
                eos_threshold=float(infer_cfg.get("eos_threshold", 1.5)),
                sent_per_beam=int(infer_cfg.get("sent_per_beam", 1)),
                **lm_kwargs)
        if qweights is not None:
            decode_fn = serve_quantized(net, qweights, decode_fn)
        for set_name in _test_sets(cfg):
            loader = build_data(cfg["data_cfg"], set_name, tokenizer,
                                batch_bucket=args.batch_bucket,
                                time_bucket=args.time_bucket,
                                token_bucket=args.token_bucket)
            out_dir = os.path.join(result_path, name,
                                   *([run_name] if run_name else []),
                                   set_name)
            progress_path = os.path.join(out_dir, "tmp_progress.json")
            idx2hypo, idx2cer, idx2wer = {}, {}, {}
            idx2confid, idx2ratio, idx2nbest = {}, {}, {}
            if os.path.exists(progress_path):
                # resumable evaluation (runner.py:1540-1548): skip the
                # utterances already decoded
                with open(progress_path) as f:
                    saved = json.load(f)
                idx2hypo, idx2cer, idx2wer = (saved["hypo"], saved["cer"],
                                              saved["wer"])
                idx2confid = saved.get("confid", {})
                idx2ratio = saved.get("ratio", {})
                idx2nbest = saved.get("nbest", {})
                logger.info("resuming evaluation: %d utterances done",
                            len(idx2hypo))
            done = set(idx2hypo)
            steps_since_save = 0
            for batch in loader.epoch(0):
                if all(idx in done for idx in batch["indices"]):
                    continue
                feat = torch.from_numpy(batch["feat"])
                feat_len = torch.from_numpy(batch["feat_len"])
                try:
                    if teacher:
                        # teacher-forced confidence of the ground-truth text
                        # (model/ar_asr.py:874-921)
                        out = decode_fn(feat, feat_len,
                                        torch.from_numpy(batch["text"]),
                                        torch.from_numpy(batch["text_len"]))
                    else:
                        # speaker-declared sets select their group's
                        # feat-norm statistics (group mode only)
                        fn_cfg = getattr(net.cfg, "feat_norm", None)
                        gid = (batch.get("spk_ids")
                               if fn_cfg is not None
                               and fn_cfg.norm_type == "group" else None)
                        out = decode_fn(feat, feat_len, group_ids=(
                            None if gid is None else torch.from_numpy(gid)))
                except Exception:
                    # batch-level fault tolerance (runner.py:1521-1531)
                    if not args.ignore_test_exception:
                        raise
                    logger.exception("evaluation batch skipped after "
                                     "exception")
                    continue
                out = {k: v.cpu().numpy() if torch.is_tensor(v) else v
                       for k, v in out.items()}
                n = batch["n_real"]
                hyps = [tokenizer.tensor2text(
                    out["hypo_text"][i][:int(out["hypo_text_len"][i])])
                    for i in range(n)]
                cers, wers, _ = batch_error_rates(hyps, batch["raw_text"])
                for i, idx in enumerate(batch["indices"]):
                    idx2hypo[idx], idx2cer[idx], idx2wer[idx] = \
                        hyps[i], cers[i], wers[i]
                    idx2confid[idx] = float(out["hypo_text_confid"][i])
                    idx2ratio[idx] = float(out["feat_token_len_ratio"][i])
                    if "nbest_text" in out:
                        idx2nbest[idx] = " | ".join(
                            tokenizer.tensor2text(out["nbest_text"][i, j][
                                :int(out["nbest_text_len"][i, j])])
                            for j in range(out["nbest_text"].shape[1]))
                steps_since_save += 1
                if steps_since_save >= 10:
                    os.makedirs(out_dir, exist_ok=True)
                    with open(progress_path, "w") as f:
                        json.dump(dict(hypo=idx2hypo, cer=idx2cer,
                                       wer=idx2wer, confid=idx2confid,
                                       ratio=idx2ratio, nbest=idx2nbest), f)
                    steps_since_save = 0
            if os.path.exists(progress_path):
                os.remove(progress_path)
            summary = dict(cer=float(np.mean(list(idx2cer.values()))),
                           wer=float(np.mean(list(idx2wer.values()))))
            logger.info("%s: %s", set_name, summary)
            write_test_reports(out_dir, idx2hypo=idx2hypo, idx2cer=idx2cer,
                               idx2wer=idx2wer, summary=summary)
            # (metric, mode, N) bad-case reports (reference
            # ar_asr.py:330-339 defaults, infer_cfg.bad_cases_selection)
            write_bad_case_reports(
                out_dir,
                metrics=dict(cer=idx2cer, wer=idx2wer,
                             text_confid=idx2confid,
                             feat_token_len_ratio=idx2ratio),
                idx2hypo=idx2hypo,
                selection=infer_cfg.get("bad_cases_selection"))
            write_idx2_file({k: f"{v:.4f}" for k, v in idx2confid.items()},
                            os.path.join(out_dir, "idx2text_confid"))
            write_idx2_file({k: f"{v:.4f}" for k, v in idx2ratio.items()},
                            os.path.join(out_dir,
                                         "idx2feat_token_len_ratio"))
            if idx2nbest:
                write_idx2_file(idx2nbest, os.path.join(out_dir, "idx2nbest"))
            all_results[f"{run_name}/{set_name}" if run_name
                        else set_name] = summary
    return all_results


def tts_alphas(infer_cfg, batch_size: int, token_len: int, device):
    """The controllable-TTS multipliers of ``infer_cfg`` (reference
    runner.py:1120-1139, model/nar_tts.py:706-785): a number is a fixed
    alpha; a ``{alpha_min, alpha_max, granularity, seed}`` dict draws from a
    ``torch.Generator`` seeded with its ``seed`` (not ``jax.random``'s
    draws)."""
    from speechain_tpu_torch.models.nar_tts import generate_ctrl_alpha
    alphas = {}
    for kind in ("duration", "pitch", "energy"):
        a = infer_cfg.get(f"{kind}_alpha")
        if a is None:
            continue
        if isinstance(a, (int, float)):
            alphas[f"{kind}_alpha"] = generate_ctrl_alpha(
                None, batch_size, token_len, alpha=float(a), device=device)
        else:
            import torch
            gen = torch.Generator().manual_seed(int(a.get("seed", 0)))
            alphas[f"{kind}_alpha"] = generate_ctrl_alpha(
                gen, batch_size, token_len,
                alpha_min=float(a.get("alpha_min", 0.8)),
                alpha_max=float(a.get("alpha_max", 1.2)),
                granularity=a.get("granularity", "utterance"),
                device=device)
    return alphas


def tts_test_main(cfg, args, net, net_cfg, tokenizer, customize, name,
                  logger, device):
    """TTS evaluation (reference runner.py:1055-1192): synthesize each test
    set with the first infer_cfg run, FastSpeech2 in one forward with its
    predicted durations (``max_frames``, ``min_frame_num``,
    ``max_frame_num`` and the controllable alphas) or Transformer-TTS
    through the KV-cached loop (``stop_threshold``, ``maxlen_ratio``,
    ``max_frames``; on int8 weights under ``weight_quant``); the features
    recovered to the mel domain, Griffin-Lim (``gl_iters``), ``wav/*.wav``
    and ``idx2wav``, and where the set has reference audio ``idx2mcd`` /
    ``idx2log_f0_rmse``; ``overall_results.md``. A scoring failure is
    logged and the run goes on, as in the reference."""
    import torch

    from speechain_tpu_torch.builders import build_spk2idx
    from speechain_tpu_torch.infer.quantize import serve_quantized
    from speechain_tpu_torch.infer.tts_decoding import make_tts_synthesizer
    from speechain_tpu_torch.models.ar_tts import ARTTSConfig
    from speechain_tpu_torch.ops.griffin_lim import logmel_to_wave
    from speechain_tpu_torch.utils.fileio import (write_idx2data_file,
                                                  write_wav)
    from speechain_tpu_torch.utils.device import set_fp32_matmul_exact
    from speechain_tpu_torch.utils.reports import md_table, write_idx2_file
    from speechain_tpu_torch.utils.tts_eval import log_f0_rmse, mcd

    infer_cfg = next(iter(expand_infer_cfg(
        cfg.get("infer_cfg") or {}).values()))
    if device.type == "cuda":
        set_fp32_matmul_exact()     # float32 products, as the synthesizers
    is_ar = isinstance(net_cfg, ARTTSConfig)
    synth = None
    if is_ar:
        synth = make_tts_synthesizer(
            net, stop_threshold=float(infer_cfg.get("stop_threshold", 0.5)),
            maxlen_ratio=float(infer_cfg.get("maxlen_ratio", 10.0)),
            max_frames=int(infer_cfg.get("max_frames", 1024)))
        # recover_feat below reads the feature norm's statistics, which
        # are never quantized
        qweights = quantize_for_serving(net, infer_cfg, logger)
        if qweights is not None:
            synth = serve_quantized(net, qweights, synth)
    sr = net_cfg.frontend.sr
    spk2idx = build_spk2idx(customize.get("spk_list"))
    result_path = cfg["result_path"]

    def put(batch, key):
        v = batch.get(key)
        return None if v is None else torch.from_numpy(
            np.asarray(v)).to(device)

    all_results = {}
    for set_name in _test_sets(cfg):
        loader = build_data(cfg["data_cfg"], set_name, tokenizer,
                            batch_bucket=args.batch_bucket,
                            time_bucket=args.time_bucket,
                            token_bucket=args.token_bucket, spk2idx=spk2idx)
        out_dir = os.path.join(result_path, name, set_name)
        wav_dir = os.path.join(out_dir, "wav")
        os.makedirs(wav_dir, exist_ok=True)
        idx2wav, idx2mcd, idx2f0 = {}, {}, {}
        synth_s = score_s = 0.0
        for batch in loader.epoch(0):
            t0 = time.perf_counter()
            n = batch["n_real"]
            text, text_len = put(batch, "text"), put(batch, "text_len")
            spk = dict(spk_feat=put(batch, "spk_feat"),
                       spk_ids=put(batch, "spk_ids"))
            with torch.inference_mode():
                if is_ar:
                    out = synth(text, text_len, **spk)
                    feat, feat_len = out["hypo_feat"], out["hypo_feat_len"]
                else:
                    fs_out = net(
                        text, text_len, **spk,
                        max_frames=int(infer_cfg.get("max_frames", 1024)),
                        min_frame_num=int(infer_cfg.get("min_frame_num", 0)),
                        max_frame_num=infer_cfg.get("max_frame_num", 50),
                        **tts_alphas(infer_cfg, text.shape[0], text.shape[1],
                                     device))
                    feat = fs_out["pred_after"]
                    feat_len = fs_out["pred_feat_len"]
                feat = net.recover_feat(feat).float()
                wave, wave_len = logmel_to_wave(
                    feat, feat_len, net_cfg.frontend,
                    n_iter=int(infer_cfg.get("gl_iters", 32)))
            wave = wave.cpu().numpy()
            wave_len = wave_len.cpu().numpy()
            t1 = time.perf_counter()
            synth_s += t1 - t0
            for i in range(n):
                idx = batch["indices"][i]
                hyp = wave[i][:int(wave_len[i])]
                path = os.path.join(wav_dir, f"{idx}.wav")
                write_wav(path, hyp, sr)
                idx2wav[idx] = path
                # objective scores against the reference audio
                if "feat" in batch:
                    ref = np.asarray(batch["feat"][i][
                        :int(batch["feat_len"][i])]).reshape(-1)
                    if ref.dtype == np.int16:
                        ref = ref.astype(np.float32) / 32768.0
                    try:
                        m = mcd(hyp, ref, sr, device=device)
                        if m is not None:
                            idx2mcd[idx] = m
                        f0 = log_f0_rmse(hyp, ref, sr)
                        if f0 is not None:
                            idx2f0[idx] = f0
                    except Exception:
                        logger.exception("tts scoring failed for %s", idx)
            score_s += time.perf_counter() - t1
        write_idx2data_file(idx2wav, os.path.join(out_dir, "idx2wav"))
        summary = {}
        if idx2mcd:
            summary["mcd"] = float(np.mean(list(idx2mcd.values())))
            write_idx2_file({k: f"{v:.3f}" for k, v in idx2mcd.items()},
                            os.path.join(out_dir, "idx2mcd"))
        if idx2f0:
            summary["log_f0_rmse"] = float(np.mean(list(idx2f0.values())))
            write_idx2_file({k: f"{v:.3f}" for k, v in idx2f0.items()},
                            os.path.join(out_dir, "idx2log_f0_rmse"))
        with open(os.path.join(out_dir, "overall_results.md"), "w") as f:
            f.write("# TTS results\n\n" + md_table(
                ["metric", "value"],
                [[k, f"{v:.4f}"] for k, v in summary.items()]) + "\n")
        logger.info("%s: synthesized %d utts %s", set_name, len(idx2wav),
                    summary)
        logger.info("%s: synthesis %.1f ms, scoring %.1f ms", set_name,
                    1e3 * synth_s, 1e3 * score_s)
        all_results[set_name] = summary
    return all_results


def lm_test_main(cfg, args, net, tokenizer, name, logger, device):
    """LM evaluation: test-set perplexity (model/lm.py test flow), each
    batch's perplexity weighted by its real rows."""
    import torch

    from speechain_tpu_torch.models.lm import lm_loss
    from speechain_tpu_torch.utils.reports import md_table

    result_path = cfg["result_path"]
    all_results = {}
    for set_name in _test_sets(cfg):
        loader = build_data(cfg["data_cfg"], set_name, tokenizer,
                            batch_bucket=args.batch_bucket,
                            time_bucket=args.time_bucket,
                            token_bucket=args.token_bucket)
        ppls, weights = [], []
        with torch.inference_mode():
            for batch in loader.epoch(0):
                text = torch.from_numpy(batch["text"]).to(device)
                text_len = torch.from_numpy(batch["text_len"]).to(device)
                logits, _ = net(text, text_len)
                _, metrics = lm_loss(logits, text, text_len)
                ppls.append(float(metrics["text_ppl"]))
                weights.append(batch["n_real"])
        ppl = float(np.average(ppls, weights=weights)) if ppls else None
        out_dir = os.path.join(result_path, name, set_name)
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "overall_results.md"), "w") as f:
            f.write("# LM results\n\n" + md_table(
                ["metric", "value"], [["text_ppl", f"{ppl:.4f}"]]) + "\n")
        logger.info("%s: text_ppl=%.4f", set_name, ppl)
        all_results[set_name] = dict(text_ppl=ppl)
    return all_results


def main(argv=None):
    args = parse_args(argv)
    check_single_card(args)
    cfg = merge_config(args)
    out = None
    if args.train:
        out = train_main(cfg, args)
    if args.test:
        out = test_main(cfg, args)
    return out


if __name__ == "__main__":
    main()
