"""Checkpointing: the full train state for ``--resume`` and the
reference's best / latest model bookkeeping (counterpart of
``speechain_tpu/train/checkpoint.py``, :25-258, with ``torch.save`` of CPU
state dicts in place of orbax).

Layout under ``exp_dir``:

    checkpoint/state.pt     the latest full train state: the net's
                            ``state_dict``, the optimizer state, the step
    checkpoint_meta.json    epoch cursor, monitor and tracker records
    models/epoch_{n}/model.pt       the net's ``state_dict`` after epoch n
    models/{n}_{metric}_average/model.pt   N-best parameter average
    models/registry.json    best / kept / latest epochs and their records

A save copies the state to host memory at once (the step updates the net
in place, so the writer must never read live tensors), writes it to
``<path>.tmp`` on a background thread, and commits (renames the tmp
directory over the old one and writes the metadata) at the next save,
restore or :meth:`CheckpointManager.close`, as the reference's ``_drain``
does. A save whose commit never ran leaves the previous checkpoint whole.

Single process: the reference's multi-host barriers have no counterpart
(ROADMAP A8).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional

import torch

STATE_FILE = "state.pt"
MODEL_FILE = "model.pt"


def to_host(tree: Any) -> Any:
    """A copy of ``tree`` (dicts, lists and tuples of tensors and plain
    values) with every tensor detached and copied to CPU memory."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def to_device(tree: Any, device: torch.device) -> Any:
    """``tree`` with every tensor moved to ``device``."""
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree


def mutable_buffer(name: str) -> bool:
    """Whether the net's buffer ``name`` is one of the reference's
    mutables (BatchNorm ``batch_stats``, feature-norm ``norm_stats``),
    which an averaged model does not hold; the positional tables are
    constants and never saved."""
    *parents, leaf = name.split(".")
    return leaf in ("running_mean", "running_var") or (
        bool(parents) and parents[-1] == "stats")


def load_model(path: str) -> Dict[str, torch.Tensor]:
    """The state dict saved under ``path`` (an epoch or averaged model's
    directory)."""
    return torch.load(os.path.join(path, MODEL_FILE), map_location="cpu",
                      weights_only=True)


class CheckpointManager:
    """Save and restore under ``exp_dir`` (the module docstring's
    layout); ``async_save`` False writes and commits within the call."""

    def __init__(self, exp_dir: str, async_save: bool = True):
        self.exp_dir = os.path.abspath(exp_dir)
        self.models_dir = os.path.join(self.exp_dir, "models")
        os.makedirs(self.models_dir, exist_ok=True)
        self._async = bool(async_save)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending: Optional[Callable[[], None]] = None

    def _drain(self):
        """Wait for the write in flight, then commit it."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error, self._pending = self._error, None, None
            raise RuntimeError("checkpoint write failed") from err
        if self._pending is not None:
            fn, self._pending = self._pending, None
            fn()

    def close(self):
        """Finish the save in flight (call at the end of training)."""
        self._drain()

    def _write(self, tmp: str, file: str, payload: Any,
               commit: Callable[[], None]):
        """Write ``payload`` to ``tmp/file``; commit now (sync) or at the
        next :meth:`_drain` (async)."""
        self._drain()
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

        def write():
            try:
                torch.save(payload, os.path.join(tmp, file))
            except BaseException as e:    # re-raised by _drain
                self._error = e

        self._pending = commit
        if self._async:
            self._writer = threading.Thread(target=write, daemon=True)
            self._writer.start()
        else:
            write()
            self._drain()

    @staticmethod
    def _rename(tmp: str, path: str):
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)

    # ---------------- full-state resume point ---------------------------
    def save_train_state(self, state, extra: Optional[Dict] = None):
        """Save a :class:`~speechain_tpu_torch.train.state.TrainState`
        (the net's state dict, the optimizer state, the step) and, at
        commit, ``extra`` as ``checkpoint_meta.json``."""
        path = os.path.join(self.exp_dir, "checkpoint")
        payload = to_host(dict(net=state.net.state_dict(),
                               opt_state=state.opt_state, step=state.step))

        def commit():
            self._rename(path + ".tmp", path)
            if extra is not None:
                with open(os.path.join(self.exp_dir,
                                       "checkpoint_meta.json"), "w") as f:
                    json.dump(extra, f)

        self._write(path + ".tmp", STATE_FILE, payload, commit)

    def restore_train_state(self, state):
        """(``state`` with the saved net, optimizer state and step, on the
        device of ``state.net``; the metadata or None)."""
        self._drain()
        payload = torch.load(os.path.join(self.exp_dir, "checkpoint",
                                          STATE_FILE),
                             map_location="cpu", weights_only=True)
        net = state.net
        net.load_state_dict(payload["net"], strict=True)
        dev = state.step.device
        restored = type(state)(payload["step"].to(dev), net,
                               to_device(payload["opt_state"], dev))
        meta_path = os.path.join(self.exp_dir, "checkpoint_meta.json")
        meta = None
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        return restored, meta

    def restore_net_state(self) -> Dict[str, torch.Tensor]:
        """The net's state dict of the resume checkpoint (``latest``)."""
        self._drain()
        return torch.load(os.path.join(self.exp_dir, "checkpoint",
                                       STATE_FILE),
                          map_location="cpu", weights_only=True)["net"]

    def has_checkpoint(self) -> bool:
        self._drain()
        return os.path.exists(os.path.join(self.exp_dir, "checkpoint"))

    # ---------------- per-epoch model snapshots -------------------------
    def save_epoch_model(self, epoch: int, net: torch.nn.Module):
        """The net's state dict (parameters and mutables) after
        ``epoch``."""
        path = os.path.join(self.models_dir, f"epoch_{epoch}")
        self._write(path + ".tmp", MODEL_FILE, to_host(net.state_dict()),
                    lambda: self._rename(path + ".tmp", path))

    def restore_epoch_model(self, epoch: int) -> Dict[str, torch.Tensor]:
        self._drain()
        return load_model(os.path.join(self.models_dir, f"epoch_{epoch}"))

    def prune_epochs(self, keep: List[int]):
        """Delete the epoch models not in ``keep`` (monitor.py:959-971)."""
        self._drain()
        keep_set = {f"epoch_{e}" for e in keep}
        for name in os.listdir(self.models_dir):
            if name.startswith("epoch_") and name not in keep_set:
                shutil.rmtree(os.path.join(self.models_dir, name),
                              ignore_errors=True)

    def average_models(self, epochs: List[int], param_names: List[str],
                       name: str = "average") -> Dict[str, torch.Tensor]:
        """N-best parameter averaging (monitor.py:1031-1121), as the
        reference's: the parameters ``param_names`` of the epochs' models
        summed in float64, the mean cast to float32, saved alone under
        ``models/{len(epochs)}_{name}`` (the mutables are not averaged and
        not saved, ``speechain_tpu/train/checkpoint.py:196``)."""
        if not epochs:
            raise ValueError("cannot average zero checkpoints")
        acc: Dict[str, torch.Tensor] = {}
        for e in epochs:
            model = self.restore_epoch_model(e)
            for k in param_names:
                x = model[k].to(torch.float64)
                acc[k] = acc[k] + x if k in acc else x
        avg = {k: (a / float(len(epochs))).to(torch.float32)
               for k, a in acc.items()}
        path = os.path.join(self.models_dir, f"{len(epochs)}_{name}")
        self._write(path + ".tmp", MODEL_FILE, avg,
                    lambda: self._rename(path + ".tmp", path))
        return avg


class BestModelTracker:
    """best_model_selection bookkeeping (monitor.py:647-1027): track the top
    N epochs per (metric, mode) rule, decide retention, early stopping.
    A copy of the reference's."""

    def __init__(self, rules: List, last_n: int = 1,
                 early_stopping_patience: int = 10,
                 early_stopping_threshold: float = 0.0):
        # rule: (metric_name, 'min'|'max', keep_n)
        self.rules = [tuple(r) for r in rules] or [("loss", "min", 5)]
        self.last_n = last_n
        self.records: Dict[int, Dict[str, float]] = {}
        self.patience = early_stopping_patience
        self.threshold = early_stopping_threshold
        self._best_so_far: Optional[float] = None
        self._bad_epochs = 0

    def update(self, epoch: int, metrics: Dict[str, float]) -> Dict:
        self.records[epoch] = dict(metrics)
        keep = set()
        best_per_rule = {}
        for metric, mode, n in self.rules:
            scored = [(ep, rec[metric]) for ep, rec in self.records.items()
                      if metric in rec]
            scored.sort(key=lambda kv: kv[1], reverse=(mode == "max"))
            chosen = [ep for ep, _ in scored[: int(n)]]
            keep.update(chosen)
            if chosen:
                best_per_rule[metric] = chosen
        recent = sorted(self.records)[-self.last_n:]
        keep.update(recent)

        # early stopping on the first rule's metric (monitor.py:973-1027)
        metric, mode, _ = self.rules[0]
        cur = metrics.get(metric)
        stop = False
        if cur is not None:
            improved = (self._best_so_far is None
                        or (mode == "min"
                            and cur < self._best_so_far - self.threshold)
                        or (mode == "max"
                            and cur > self._best_so_far + self.threshold))
            if improved:
                self._best_so_far = cur
                self._bad_epochs = 0
            else:
                self._bad_epochs += 1
                stop = self._bad_epochs >= self.patience
        return dict(keep=sorted(keep), best=best_per_rule,
                    early_stop=stop, bad_epochs=self._bad_epochs)

    def state_dict(self):
        return dict(records=self.records, best_so_far=self._best_so_far,
                    bad_epochs=self._bad_epochs)

    def load_state_dict(self, d):
        self.records = {int(k): v for k, v in d["records"].items()}
        self._best_so_far = d["best_so_far"]
        self._bad_epochs = d["bad_epochs"]
