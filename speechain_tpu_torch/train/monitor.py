"""Observability: step/epoch records, wall-clock tracing, TensorBoard +
matplotlib snapshots off the training thread (counterpart of
``speechain_tpu/train/monitor.py``: the same records and files, with
:func:`model_summary` on the net's named parameters and
:meth:`TrainValidMonitor.log_device_memory` on ``torch.cuda``'s
statistics). A snapshot whose writer fails (matplotlib or tensorboardX
missing) is logged and training goes on, as in the reference.

Rebuild of reference ``speechain/monitor.py`` + ``snapshooter.py``:
- ``measure_time`` context manager (monitor.py:126-148) for
  data-load/forward/backward/optim timing aggregated per step-group;
- per-N-step train reports and epoch mean±std summaries (monitor.py:289-505);
- figure/TensorBoard snapshotting in a background worker fed by a queue
  (monitor.py:87-100, snapshooter.py:352-491) — a daemon thread here
  (matplotlib Agg is thread-safe for our usage; the step loop releases the
  GIL while the device works);
- TestMonitor's idx2-file dumps, overall_results.md with group tables and
  top-N bad cases (monitor.py:1672-1837) live in ``utils/reports.py``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import queue
import threading
import time
from collections import defaultdict
from typing import Any, Dict, List, Mapping, Optional

import numpy as np


def setup_logger(log_path: str, name: str = "speechain_tpu_torch"
                 ) -> logging.Logger:
    """Per-run file+stdout logger (utilbox/log_util.py:38)."""
    logger = logging.getLogger(f"{name}:{log_path}")
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
    fh = logging.FileHandler(log_path)
    sh = logging.StreamHandler()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    fh.setFormatter(fmt)
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)
    logger.propagate = False
    return logger


def model_summary(params: Mapping[str, Any], name: str = "model") -> str:
    """Human-readable parameter table (utilbox/log_util.py:98-166) of a
    state dict (name -> tensor; the runner passes the net's named
    parameters): per top-level module counts, total, and fp32 size."""

    def human(n: float) -> str:
        for label, div in (("B", 1e9), ("M", 1e6), ("K", 1e3)):
            if n >= div:
                return f"{n / div:.2f} {label}"
        return f"{n:.0f}"

    groups: Dict[str, int] = {}
    for key, leaf in params.items():
        top = key.split(".", 1)[0] if key else "(root)"
        groups[top] = groups.get(top, 0) + int(np.prod(tuple(leaf.shape)))
    total = sum(groups.values())
    width = max((len(k) for k in groups), default=4)
    lines = [f"Model summary: {name}"]
    for k in sorted(groups, key=groups.get, reverse=True):
        lines.append(f"    {k:<{width}}  {human(groups[k]):>9}  "
                     f"({groups[k] * 100.0 / max(total, 1):5.1f}%)")
    lines.append(f"    {'TOTAL':<{width}}  {human(total):>9}  "
                 f"(fp32 size {human(total * 4)}B)")
    return "\n".join(lines)


class SnapShooter:
    """Background figure/TensorBoard writer fed by a queue
    (snapshooter.py:352-491)."""

    def __init__(self, result_path: str, tb_subdir: str = "train"):
        self.result_path = result_path
        self.figure_dir = os.path.join(result_path, "figures")
        os.makedirs(self.figure_dir, exist_ok=True)
        self._tb = None
        try:
            from tensorboardX import SummaryWriter
            self._tb = SummaryWriter(
                os.path.join(result_path, "tensorboard", tb_subdir))
        except Exception:
            pass
        self.queue: "queue.Queue" = queue.Queue()
        self._stop = object()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def snapshot(self, materials: Dict[str, List], step: int,
                 plot_type: str = "curve", **kw):
        """Enqueue one artifact write. Optional kwargs:

        - ``subfolder``: route every material under
          ``figures/<subfolder>/`` (the reference's per-sample
          ``subfolder_names``, snapshooter.py:426-434);
        - ``x_stride``: epochs between points of a curve / lines of a text
          history (snapshooter.py:573, 758);
        - ``sample_rate``: audio write rate.
        """
        self.queue.put((plot_type, materials, step, kw))

    def _worker(self):
        while True:
            item = self.queue.get()
            if item is self._stop:
                break
            try:
                self._handle(*item)
            except Exception:  # snapshot failures must never kill training
                logging.getLogger(__name__).exception("snapshot failed")

    def _handle(self, plot_type: str, materials: Dict, step: int,
                kw: Optional[Dict] = None):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        kw = kw or {}
        subfolder = kw.get("subfolder")
        x_stride = int(kw.get("x_stride", 1) or 1)
        base = (os.path.join(self.figure_dir, subfolder)
                if subfolder else self.figure_dir)

        if plot_type == "matrix_grid":
            # one summary figure of ALL materials as subplots + one .npz
            # holding every named matrix (the reference's sum_save grid +
            # MatrixPlotter.save, snapshooter.py:680-720)
            os.makedirs(base, exist_ok=True)
            mats = {k: np.asarray(v, dtype=np.float32)
                    for k, v in materials.items()}
            np.savez(os.path.join(base, f"epoch{step}.npz"), **mats)
            n = max(len(mats), 1)
            cols = int(np.ceil(np.sqrt(n)))
            rows = int(np.ceil(n / cols))
            fig, axes = plt.subplots(rows, cols,
                                     figsize=(3.2 * cols, 2.6 * rows),
                                     squeeze=False)
            for i, (mname, mat) in enumerate(sorted(mats.items())):
                ax = axes[i // cols][i % cols]
                ax.imshow(mat, aspect="auto", origin="lower")
                ax.set_title(mname, fontsize=7)
                ax.tick_params(labelsize=5)
            for j in range(len(mats), rows * cols):
                axes[j // cols][j % cols].axis("off")
            fig.tight_layout()
            fig.savefig(os.path.join(base, f"epoch{step}.png"), dpi=80)
            plt.close(fig)
            return

        for name, values in materials.items():
            sub = base if subfolder else os.path.join(base, name)
            os.makedirs(sub, exist_ok=True)
            if plot_type == "curve":
                arr = np.asarray(values, dtype=float)
                xs = np.arange(len(arr)) * x_stride + (x_stride if subfolder
                                                       else 0)
                np.savetxt(os.path.join(sub, f"{name}.txt"),
                           np.stack([xs, arr], -1) if x_stride > 1 else arr)
                fig, ax = plt.subplots(figsize=(6, 4))
                ax.plot(xs, arr)
                ax.set_title(name)
                ax.set_xlabel("epoch" if x_stride > 1 else "step")
                fig.savefig(os.path.join(sub, f"{name}.png"), dpi=80)
                plt.close(fig)
                if self._tb is not None:
                    tag = f"{subfolder}/{name}" if subfolder else name
                    self._tb.add_scalar(tag, float(arr[-1]), step)
            elif plot_type == "matrix":
                arr = np.asarray(values)
                np.savez(os.path.join(sub, f"{name}_{step}.npz"), arr)
                fig, ax = plt.subplots(figsize=(6, 4))
                ax.imshow(arr, aspect="auto", origin="lower")
                fig.savefig(os.path.join(sub, f"{name}_{step}.png"), dpi=80)
                plt.close(fig)
            elif plot_type == "hist":
                arr = np.asarray(values, dtype=float)
                fig, ax = plt.subplots(figsize=(6, 4))
                ax.hist(arr, bins=50)
                fig.savefig(os.path.join(sub, f"{name}_{step}.png"), dpi=80)
                plt.close(fig)
            elif plot_type == "text":
                # full history rewrite, one "epoch<TAB>text" line per entry
                # (reference text_snapshot's np.savetxt of (x_axis, material)
                # pairs, snapshooter.py:736-763); a bare string appends
                if isinstance(values, (list, tuple)):
                    with open(os.path.join(sub, f"{name}.txt"), "w") as f:
                        for i, line in enumerate(values):
                            f.write(f"{i * x_stride + x_stride}\t{line}\n")
                else:
                    with open(os.path.join(sub, f"{name}.txt"), "a") as f:
                        f.write(f"step {step}: {values}\n")
                if self._tb is not None and isinstance(values, (list, tuple)) \
                        and values:
                    tag = f"{subfolder}/{name}" if subfolder else name
                    self._tb.add_text(tag, str(values[-1]), step)
            elif plot_type == "audio":
                # validation-sample listening (snapshooter.py:405-491):
                # values = (wave, sample_rate) or a bare wave at 16 kHz
                import wave as wavemod
                if isinstance(values, tuple):
                    arr, sr = values
                else:
                    arr, sr = values, int(kw.get("sample_rate", 16000))
                arr = np.asarray(arr, dtype=np.float32).reshape(-1)
                pcm = (np.clip(arr, -1.0, 1.0) * 32767).astype("<i2")
                path = os.path.join(sub, f"{name}_{step}.wav")
                with wavemod.open(path, "wb") as f:
                    f.setnchannels(1)
                    f.setsampwidth(2)
                    f.setframerate(int(sr))
                    f.writeframes(pcm.tobytes())
                if self._tb is not None:
                    try:  # tensorboardX audio needs soundfile (optional)
                        self._tb.add_audio(name, arr[None], step,
                                           sample_rate=int(sr))
                    except Exception:
                        pass

    def wait_empty(self, timeout: float = 60.0):
        t0 = time.time()
        while not self.queue.empty() and time.time() - t0 < timeout:
            time.sleep(0.05)

    def close(self):
        self.queue.put(self._stop)
        self._thread.join(timeout=5)
        if self._tb is not None:
            self._tb.close()


class TrainValidMonitor:
    """Step/epoch bookkeeping for train+valid (monitor.py:368-1375)."""

    def __init__(self, result_path: str, logger: Optional[logging.Logger]
                 = None, report_per_steps: int = 100):
        self.result_path = result_path
        self.logger = logger or logging.getLogger(__name__)
        self.report_per_steps = report_per_steps
        self.shooter = SnapShooter(result_path)
        self.step_records: Dict[str, List[float]] = defaultdict(list)
        self.time_records: Dict[str, List[float]] = defaultdict(list)
        self.epoch_records: Dict[str, Dict[str, List[float]]] = dict(
            train=defaultdict(list), valid=defaultdict(list))
        self.step = 0

    @contextlib.contextmanager
    def measure_time(self, name: str, n: int = 1):
        """Time a block; with ``n > 1`` (a K-step dispatch) record the
        per-step time n times so step counts and means stay honest."""
        t0 = time.perf_counter()
        yield
        dt = (time.perf_counter() - t0) / max(1, n)
        self.time_records[name].extend([dt] * max(1, n))

    def train_step(self, metrics: Dict[str, Any], lr: Optional[float] = None):
        self.step += 1
        for k, v in metrics.items():
            self.step_records[k].append(float(v))
        if lr is not None:
            self.step_records["lr"].append(float(lr))
        if self.step % self.report_per_steps == 0:
            window = {k: np.mean(v[-self.report_per_steps:])
                      for k, v in self.step_records.items()}
            times = {k: np.mean(v[-self.report_per_steps:])
                     for k, v in self.time_records.items()}
            self.logger.info(
                "step %d | %s | %s", self.step,
                " ".join(f"{k}={v:.4f}" for k, v in window.items()),
                " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in times.items()))

    def finish_train_epoch(self, epoch: int):
        self._finish_epoch("train", epoch)

    def record_trainable_scalars(self, params: Mapping[str, Any], epoch: int,
                                 names: tuple = ("alpha",)):
        """Track scalar trainable parameters (e.g. the Transformer-TTS
        positional-encoding alpha) as per-epoch curves — the reference's
        get_recordable_para recursion (module/abs.py:140-173) plotted by the
        valid monitor (monitor.py:741-771). ``params``: name -> tensor (the
        net's named parameters); a key is the flax path's form,
        ``a/b/alpha``."""
        for name, leaf in params.items():
            if getattr(leaf, "ndim", None) != 0:
                continue
            key = name.replace(".", "/")
            if names and not any(key.endswith(n) for n in names):
                continue
            val = float(leaf)
            recs = self.epoch_records.setdefault("para", defaultdict(list))
            recs[key].append(val)
            self.logger.info("epoch %d recordable para %s: %.6f",
                             epoch, key, val)
            self.shooter.snapshot({f"para_{key}": recs[key]}, epoch)

    def valid_step(self, metrics: Dict[str, Any]):
        for k, v in metrics.items():
            self.step_records[f"valid_{k}"].append(float(v))

    def finish_valid_epoch(self, epoch: int) -> Dict[str, float]:
        return self._finish_epoch("valid", epoch)

    def log_device_memory(self):
        """Device memory snapshot (SURVEY §5.1: the reference samples GPU
        memory with GPUtil per epoch): ``torch.cuda``'s allocated bytes and
        their peak; nothing without a card."""
        import torch
        if not torch.cuda.is_available():
            return
        stats = torch.cuda.memory_stats()
        used = stats.get("allocated_bytes.all.current", 0) / 2 ** 30
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        self.logger.info("device memory: %.2f GiB in use, %.2f GiB peak",
                         used, peak)

    def _finish_epoch(self, phase: str, epoch: int) -> Dict[str, float]:
        prefix = "valid_" if phase == "valid" else ""
        out = {}
        keys = [k for k in self.step_records
                if (k.startswith("valid_")) == (phase == "valid")]
        for k in keys:
            vals = self.step_records.pop(k)
            mean, std = float(np.mean(vals)), float(np.std(vals))
            name = k[len(prefix):] if prefix and k.startswith(prefix) else k
            self.epoch_records[phase][name].append(mean)
            out[name] = mean
            self.logger.info("epoch %d %s %s: %.4f ± %.4f",
                             epoch, phase, name, mean, std)
            self.shooter.snapshot(
                {f"{phase}_{name}": self.epoch_records[phase][name]}, epoch)
        for k in list(self.time_records):
            self.time_records.pop(k)
        return out

    def state_dict(self):
        return dict(step=self.step,
                    epoch_records={p: dict(r) for p, r in
                                   self.epoch_records.items()})

    def load_state_dict(self, d):
        self.step = d["step"]
        for p, recs in d["epoch_records"].items():
            self.epoch_records[p] = defaultdict(list, recs)

    def close(self):
        self.shooter.wait_empty()
        self.shooter.close()
