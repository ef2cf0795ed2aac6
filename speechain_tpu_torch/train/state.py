"""Train state and the ASR, Transformer-TTS, FastSpeech2 and LM steps
(counterpart of ``speechain_tpu/train/state.py``, :21-234).

The JAX package's state is an immutable pytree; the port's
:class:`TrainState` holds the network itself (parameters and the running
statistics that the reference keeps in ``mutables``: feature-norm and
BatchNorm buffers), the optimizer state and the step count, and a step
updates them in place. Single device only: ``axis_name=None`` semantics,
no gradient all-reduce and no metric averaging across replicas.

A step: the network in training (or evaluation) mode, every random draw
from the caller's ``torch.Generator`` (dropout seeds and SpecAugment,
``ops/dropout.py::step_rng``), forward, :func:`arasr_loss`, gradients,
and the optimizer update. Metrics stay on the device (no ``.item()``).
A ``train=False`` step computes the metrics in evaluation mode without
gradients and leaves the parameters and statistics untouched.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Union

import torch

from speechain_tpu_torch.nn.moe import collect_losses
from speechain_tpu_torch.ops.dropout import step_rng
from speechain_tpu_torch.utils.device import (resolve_device,
                                              set_fp32_matmul_exact)


class TrainState(NamedTuple):
    step: torch.Tensor          # 0-d int32 on the device
    net: torch.nn.Module        # parameters + running statistics
    opt_state: Dict[str, Any]


def init_train_state(net: torch.nn.Module, tx,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> TrainState:
    """Move ``net`` to the device (the card unless ``device="cpu"``) and
    initialize the optimizer state over its parameters."""
    dev = resolve_device(device)
    net.to(dev)
    named = [(n, p) for n, p in net.named_parameters() if p.requires_grad]
    return TrainState(torch.zeros((), dtype=torch.int32, device=dev), net,
                      tx.init([p for _, p in named], [n for n, _ in named]))


def _to_device(v, dev: torch.device):
    """A batch entry on the device; a CPU tensor bound for a card goes
    through pinned memory, so the copy does not wait for the device."""
    if not torch.is_tensor(v):
        return v
    if dev.type == "cuda" and v.device.type == "cpu":
        v = v.pin_memory()
    return v.to(dev, non_blocking=True)


def _make_step(apply_loss: Callable, tx, train: bool,
               dev: torch.device) -> Callable:
    """The shared step skeleton (reference ``_generic_train_step``,
    state.py:119-147): the batch on the device, the network in training
    or evaluation mode, ``apply_loss(model, batch) -> (loss, metrics)``
    under the step's generator, the auxiliary losses of that forward
    (Switch-MoE load balancing, ``nn/moe.py``) added to the loss and
    reported as ``moe_aux`` (state.py:87-92), and in training the
    gradients and the optimizer update. The step count counts every
    call, gradient accumulation's included, as the reference's does."""

    def step_fn(state: TrainState, batch: Dict[str, Any],
                generator: torch.Generator):
        b = {k: _to_device(v, dev) for k, v in batch.items()}
        model = state.net
        model.train(train)
        with step_rng(generator), torch.set_grad_enabled(train):
            with collect_losses() as aux:
                loss, metrics = apply_loss(model, b)
            if aux:
                moe_aux = sum(aux)
                loss = loss + moe_aux
                metrics = dict(metrics, moe_aux=moe_aux)
            if train:
                params = [p for p in model.parameters() if p.requires_grad]
                grads = torch.autograd.grad(loss, params)
        if train:
            opt_state = tx.update(grads, state.opt_state, params)
            state = TrainState(state.step + 1, model, opt_state)
        return state, {k: v.detach() for k, v in metrics.items()}

    return step_fn


def make_arasr_step(net: torch.nn.Module, cfg, tx, *,
                    axis_name: Optional[str] = None, train: bool = True,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Callable:
    """step(state, batch, generator) -> (state, metrics); batch holds
    feat / feat_len / text / text_len (and optionally epoch, group_ids),
    moved to the device here."""
    from speechain_tpu_torch.models.ar_asr import arasr_loss
    if axis_name is not None:
        raise NotImplementedError("multi-card training is not ported yet")
    dev = resolve_device(device)

    def apply_loss(model, b):
        group_ids = b.get("group_ids")
        fn_cfg = getattr(cfg, "feat_norm", None)
        if group_ids is None and fn_cfg is not None \
                and fn_cfg.norm_type == "group":
            group_ids = b.get("spk_ids")
        outputs = model(b["feat"], b["feat_len"], b["text"], b["text_len"],
                        epoch=b.get("epoch"), group_ids=group_ids)
        return arasr_loss(outputs, b["text"], b["text_len"], cfg)

    return _make_step(apply_loss, tx, train, dev)


def make_artts_step(net: torch.nn.Module, cfg, tx, *,
                    axis_name: Optional[str] = None, train: bool = True,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Callable:
    """step(state, batch, generator) -> (state, metrics) for
    Transformer-TTS (reference state.py:150-176); batch holds text /
    text_len and the waveform feat (B, L, 1) / feat_len (and optionally
    epoch, spk_ids, spk_feat). On the card float32 products are kept
    exact (``set_fp32_matmul_exact``), as the target frontend needs."""
    from speechain_tpu_torch.models.ar_tts import artts_loss
    if axis_name is not None:
        raise NotImplementedError("multi-card training is not ported yet")
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_fp32_matmul_exact()

    def apply_loss(model, b):
        outputs = model(b["text"], b["text_len"], b["feat"], b["feat_len"],
                        spk_feat=b.get("spk_feat"), spk_ids=b.get("spk_ids"),
                        epoch=b.get("epoch"))
        return artts_loss(outputs, cfg)

    return _make_step(apply_loss, tx, train, dev)


def make_fastspeech2_step(net: torch.nn.Module, cfg, tx, *,
                          axis_name: Optional[str] = None,
                          train: bool = True,
                          device: Optional[Union[str, torch.device]] = None
                          ) -> Callable:
    """step(state, batch, generator) -> (state, metrics) for FastSpeech2
    (reference state.py:179-210); batch holds text / text_len, the
    waveform feat (B, L, 1) / feat_len, the frame-level pitch / pitch_len
    and the teacher duration / duration_len (and optionally epoch,
    spk_ids, spk_feat). On the card float32 products are kept exact
    (``set_fp32_matmul_exact``), as the target frontend needs."""
    from speechain_tpu_torch.models.nar_tts import fastspeech2_loss
    if axis_name is not None:
        raise NotImplementedError("multi-card training is not ported yet")
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_fp32_matmul_exact()

    def apply_loss(model, b):
        outputs = model(b["text"], b["text_len"], b["feat"], b["feat_len"],
                        b["pitch"], b["pitch_len"], b["duration"],
                        b["duration_len"], spk_feat=b.get("spk_feat"),
                        spk_ids=b.get("spk_ids"), epoch=b.get("epoch"))
        return fastspeech2_loss(outputs, b["duration"], cfg)

    return _make_step(apply_loss, tx, train, dev)


def make_lm_step(net: torch.nn.Module, tx, *, label_smoothing: float = 0.0,
                 axis_name: Optional[str] = None, train: bool = True,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> Callable:
    """step(state, batch, generator) -> (state, metrics) for the language
    model (reference state.py:213-234); batch holds text (<sos/eos> at
    both ends) / text_len."""
    from speechain_tpu_torch.models.lm import lm_loss
    if axis_name is not None:
        raise NotImplementedError("multi-card training is not ported yet")
    dev = resolve_device(device)

    def apply_loss(model, b):
        logits, _ = model(b["text"], b["text_len"])
        return lm_loss(logits, b["text"], b["text_len"],
                       label_smoothing=label_smoothing)

    return _make_step(apply_loss, tx, train, dev)
