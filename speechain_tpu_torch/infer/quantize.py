"""Weight-only int8 serving (counterpart of
``speechain_tpu/infer/quantize.py``, :44-110): ``infer_cfg: weight_quant:
int8``.

:func:`quantize_state_dict` replaces each large float weight of a state
dict with an :class:`Int8Weight`: symmetric per-channel int8 with
``scale = max|w| / 127`` over every axis but the channel axis (clamped at
1e-12), the values rounded half to even and clipped to +-127. Left
alone: buffers (running and feature-norm statistics, positional tables:
the reference quantizes the ``params`` collection alone), leaves of rank
< 2, of fewer than ``min_elems`` elements or of a non-float dtype.
:func:`dequantize_state_dict` widens each back to its own dtype and is
the identity on a float state.

The channel axis is the reference's, which it defines in flax's layout:
the last axis of a kernel (its out features) and the first of a table
whose flax leaf name holds "embed" (one scale a row). The leaf name and
the layout come from ``utils/weights.py`` (``flax_param_path``,
``_flax_shape``), not from the torch name or shape: a torch ``Linear`` is
(out, in) and a ``Conv1d`` (out, in, k), so a kernel's channel is torch
axis 0. The int8 values and scales therefore equal the JAX package's bit
for bit on weights bridged from flax (``tests/test_torch_port_
quantize.py``).

:func:`serve_quantized` dequantizes once, at the top of each call of a
decoder or synthesizer, into the network's parameters, and puts the
float ones back after it, as the reference dequantizes at the top of
each jitted entry point (``infer/asr.py:179-201``,
``infer/tts_decoding.py:35-40``): the same kernels run on the
dequantized weights. The float network stays, as the reference keeps
its float tree beside the quantized one (``runner.py:1076-1078``).
"""

from __future__ import annotations

from typing import Any, Callable, Collection, Dict, NamedTuple, Optional
from typing import Tuple

import torch

from speechain_tpu_torch.utils.weights import _flax_shape, flax_param_path


class Int8Weight(NamedTuple):
    q8: torch.Tensor            # int8, the parameter's torch layout
    scale: torch.Tensor         # float32, broadcastable against q8
    dtype: torch.dtype          # the parameter's own dtype


def channel_axis(name: str, shape) -> int:
    """The torch axis of ``name``'s channel: flax's last axis of a kernel
    (out features), its first of an "embed" leaf, its last otherwise,
    carried through the bridge's layout."""
    shape = tuple(shape)
    leaf = flax_param_path(name, len(shape))[-1]
    flax_shape = _flax_shape(name, shape)
    if "embed" in leaf.lower():
        return 0
    if leaf == "kernel":
        # every kernel layout of the bridge puts flax's last axis (out
        # features) first in torch: (out, in), (out, in, k), OIHW
        assert shape[0] == flax_shape[-1], (name, shape, flax_shape)
        return 0
    return len(shape) - 1


def quantize_tensor(w: torch.Tensor, axis: int) -> Int8Weight:
    """Symmetric int8 of ``w`` with one scale along ``axis``, computed on
    the host (a card divides by the scalar 127 as a product with its
    reciprocal, which rounds otherwise than the reference's division) and
    put back on ``w``'s device."""
    x = w.detach().float().cpu()
    red = tuple(i for i in range(x.ndim) if i != axis)
    scale = torch.clamp(torch.amax(x.abs(), dim=red, keepdim=True) / 127.0,
                        min=1e-12)
    q8 = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return Int8Weight(q8.to(w.device), scale.to(w.device), w.dtype)


def quantize_state_dict(state: Dict[str, torch.Tensor], min_elems: int = 8192,
                        *, params: Optional[Collection[str]] = None
                        ) -> Dict[str, Any]:
    """``state`` with each large float weight an :class:`Int8Weight`.
    ``params`` names the parameters among its entries (a network's
    ``named_parameters``); None: every entry is one."""
    out: Dict[str, Any] = {}
    for name, w in state.items():
        is_param = params is None or name in params
        if (not is_param or w.ndim < 2 or w.numel() < min_elems
                or not torch.is_floating_point(w)):
            out[name] = w
            continue
        out[name] = quantize_tensor(w, channel_axis(name, w.shape))
    return out


def dequantize(q: Int8Weight) -> torch.Tensor:
    return (q.q8.float() * q.scale).to(q.dtype)


def dequantize_state_dict(state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The float state of a quantized one (the identity on a float
    state)."""
    return {k: dequantize(v) if isinstance(v, Int8Weight) else v
            for k, v in state.items()}


def quantized_bytes(state: Dict[str, Any]) -> Tuple[int, int]:
    """(bytes now, bytes if dequantized) of every tensor in ``state``: the
    serving footprint the runner logs."""
    now = deq = 0
    for v in state.values():
        if isinstance(v, Int8Weight):
            now += v.q8.numel() + v.scale.numel() * v.scale.element_size()
            deq += v.q8.numel() * torch.empty((), dtype=v.dtype) \
                .element_size()
        else:
            n = v.numel() * v.element_size()
            now += n
            deq += n
    return now, deq


def quantize_net(net: torch.nn.Module, min_elems: int = 8192
                 ) -> Dict[str, Int8Weight]:
    """The :class:`Int8Weight` of each of ``net``'s quantized parameters,
    on the parameters' device."""
    q = quantize_state_dict(dict(net.named_parameters()), min_elems)
    return {k: v for k, v in q.items() if isinstance(v, Int8Weight)}


def serve_quantized(net: torch.nn.Module, qweights: Dict[str, Int8Weight],
                    fn: Callable) -> Callable:
    """``fn`` (a decoder or synthesizer over ``net``) run on the int8
    weights: at the top of each call ``net``'s quantized parameters take
    their dequantized values, and after it their float ones again."""
    params = dict(net.named_parameters())

    def call(*args, **kwargs):
        saved = {}
        try:
            for name, q in qweights.items():
                saved[name] = params[name].data
                params[name].data = dequantize(q).to(saved[name].device)
            return fn(*args, **kwargs)
        finally:
            for name, data in saved.items():
                params[name].data = data

    return call
