"""Weight bridge between the JAX package's variables and the port's
``state_dict``, and seeded random weights.

The JAX package's variables are nested dicts with ``params``,
``batch_stats`` and ``norm_stats`` collections; the caller converts the
arrays to numpy (the port never sees a JAX array). Module names are the
same on both sides, so a flax path ``params/encoder/layer_0/relpos_mha/
q_layer/kernel`` becomes ``encoder.layer_0.relpos_mha.q_layer.weight``.
Layouts:

- Dense kernel (in, out)              -> weight (out, in)
- pointwise conv kernel (1, Cin, Cout) -> weight (Cout, Cin)
- any other 1-D conv kernel (K, Cin, Cout), the depthwise (K, 1, C)
  among them                          -> weight (Cout, Cin, K)
- ConvTranspose kernel (K, Cout, Cin) (``transpose_kernel=True``)
                                      -> weight (Cin, Cout, K)
- Conv2d kernel HWIO (kh, kw, Ci, Co)  -> weight OIHW (Co, Ci, kh, kw)
- LayerNorm / BatchNorm scale         -> weight; embedding -> weight
  (token and speaker tables)
- batch_stats mean / var              -> running_mean / running_var
- norm_stats NormStats fields         -> <module>.stats.<field>
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_NORM_FIELDS = ("mean", "std", "batch", "seen", "aver_mean", "aver_std")


def _items(node, prefix=()):
    """Flatten nested mappings (and NamedTuples, via ``_asdict``) into
    (path tuple, leaf) pairs."""
    if hasattr(node, "_asdict"):
        node = node._asdict()
    if isinstance(node, Mapping):
        for k, v in node.items():
            yield from _items(v, prefix + (str(k),))
    else:
        yield prefix, node


def _param_to_torch(path, arr: np.ndarray):
    *parents, leaf = path
    parent = parents[-1] if parents else ""
    if leaf == "kernel":
        if parent.startswith("pointwise_conv"):
            arr = arr[0].T
        elif arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 3:
            arr = arr.transpose(2, 1, 0)
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        leaf = "weight"
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    return ".".join([*parents, leaf]), arr


def from_flax_variables(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX-package variables (nested dicts of numpy arrays) -> the port's
    ``state_dict`` (float32 / bool CPU tensors)."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _items(tree.get("params", {})):
        name, arr = _param_to_torch(path, np.asarray(leaf, np.float32))
        # a C-ordered copy that keeps a scalar 0-d (np.ascontiguousarray
        # would make it (1,)): posenc_scale's alpha
        out[name] = torch.from_numpy(np.array(arr, order="C"))
    for path, leaf in _items(tree.get("batch_stats", {})):
        *parents, stat = path
        name = {"mean": "running_mean", "var": "running_var"}[stat]
        out[".".join([*parents, name])] = torch.from_numpy(
            np.asarray(leaf, np.float32).copy())
    for path, leaf in _items(tree.get("norm_stats", {})):
        arr = np.asarray(leaf)
        arr = arr.astype(bool) if path[-1] == "seen" else arr.astype(
            np.float32)
        out[".".join(path)] = torch.from_numpy(arr.copy())
    return out


def to_flax_variables(state_dict: Mapping[str, torch.Tensor]
                      ) -> Dict[str, Any]:
    """Inverse of :func:`from_flax_variables`: the port's ``state_dict``
    -> nested dicts of float32 / bool numpy arrays."""
    tree: Dict[str, Any] = {"params": {}, "batch_stats": {},
                            "norm_stats": {}}

    def put(col, path, value):
        node = tree[col]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value

    for name, t in state_dict.items():
        path = name.split(".")
        *parents, leaf = path
        parent = parents[-1] if parents else ""
        arr = t.detach().cpu()
        arr = arr.numpy() if arr.dtype == torch.bool else arr.float().numpy()
        if len(parents) >= 1 and parents[-1] == "stats" and \
                leaf in _NORM_FIELDS:
            put("norm_stats", path, arr)
        elif leaf in ("running_mean", "running_var"):
            put("batch_stats", [*parents, leaf[len("running_"):]], arr)
        elif leaf == "weight" and parent in ("embed", "lookup"):
            put("params", [*parents, "embedding"], arr)
        elif leaf == "weight" and arr.ndim == 1:
            put("params", [*parents, "scale"], arr)
        elif leaf == "weight":
            if parent.startswith("pointwise_conv"):
                arr = arr.T[None]
            elif arr.ndim == 3:
                arr = arr.transpose(2, 1, 0)
            elif arr.ndim == 4:
                arr = arr.transpose(2, 3, 1, 0)
            else:
                arr = arr.T
            put("params", [*parents, "kernel"], np.ascontiguousarray(arr))
        else:
            put("params", path, arr)
    return {k: v for k, v in tree.items() if v}


def random_state_dict(net: torch.nn.Module, seed: int = 0
                      ) -> Dict[str, torch.Tensor]:
    """Seeded random float32 weights for every entry of ``net``'s
    ``state_dict``: matrices ~ N(0, 1/fan_in), norm scales near 1, biases
    and means small, variances and stds in [0.5, 1.5], all norm groups
    marked seen."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in net.state_dict().items():
        shape = tuple(t.shape)
        leaf = name.rsplit(".", 1)[-1]
        if t.dtype == torch.bool:
            arr = np.ones(shape, bool)
        elif leaf in ("running_var", "std", "aver_std"):
            arr = rng.uniform(0.5, 1.5, shape)
        elif leaf == "batch":
            arr = np.ones(shape)
        elif leaf == "weight" and len(shape) == 1:
            arr = 1.0 + 0.1 * rng.standard_normal(shape)
        elif len(shape) >= 2 and leaf == "weight":
            fan_in = int(np.prod(shape[1:]))
            arr = rng.standard_normal(shape) / np.sqrt(fan_in)
        else:                       # biases, means, pos_bias_u/v, alpha
            arr = 0.1 * rng.standard_normal(shape)
        out[name] = torch.from_numpy(np.asarray(arr).astype(
            bool if t.dtype == torch.bool else np.float32))
    return out


# the JAX package's speaker-encoder modules -> the reference layout's
# prefixes (speechain_tpu/nn/speaker.py::load_torch_speaker, inverted)
_SPEAKER_LAYOUT = {
    "ecapa": {"conv1": "model.0", "bn1": "model.1", "bn2": "model.3.2",
              "fc": "model.6", "se/se_fc1": "model.3.1.se.1",
              "se/se_fc2": "model.3.1.se.3"},
    "xvector": {"tdnn0": "model.0", "bn0": "model.1", "tdnn1": "model.3",
                "bn1": "model.4", "tdnn2": "model.6", "bn2": "model.7",
                "fc1": "model.11", "fc2": "model.13"},
}


def speaker_from_flax(variables: Dict[str, Any], model_type: str = "ecapa"
                      ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``EncoderClassifier`` variables (``params`` and
    ``batch_stats`` as numpy) -> the port's state dict, which is the
    reference's torch layout (``nn/speaker.py``): conv kernels (k, in, out)
    -> (out, in, k), Dense (in, out) -> (out, in), BatchNorm scale / bias
    -> weight / bias and mean / var -> running_mean / running_var."""
    layout = dict(_SPEAKER_LAYOUT[model_type])
    if model_type == "ecapa":
        for name in variables["params"]["res2block"]:
            layout[f"res2block/{name}"] = (
                f"model.3.0.convs.{int(name[len('conv_'):])}")
    out: Dict[str, torch.Tensor] = {}

    def put(name, arr):
        out[name] = torch.from_numpy(np.array(arr, np.float32, order="C"))

    for path, prefix in layout.items():
        node = variables["params"]
        for p in path.split("/"):
            node = node[p]
        if "kernel" in node:
            k = np.asarray(node["kernel"])
            put(prefix + ".weight", k.T if k.ndim == 2 else
                k.transpose(2, 1, 0))
        else:
            put(prefix + ".weight", node["scale"])
            stats = variables["batch_stats"][path]
            put(prefix + ".running_mean", stats["mean"])
            put(prefix + ".running_var", stats["var"])
        put(prefix + ".bias", node["bias"])
    return out
