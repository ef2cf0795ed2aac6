"""A copy of ``speechain_tpu/utils/yamlref.py``, on PyYAML as well.

YAML config loader with SpeechBrain-style reference tags.

Re-implements (on top of PyYAML; the reference uses ruamel) the config-file
grammar of the reference toolkit so that recipe YAMLs are drop-in compatible:

- ``!ref <key>``          -> value of top-level key ``key`` (type preserved)
- ``!ref <key[i][j]>``    -> indexed into list/str values
- ``!ref a<key>b``        -> string interpolation (result is str)
- ``!ref plain``          -> the literal string "plain"
- ``!tuple (a, b, c)``    -> python tuple, numeric items become int
- ``!list [a, b, c]``     -> python list, numeric items become int
- ``!str 123``            -> "123"

Behavioral contract follows reference ``speechain/utilbox/yaml_util.py:46-170``
(remove_representer + load_yaml): references resolve against the *top-level*
mapping of the same document, in document order (a ref must point at an
already-resolved key).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict

import yaml

_ANGLE = re.compile(r"<[^<>]*>")


class _Tagged:
    """A scalar carrying an unresolved custom tag."""

    __slots__ = ("tag", "value")

    def __init__(self, tag: str, value: str):
        self.tag = tag
        self.value = value

    def __repr__(self):  # pragma: no cover
        return f"_Tagged({self.tag!r}, {self.value!r})"


class _RefLoader(yaml.SafeLoader):
    pass


def _make_ctor(tag):
    def ctor(loader, node):
        if isinstance(node, yaml.SequenceNode):
            seq = loader.construct_sequence(node, deep=True)
            body = "[" + ",".join(str(i) for i in seq) + "]"
            return _Tagged(tag, body)
        return _Tagged(tag, str(loader.construct_scalar(node)))

    return ctor


for _t in ("!ref", "!tuple", "!list", "!str"):
    _RefLoader.add_constructor(_t, _make_ctor(_t))


def _parse_item(tok: str) -> Any:
    tok = tok.strip()
    return int(tok) if tok.isnumeric() else tok


def _index_ref(ref_key: str, reference: Dict) -> Any:
    """Resolve ``key`` or ``key[i][j]`` against the reference mapping."""
    if "[" in ref_key and "]" in ref_key:
        main = ref_key[: ref_key.index("[")]
        indices = [int(m) for m in re.findall(r"\[(-?\d+)\]", ref_key)]
        value = reference[main]
        for idx in indices:
            value = value[idx]
        return value
    if ref_key not in reference:
        raise KeyError(f"!ref <{ref_key}>: no such top-level key in config")
    value = reference[ref_key]
    if isinstance(value, _Tagged):
        raise ValueError(f"!ref <{ref_key}> points at an unresolved tag; "
                         f"references must appear after their targets")
    return value


def _resolve(node: Any, reference: Dict) -> Any:
    if isinstance(node, dict):
        out = {}
        for key, value in node.items():
            out[str(key)] = _resolve(value, reference)
            # progressive resolution: later top-level keys may reference
            # earlier ones through the shared `reference` mapping
            if node is reference:
                reference[key] = out[str(key)]
        return out
    if isinstance(node, list):
        return [_resolve(item, reference) for item in node]
    if isinstance(node, _Tagged):
        if node.tag == "!ref":
            s = node.value
            if _ANGLE.search(s) is None:
                return s
            if _ANGLE.fullmatch(s):
                return _index_ref(s[1:-1], reference)
            for m in _ANGLE.findall(s):
                s = s.replace(m, str(_index_ref(m[1:-1], reference)))
            return s
        if node.tag == "!tuple":
            inner = node.value.strip()[1:-1].replace(" ", "")
            return tuple(_parse_item(i) for i in inner.split(",") if i != "")
        if node.tag == "!list":
            inner = node.value.strip()[1:-1].replace(" ", "")
            return [_parse_item(i) for i in inner.split(",") if i != ""]
        if node.tag == "!str":
            return str(node.value)
        raise ValueError(f"unknown tag {node.tag}")
    return node


def load_yaml(src) -> Dict:
    """Load a YAML config (path, file object, or string) and resolve tags."""
    if hasattr(src, "read"):
        text = src.read()
    elif isinstance(src, str) and (os.path.exists(src) or src.endswith((".yaml", ".yml"))):
        with open(src, "r") as f:
            text = f.read()
    else:
        text = src
    raw = yaml.load(text, Loader=_RefLoader)
    if raw is None:
        return {}
    if not isinstance(raw, dict):
        raise TypeError("top level of a config file must be a mapping")
    return _resolve(raw, raw)


def parse_path_args(path: str) -> str:
    """Resolve a non-absolute path against $SPEECHAIN_TPU_ROOT (or cwd).

    Mirror of reference ``utilbox/import_util.py:53`` (parse_path_args).
    """
    if os.path.isabs(path):
        return path
    root = os.environ.get("SPEECHAIN_TPU_ROOT", os.getcwd())
    return os.path.abspath(os.path.join(root, path))
