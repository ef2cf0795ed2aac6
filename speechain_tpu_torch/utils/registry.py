"""A copy of ``speechain_tpu/utils/registry.py``.

Explicit component registry.

The reference toolkit assembles every layer via reflection on dotted module
paths (``import_class("speechain." + cfg["type"])``, reference
``utilbox/import_util.py:18`` and ``runner.py:576,683,727``). We keep the
YAML surface (``type:`` string + ``conf:`` kwargs) but back it with an
explicit registry for traceability, plus a dotted-path fallback so user
extensions outside the package still work.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict

_REGISTRY: Dict[str, Any] = {}

# Short aliases matching the reference's `type:` strings, e.g.
# "block.BlockIterator" or "ar_asr.ARASR", map onto our registered names.
_ALIASES: Dict[str, str] = {}


def register(name: str, *aliases: str) -> Callable:
    """Class/function decorator: ``@register("iterator.block")``."""

    def wrap(obj):
        if name in _REGISTRY and _REGISTRY[name] is not obj:
            raise KeyError(f"duplicate registry name: {name}")
        _REGISTRY[name] = obj
        for a in aliases:
            _ALIASES[a] = name
        return obj

    return wrap


def resolve(type_string: str) -> Any:
    """Resolve a YAML ``type:`` string to a component.

    Lookup order: exact registry name -> alias -> dotted import path
    (``pkg.module.Class``).
    """
    if type_string in _REGISTRY:
        return _REGISTRY[type_string]
    if type_string in _ALIASES:
        return _REGISTRY[_ALIASES[type_string]]
    if "." in type_string:
        module_path, _, attr = type_string.rpartition(".")
        for prefix in ("", "speechain_tpu_torch."):
            try:
                mod = importlib.import_module(prefix + module_path)
                return getattr(mod, attr)
            except (ImportError, AttributeError):
                continue
    raise KeyError(
        f"cannot resolve component type {type_string!r}; known: "
        f"{sorted(_REGISTRY) + sorted(_ALIASES)}"
    )


def registered() -> Dict[str, Any]:
    return dict(_REGISTRY)
