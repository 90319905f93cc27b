"""Name-based construction for the config system (own copy of
climate2weather_tpu/utils/registry.py).

Configs name pluggable components (dataset, noise process, LR schedule) by
a short registered name or by a dotted import path.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict

_REGISTRY: Dict[str, Any] = {}


def register(name: str) -> Callable[[Any], Any]:
    """Decorator: register a class or function under a short name."""

    def deco(obj: Any) -> Any:
        if name in _REGISTRY and _REGISTRY[name] is not obj:
            raise ValueError(f"Duplicate registry entry: {name!r}")
        _REGISTRY[name] = obj
        return obj

    return deco


def get_obj_by_name(name: str) -> Any:
    """Resolve ``name`` from the registry, else as ``module.path:attr`` or
    ``module.path.attr`` via import."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    if ":" in name:
        mod_name, attr = name.split(":", 1)
        return getattr(importlib.import_module(mod_name), attr)
    parts = name.split(".")
    for split in range(len(parts) - 1, 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:split]))
        except ImportError:
            continue
        try:
            for attr in parts[split:]:
                obj = getattr(obj, attr)
        except AttributeError:
            continue
        return obj
    raise ImportError(f"Cannot resolve object by name: {name!r}")


def construct_class_by_name(*args, class_name: str, **kwargs) -> Any:
    """Instantiate the class registered or importable as ``class_name``."""
    return get_obj_by_name(class_name)(*args, **kwargs)
