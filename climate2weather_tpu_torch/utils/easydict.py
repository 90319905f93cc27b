"""Attribute-access dict of the config system (own copy of
climate2weather_tpu/utils/easydict.py)."""

from __future__ import annotations

from typing import Any


class EasyDict(dict):
    """A ``dict`` whose items are accessible as attributes."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    @classmethod
    def from_nested(cls, obj: Any) -> Any:
        """Recursively convert nested dicts to EasyDicts."""
        if isinstance(obj, dict):
            return cls({k: cls.from_nested(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            return type(obj)(cls.from_nested(v) for v in obj)
        return obj

    def to_plain(self) -> dict:
        """Recursively convert back to plain dicts and lists (for YAML)."""

        def conv(obj: Any) -> Any:
            if isinstance(obj, dict):
                return {k: conv(v) for k, v in obj.items()}
            if isinstance(obj, (list, tuple)):
                return [conv(v) for v in obj]
            return obj

        return conv(self)
