"""The tasks' configuration: a nested dict with attribute access.

The port's own copy of the part of ``egot2x/core/config.py`` ``Config``
that the tasks read: ``cfg.lr`` and ``cfg.get("wd", 0.0)`` alike, nested
dicts wrapped on the way in. YAML files and dotted-key overrides come
with the port's CLIs (ROADMAP.md §1 item 7).
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class Config(dict):
    """Nested dict with attribute access."""

    def __init__(self, data: Optional[Dict[str, Any]] = None, **kwargs):
        super().__init__()
        for k, v in {**(data or {}), **kwargs}.items():
            self[k] = self._wrap(v)

    @classmethod
    def _wrap(cls, v: Any) -> Any:
        if isinstance(v, dict) and not isinstance(v, Config):
            return cls(v)
        return v

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = self._wrap(value)
