"""A tiny string->factory registry used for architectures, datasets, shapes."""
from __future__ import annotations

from typing import Callable, Dict, Iterable


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Callable] = {}

    def register(self, name: str):
        def deco(fn):
            if name in self._entries:
                raise KeyError(f"{self.kind} '{name}' already registered")
            self._entries[name] = fn
            return fn

        return deco

    def get(self, name: str):
        if name not in self._entries:
            raise KeyError(
                f"unknown {self.kind} '{name}'; available: {sorted(self._entries)}"
            )
        return self._entries[name]

    def names(self) -> Iterable[str]:
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries
