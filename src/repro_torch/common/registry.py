"""Tiny name -> factory registry used for architectures, datasets and algorithms."""
from __future__ import annotations

from typing import Callable, Dict, Generic, Iterator, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Callable[..., T]] = {}

    def register(self, name: str) -> Callable[[Callable[..., T]], Callable[..., T]]:
        def deco(fn: Callable[..., T]) -> Callable[..., T]:
            if name in self._entries:
                raise KeyError(f"duplicate {self.kind} registration: {name!r}")
            self._entries[name] = fn
            return fn

        return deco

    def get(self, name: str) -> Callable[..., T]:
        if name not in self._entries:
            known = ", ".join(sorted(self._entries))
            raise KeyError(f"unknown {self.kind} {name!r}; known: {known}")
        return self._entries[name]

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._entries))

    def names(self):
        return sorted(self._entries)
