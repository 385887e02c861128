"""Explicit name->factory registries (copy of the JAX package's
``registry.py``; the port keeps its own instances)."""

from __future__ import annotations

from typing import Dict, Generic, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, T] = {}

    def register(self, name: str, obj: T) -> T:
        if name in self._entries:
            raise KeyError(f"{self.kind} '{name}' already registered")
        self._entries[name] = obj
        return obj

    def get(self, name: str) -> T:
        try:
            return self._entries[name]
        except KeyError:
            known = ", ".join(sorted(self._entries))
            raise KeyError(
                f"Unknown {self.kind} '{name}'. Known: {known}") from None


MODELS: Registry = Registry("model")       # name -> model factory
ARG_POOLS: Registry = Registry("arg_pool")  # name -> {dataset: TrainConfig}
