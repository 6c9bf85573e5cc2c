"""Name -> implementation registries.

A copy of ``distributed_machine_learning_tpu/utils/registry.py``: the port
imports nothing of the JAX package, whose ``__init__`` pulls in jax.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Generic, Iterator, Optional, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    """A string-keyed registry with decorator-style registration."""

    def __init__(self, kind: str):
        self._kind = kind
        self._entries: Dict[str, T] = {}

    def register(self, name: str, obj: Optional[T] = None) -> Callable[[T], T]:
        key = name.lower()

        def _do_register(o: T) -> T:
            if key in self._entries:
                raise ValueError(f"{self._kind} {name!r} is already registered")
            self._entries[key] = o
            return o

        if obj is not None:
            return _do_register(obj)
        return _do_register

    def get(self, name: str) -> T:
        key = str(name).lower()
        if key not in self._entries:
            raise KeyError(
                f"Unknown {self._kind} {name!r}. Available: {sorted(self._entries)}"
            )
        return self._entries[key]

    def __contains__(self, name: str) -> bool:
        return str(name).lower() in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def names(self) -> list:
        return sorted(self._entries)

    def items(self):
        return self._entries.items()
