"""Params / Context — the kwargs bag and global blackboard of the algorithm
frame (a copy of ``fedml_tpu/core/algframe/params.py``, which imports no
JAX; ``tests/test_torch_copies.py`` pins it). Used by trust/privacy hooks to
share round state without threading it through every signature."""

from __future__ import annotations

from typing import Any, Dict, Iterator


class Params:
    """An attribute/key hybrid bag (reference ``Params``)."""

    def __init__(self, **kwargs: Any):
        self.__dict__.update(kwargs)

    def add(self, name: str, value: Any) -> "Params":
        self.__dict__[name] = value
        return self

    def get(self, name: str, default: Any = None) -> Any:
        return self.__dict__.get(name, default)

    def __contains__(self, name: str) -> bool:
        return name in self.__dict__

    def __getitem__(self, name: str) -> Any:
        return self.__dict__[name]

    def __setitem__(self, name: str, value: Any) -> None:
        self.__dict__[name] = value

    def keys(self) -> Iterator[str]:
        return iter(self.__dict__)

    def to_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)


class Context(Params):
    """Process-wide singleton blackboard (reference ``context.py:19``)."""

    _instance: "Context" = None

    def __new__(cls, *a, **kw):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    @classmethod
    def reset(cls) -> None:
        cls._instance = None
