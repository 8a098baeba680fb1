"""Executor role for FedMLAlgorithmFlow (reference ``fedml_executor.py:4``):
holds params, exposes ``get/set_params``, and is the ``self`` of flow
callables."""

from __future__ import annotations

from typing import Any, List, Optional


class FedMLExecutor:
    def __init__(self, id: int, neighbor_id_list: Optional[List[int]] = None):
        self.id = int(id)
        self.neighbor_id_list = list(neighbor_id_list or [])
        self._params: Any = None

    def get_params(self) -> Any:
        return self._params

    def set_params(self, params: Any) -> None:
        self._params = params
