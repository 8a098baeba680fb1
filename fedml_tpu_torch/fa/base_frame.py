"""Federated-analytics algorithm frame.

Parity target: reference ``fa/base_frame/`` — ``FAClientAnalyzer`` /
``FAServerAggregator`` mirror the FL ClientTrainer/ServerAggregator minus
models: a client turns its local raw data into a *submission*, the server
folds submissions into the global analytic result.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, List, Sequence


class FAClientAnalyzer(ABC):
    def __init__(self, args=None):
        self.args = args
        self.init_msg: Any = None

    def set_init_msg(self, init_msg: Any) -> None:
        self.init_msg = init_msg

    def get_init_msg(self) -> Any:
        return self.init_msg

    @abstractmethod
    def local_analyze(self, train_data: Sequence, args=None) -> Any:
        """Raw local data -> client submission."""


class FAServerAggregator(ABC):
    def __init__(self, args=None):
        self.args = args
        self.server_data: Any = None

    def get_server_data(self) -> Any:
        return self.server_data

    def get_init_msg(self) -> Any:
        return None

    @abstractmethod
    def aggregate(self, submissions: List[Any]) -> Any:
        """Fold client submissions into the global result."""
