"""Transport abstraction (a copy of
``fedml_tpu/core/distributed/communication/base_com_manager.py``): every
backend (in-proc, TCP, gRPC) implements
``BaseCommunicationManager``; managers register as ``Observer``s and get a
callback per received message."""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List

from .message import Message


class Observer(ABC):
    @abstractmethod
    def receive_message(self, msg_type, msg: Message) -> None:
        ...


class BaseCommunicationManager(ABC):
    def __init__(self):
        self._observers: List[Observer] = []

    def add_observer(self, observer: Observer) -> None:
        self._observers.append(observer)

    def remove_observer(self, observer: Observer) -> None:
        if observer in self._observers:
            self._observers.remove(observer)

    def notify(self, msg: Message) -> None:
        for obs in list(self._observers):
            obs.receive_message(msg.get_type(), msg)

    @abstractmethod
    def send_message(self, msg: Message) -> None:
        ...

    @abstractmethod
    def handle_receive_message(self) -> None:
        """Block, dispatching received messages to observers, until
        :meth:`stop_receive_message`."""
        ...

    @abstractmethod
    def stop_receive_message(self) -> None:
        ...
