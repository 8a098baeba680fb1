"""Distributed runtime & communication (counterpart of
``fedml_tpu/core/distributed/``): the Message envelope and its msgpack wire
codec (which model artifacts, adapter exports and round checkpoints
share), the transports (in-proc, TCP, gRPC) with their retry policy
(``communication/backoff.py``) and the ``FedMLCommManager`` event-loop
base of the cross-silo managers. Not ported yet: the pub/sub and TRPC
transports, the topologies and the Flow DAG."""

from .communication.message import Message
from .communication.base_com_manager import BaseCommunicationManager, Observer
from .fedml_comm_manager import FedMLCommManager

__all__ = ["Message", "BaseCommunicationManager", "Observer",
           "FedMLCommManager"]
