"""Distributed runtime (counterpart of ``fedml_tpu/core/distributed/``),
ported as far as the Message envelope and its msgpack wire codec, which
model artifacts, adapter exports and round checkpoints share, and the
retry policy (``communication/backoff.py``) the serving gateway uses. The
transports, the comm manager and the topologies are not ported yet."""

from .communication.message import Message

__all__ = ["Message"]
