"""Bulk-payload object store — the data plane of the control/data split
(a copy of ``fedml_tpu/core/distributed/distributed_storage``).

Parity target: the reference's S3 remote storage
(``communication/s3/remote_storage.py:28`` — ``write_model`` :75,
``read_model`` :215) and the decentralized variants
(``core/distributed/distributed_storage/`` web3.storage / Theta EdgeStore):
model payloads leave the control channel; messages carry only a key/URL.

Local-first implementation: a content-addressed store on a shared
filesystem path (``put`` returns ``cas://<sha256>``); the interface is the
narrow waist (``put_object``/``get_object``/``write_model``/``read_model``)
so an S3/GCS/web3 client can be dropped in behind it unchanged.
"""

from __future__ import annotations

import hashlib
import os
from typing import Any, Optional

from ..communication.message import dumps_tree, loads_tree


class LocalObjectStorage:
    """Content-addressed blob store rooted at ``root`` (defaults to the
    cache dir; cross-silo tests share one root the way silos share S3)."""

    SCHEME = "cas://"

    def __init__(self, root: Optional[str] = None):
        self.root = os.path.expanduser(
            root or os.environ.get("FEDML_TPU_STORAGE_DIR",
                                   "~/.cache/fedml_tpu/storage"))
        os.makedirs(self.root, exist_ok=True)

    def _path(self, digest: str) -> str:
        return os.path.join(self.root, digest)

    def put_object(self, blob: bytes) -> str:
        digest = hashlib.sha256(blob).hexdigest()
        path = self._path(digest)
        if not os.path.exists(path):
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)
        return self.SCHEME + digest

    def get_object(self, key: str) -> bytes:
        digest = key.removeprefix(self.SCHEME)
        with open(self._path(digest), "rb") as f:
            blob = f.read()
        if hashlib.sha256(blob).hexdigest() != digest:
            raise IOError(f"object store corruption for {key}")
        return blob

    # --- model payload convenience (reference write_model/read_model) ------
    # wire tree codec, NOT pickle: stored payloads can come from remote
    # silos, and reading one must never execute code.
    def write_model(self, params: Any) -> str:
        return self.put_object(dumps_tree(params))

    def read_model(self, key: str) -> Any:
        return loads_tree(self.get_object(key))
