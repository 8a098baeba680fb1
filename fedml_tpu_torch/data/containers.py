"""Federated dataset containers: ragged per-client data -> static padded
arrays (counterpart of ``fedml_tpu/data/containers.py``).

Clients are stacked on a leading axis, padded to a common
``[n_batches, batch_size]`` shape with an explicit mask, and each client's
sample count rides along as its aggregation weight. The arrays stay numpy on
the host; the engine moves them to its device once.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..core.algframe.types import ClientData


@dataclasses.dataclass
class FederatedDataset:
    """Host-side container for one FL task.

    ``train``: ClientData with numpy leaves stacked on a leading
    [num_clients] axis. ``test``: the global test set, batched:
    {"x": [nb, bs, ...], "y", "mask"}.
    """
    train: ClientData
    test: Dict[str, np.ndarray]
    num_classes: int
    input_shape: Tuple[int, ...]
    num_clients: int
    client_num_samples: np.ndarray  # [num_clients] int — true n_k
    task: str = "classification"
    # "real" | "synthetic" — set by the loader so reporting can never
    # present a generated stand-in as the real task
    provenance: str = "real"


def batchify(x: np.ndarray, y: np.ndarray, batch_size: int,
             n_batches: Optional[int] = None
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad (x, y) to ``n_batches`` full batches; returns (x, y, mask) with
    shapes [nb, bs, ...], [nb, bs], [nb, bs]."""
    n = x.shape[0]
    nb = n_batches if n_batches is not None else max(1, -(-n // batch_size))
    total = nb * batch_size
    pad = total - n
    if pad < 0:
        raise ValueError(f"n_batches={nb} too small for {n} samples")
    mask = np.concatenate([np.ones(n, np.float32),
                           np.zeros(pad, np.float32)])
    xp = (np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
          if pad else x)
    yp = (np.concatenate([y, np.zeros((pad,) + y.shape[1:], y.dtype)])
          if pad else y)
    return (xp.reshape((nb, batch_size) + x.shape[1:]),
            yp.reshape((nb, batch_size) + y.shape[1:]),
            mask.reshape(nb, batch_size))


def build_federated_dataset(
    client_xs: Sequence[np.ndarray],
    client_ys: Sequence[np.ndarray],
    test_x: np.ndarray,
    test_y: np.ndarray,
    batch_size: int,
    num_classes: int,
    eval_batch_size: Optional[int] = None,
    dtype=np.float32,
    task: str = "classification",
) -> FederatedDataset:
    """Stack per-client arrays into one padded ClientData."""
    num_clients = len(client_xs)
    counts = np.array([len(x) for x in client_xs], dtype=np.int64)
    nb = max(1, int(-(-counts.max() // batch_size)))
    xs, ys, ms = [], [], []
    for cx, cy in zip(client_xs, client_ys):
        bx, by, bm = batchify(np.asarray(cx, dtype), np.asarray(cy),
                              batch_size, nb)
        xs.append(bx)
        ys.append(by)
        ms.append(bm)
    train = ClientData(x=np.stack(xs), y=np.stack(ys), mask=np.stack(ms),
                       num_samples=counts.astype(np.float32))
    ebs = eval_batch_size or max(batch_size, 256)
    tx, ty, tm = batchify(np.asarray(test_x, dtype), np.asarray(test_y), ebs)
    return FederatedDataset(
        train=train, test={"x": tx, "y": ty, "mask": tm},
        num_classes=num_classes,
        input_shape=tuple(np.asarray(client_xs[0]).shape[1:]),
        num_clients=num_clients, client_num_samples=counts, task=task)


def from_central_arrays(
    x: np.ndarray,
    y: np.ndarray,
    test_x: np.ndarray,
    test_y: np.ndarray,
    num_clients: int,
    batch_size: int,
    num_classes: int,
    partition_method: str = "hetero",
    partition_alpha: float = 0.5,
    seed: int = 0,
) -> FederatedDataset:
    """Central arrays + partitioner -> FederatedDataset."""
    from ..core.data.noniid_partition import partition

    parts = partition(np.asarray(y), num_clients, partition_method,
                      partition_alpha, seed)
    cxs = [x[parts[i]] for i in range(num_clients)]
    cys = [y[parts[i]] for i in range(num_clients)]
    return build_federated_dataset(cxs, cys, test_x, test_y, batch_size,
                                   num_classes)
