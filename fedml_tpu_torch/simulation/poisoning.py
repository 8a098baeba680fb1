"""Data poisoning applied by the simulators (counterpart of
``fedml_tpu/simulation/poisoning.py``): the engine-side form of the
reference's ``ClientTrainer.update_dataset`` poisoning hook. It rewrites
the byzantine clients' host arrays before the data moves to the device."""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.algframe.types import ClientData
from ..core.security.attack import FedMLAttacker, backdoor_stamp


def poison_dataset(fed, attacker: FedMLAttacker):
    """Apply the configured data attack to the byzantine clients' shards:
    label flipping, or backdoor trigger stamping (all samples / edge-case
    variant that stamps only the globally rarest class — reference
    edge-case backdoor of ``core/security/attack/``)."""
    mask = attacker.byzantine_mask(np.arange(fed.num_clients))  # [K]
    y = np.asarray(fed.train.y)
    sel = mask.reshape((-1,) + (1,) * (y.ndim - 1)) > 0
    t = attacker.attack_type
    train = fed.train
    if t in ("backdoor", "edge_case_backdoor"):
        x = np.asarray(train.x)
        target = int(getattr(attacker.args, "backdoor_target_label", 0) or 0)
        # x is [K, nb, bs, ...feature dims]; image iff features are H,W,C
        stamped = backdoor_stamp(x, image=(x.ndim == y.ndim + 3))
        if t == "edge_case_backdoor":
            # padding rows carry label 0 — count only real samples
            real = np.asarray(train.mask).reshape(-1) > 0
            counts = np.bincount(y.reshape(-1)[real],
                                 minlength=fed.num_classes)
            rare = int(np.argmin(np.where(counts > 0, counts, counts.max())))
            sel = sel & (y == rare)
        new_x = np.where(
            np.broadcast_to(sel.reshape(sel.shape + (1,) * (x.ndim - y.ndim)),
                            x.shape), stamped, x)
        new_y = np.where(sel, target, y)
        new_train = ClientData(new_x, new_y.astype(y.dtype), train.mask,
                               train.num_samples)
    else:
        flipped = attacker.poison_labels(y, fed.num_classes)
        new_train = ClientData(train.x, np.where(sel, flipped, y).astype(
            y.dtype), train.mask, train.num_samples)
    return dataclasses.replace(fed, train=new_train)
