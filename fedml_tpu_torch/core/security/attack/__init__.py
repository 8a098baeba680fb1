"""Attack zoo — adversarial client behaviors used to *test* defenses
(counterpart of ``fedml_tpu/core/security/attack/__init__.py``).

Model attacks transform the round's ``[K, D]`` update matrix (rows in
sampled-client order, columns in the JAX package's flat layout) on its
device; their noise is ``prng.normal_t`` of the matrix's shape, so it
equals ``jax.random.normal``'s at the same key. Data attacks
(``label_flip``, ``backdoor_stamp``) work on the clients' host arrays
before they move to the device (``simulation/poisoning.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .... import prng
from ....utils.confval import get_float, get_int

ATTACK_TYPES = ("byzantine_random", "byzantine_zero", "byzantine_flip",
                "label_flip", "model_replacement", "gaussian_noise",
                "backdoor", "edge_case_backdoor", "lazy_worker")

MODEL_ATTACKS = ("byzantine_random", "byzantine_zero", "byzantine_flip",
                 "model_replacement", "gaussian_noise", "lazy_worker")
DATA_ATTACKS = ("label_flip", "backdoor", "edge_case_backdoor")


def _byz(byz_mask: torch.Tensor) -> torch.Tensor:
    return byz_mask[:, None] > 0


# --- model poisoning (operate on [K, D] update matrix + byzantine mask) ----

def byzantine_random(mat: torch.Tensor, byz_mask: torch.Tensor,
                     rng: np.ndarray, scale: float = 1.0) -> torch.Tensor:
    """Replace byzantine clients' updates with gaussian noise (reference
    ``attack/byzantine_attack.py`` mode 'random')."""
    noise = scale * prng.normal_t(rng, tuple(mat.shape), mat.device)
    return torch.where(_byz(byz_mask), noise, mat)


def byzantine_zero(mat: torch.Tensor, byz_mask: torch.Tensor
                   ) -> torch.Tensor:
    return torch.where(_byz(byz_mask), torch.zeros_like(mat), mat)


def byzantine_flip(mat: torch.Tensor, byz_mask: torch.Tensor,
                   scale: float = 1.0) -> torch.Tensor:
    """Sign-flip (inner-product manipulation) attack."""
    return torch.where(_byz(byz_mask), -scale * mat, mat)


def model_replacement(mat: torch.Tensor, byz_mask: torch.Tensor,
                      boost: float) -> torch.Tensor:
    """Backdoor model-replacement boosting (reference
    ``attack/backdoor_attack.py``): attacker scales its update by ~K so the
    average equals its target model."""
    return torch.where(_byz(byz_mask), boost * mat, mat)


def gaussian_noise(mat: torch.Tensor, rng: np.ndarray,
                   stddev: float = 0.1) -> torch.Tensor:
    """Additive noise on every update (untargeted degradation)."""
    return mat + stddev * prng.normal_t(rng, tuple(mat.shape), mat.device)


def lazy_worker(mat: torch.Tensor, byz_mask: torch.Tensor, rng: np.ndarray,
                noise: float = 1e-3) -> torch.Tensor:
    """Freeloaders (reference lazy-worker attack): byzantine clients do no
    training and submit a near-zero update with a dash of noise to evade
    exact-zero detection."""
    fake = noise * prng.normal_t(rng, tuple(mat.shape), mat.device)
    m = byz_mask.reshape(-1, 1).to(mat.dtype)
    return mat * (1 - m) + fake * m


# --- data poisoning --------------------------------------------------------

def backdoor_stamp(x: np.ndarray, trigger_value: float = 1.0,
                   patch: int = 3, image: Optional[bool] = None
                   ) -> np.ndarray:
    """Stamp the backdoor trigger (a corner patch) onto samples.

    ``image=True`` stamps a top-left ``patch x patch`` corner on
    [..., H, W, C] layouts; ``image=False`` stamps the first
    ``patch * patch`` features of flat [..., F] layouts. Leading axes are
    arbitrary (batched/stacked inputs), so callers that know the layout
    MUST pass ``image`` — the ndim heuristic only covers the unbatched
    2D/4D cases."""
    x = np.array(x, copy=True)
    if image is None:
        image = x.ndim >= 3
    if image:
        x[..., :patch, :patch, :] = trigger_value
    else:
        x[..., :patch * patch] = trigger_value
    return x


def label_flip(y: np.ndarray, num_classes: int,
               src: Optional[int] = None, dst: Optional[int] = None
               ) -> np.ndarray:
    """Label-flipping (reference ``attack/label_flipping_attack.py``):
    src->dst targeted flip, or y -> C-1-y untargeted when src is None."""
    y = np.asarray(y)
    if src is None:
        return (num_classes - 1 - y).astype(y.dtype)
    out = y.copy()
    out[y == src] = dst if dst is not None else (num_classes - 1 - src)
    return out


def apply_model_attack(attack_type: str, mat: torch.Tensor,
                       byz_mask: torch.Tensor, rng: np.ndarray,
                       scale: float) -> torch.Tensor:
    """One model attack on ``mat`` (unknown types pass it through)."""
    if attack_type == "byzantine_random":
        return byzantine_random(mat, byz_mask, rng, scale)
    if attack_type == "byzantine_zero":
        return byzantine_zero(mat, byz_mask)
    if attack_type == "byzantine_flip":
        return byzantine_flip(mat, byz_mask, scale)
    if attack_type == "model_replacement":
        boost = scale if scale != 1.0 else float(mat.shape[0])
        return model_replacement(mat, byz_mask, boost)
    if attack_type == "gaussian_noise":
        return gaussian_noise(mat, rng, scale)
    if attack_type == "lazy_worker":
        return lazy_worker(mat, byz_mask, rng)
    return mat


class FedMLAttacker:
    """Configured from args: the simulators consult it to poison data
    before training and updates before aggregation."""


    def __init__(self, args):
        self.args = args
        self.attack_type = str(getattr(args, "attack_type", None) or "").lower()
        self.enabled = bool(getattr(args, "enable_attack", False)) and \
            self.attack_type in ATTACK_TYPES
        self.byzantine_client_num = get_int(args, "byzantine_client_num", 0)
        self.attack_scale = get_float(args, "attack_scale", 1.0)

    def is_model_attack(self) -> bool:
        return self.enabled and self.attack_type in MODEL_ATTACKS

    def is_data_attack(self) -> bool:
        return self.enabled and self.attack_type in DATA_ATTACKS

    def byzantine_mask(self, client_ids) -> np.ndarray:
        """Clients 0..f-1 are byzantine (deterministic, test-friendly)."""
        return (np.asarray(client_ids) < self.byzantine_client_num
                ).astype(np.float32)

    def poison_updates(self, mat: torch.Tensor, client_ids,
                       rng: np.ndarray) -> torch.Tensor:
        mask = torch.as_tensor(self.byzantine_mask(client_ids),
                               device=mat.device)
        return apply_model_attack(self.attack_type, mat, mask, rng,
                                  self.attack_scale)

    def poison_labels(self, y: np.ndarray, num_classes: int) -> np.ndarray:
        return label_flip(y, num_classes)
