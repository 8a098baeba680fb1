"""LightSecAgg — one-shot aggregate-mask reconstruction via Lagrange coding
(a copy of ``fedml_tpu/core/mpc/lightsecagg.py``: numpy uint64 coding on
the host).

Parity target: reference ``core/mpc/lightsecagg.py`` (205 LoC: mask encoding
``mask_encoding``, aggregate decoding ``aggregate_models_in_finite``) and the
LCC primitives of ``core/mpc/secagg.py:213-297``, requantized to
p = 2^31 - 1 (TPU-friendly field, see ``field_ops``).

Protocol shape (So et al.): each client encodes its random mask z_i into n
coded sub-masks via a Lagrange (MDS) code and distributes them; every
surviving client sends the *sum* of the coded sub-masks it holds; the server
interpolates the aggregate polynomial from any T+D surviving responses and
recovers sum_i z_i in one shot — no per-dropout reconstruction round like
SecAgg.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .field_ops import P, lagrange_coeffs_at, np_mul

_P_I = int(P)


def _eval_points(n: int, t: int, d: int):
    """Interpolation points: betas (data) then gammas (privacy padding),
    alphas (client share points) — all distinct, nonzero."""
    betas = np.arange(1, t + 1, dtype=np.uint64)
    gammas = np.arange(t + 1, t + d + 1, dtype=np.uint64)
    alphas = np.arange(t + d + 1, t + d + 1 + n, dtype=np.uint64)
    return betas, gammas, alphas


def _coding_matrix(src_pts: np.ndarray, dst_pts: np.ndarray) -> np.ndarray:
    """[len(dst), len(src)] Lagrange evaluation matrix over GF(p):
    row j = basis coefficients l_k(dst_j) on the src points."""
    rows = [lagrange_coeffs_at(src_pts, int(x)) for x in dst_pts]
    return np.stack(rows).astype(np.uint64)


def _mat_vec_mod(m: np.ndarray, v: np.ndarray) -> np.ndarray:
    """[R, S] x [S, L] mod p with uint64 intermediates (products < 2^62)."""
    out = np.zeros((m.shape[0], v.shape[1]), np.uint64)
    for k in range(m.shape[1]):
        out = (out + np_mul(m[:, k:k + 1], v[k:k + 1, :])) % _P_I
    return out


def mask_encoding(
    z: np.ndarray, n_clients: int, privacy_t: int, split_t: int,
    rng: np.random.RandomState,
) -> np.ndarray:
    """Encode a client's mask ``z`` (length d, field elements) into
    ``n_clients`` coded sub-masks of length d/split_t.

    z is split into ``split_t`` sub-vectors (polynomial values at the betas),
    padded with ``privacy_t`` random sub-vectors (values at the gammas — the
    privacy guarantee), and evaluated at each client's alpha.
    Returns [n_clients, d // split_t].
    """
    d = len(z)
    assert d % split_t == 0, "mask length must divide split_t"
    sub = z.reshape(split_t, d // split_t).astype(np.uint64)
    pad = rng.randint(0, _P_I, size=(privacy_t, d // split_t)).astype(np.uint64)
    data = np.concatenate([sub, pad], axis=0)
    betas, gammas, alphas = _eval_points(n_clients, split_t, privacy_t)
    src = np.concatenate([betas, gammas])
    enc = _coding_matrix(src, alphas)        # [n, split_t + privacy_t]
    return _mat_vec_mod(enc, data)           # [n, d // split_t]


def aggregate_encoded(shares: Sequence[np.ndarray]) -> np.ndarray:
    """Each surviving client sums the coded sub-masks it received (one per
    mask owner) — a single field addition."""
    acc = np.zeros_like(shares[0], dtype=np.uint64)
    for s in shares:
        acc = (acc + s.astype(np.uint64)) % _P_I
    return acc


def decode_aggregate_mask(
    responses: Sequence[np.ndarray], responders: Sequence[int],
    n_clients: int, privacy_t: int, split_t: int, d: int,
) -> np.ndarray:
    """Interpolate sum_i f_i at the betas from >= split_t + privacy_t
    surviving responses; returns the aggregate mask sum_i z_i (length d)."""
    need = split_t + privacy_t
    assert len(responses) >= need, "not enough responders to decode"
    betas, gammas, alphas = _eval_points(n_clients, split_t, privacy_t)
    pts = np.asarray([alphas[r] for r in responders[:need]], np.uint64)
    vals = np.stack([responses[i] for i in range(need)]).astype(np.uint64)
    dec = _coding_matrix(pts, betas)         # [split_t, need]
    sub = _mat_vec_mod(dec, vals)            # [split_t, d // split_t]
    return sub.reshape(d)


def lcc_encode(data: np.ndarray, n_out: int, privacy_t: int,
               rng: np.random.RandomState) -> np.ndarray:
    """General Lagrange-coded-computing encode (reference ``LCC_encoding``):
    [T, L] data sub-blocks -> [n_out, L] coded blocks."""
    t = data.shape[0]
    return mask_encoding(data.reshape(-1), n_out, privacy_t, t, rng)


def lcc_decode(coded: np.ndarray, points_idx: Sequence[int], t: int,
               n_clients: int, privacy_t: int) -> np.ndarray:
    """Inverse of :func:`lcc_encode` given any t + privacy_t coded blocks."""
    l = coded.shape[1]
    return decode_aggregate_mask(
        list(coded), list(points_idx), n_clients, privacy_t, t,
        t * l).reshape(t, l)
