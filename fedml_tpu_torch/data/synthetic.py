"""Synthetic datasets (deterministic, no network).

A copy of ``fedml_tpu/data/synthetic.py``, which imports no JAX: the
CIFAR/MNIST-shaped stand-ins (class prototypes plus Gaussian noise), the
LEAF-style ``synthetic_alpha_beta`` federated generator, the multilabel
(stackoverflow_lr) and sequence (next-token) stand-ins and the segmentation
maps, each drawn from one ``RandomState`` so the port's arrays equal the
JAX package's bit for bit (``tests/test_torch_copies.py`` pins it).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def make_classification(
    n_samples: int,
    n_features: int,
    n_classes: int,
    seed: int = 0,
    noise: float = 1.0,
    flat: bool = True,
    image_shape: Tuple[int, ...] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.RandomState(seed)
    prototypes = rng.randn(n_classes, n_features).astype(np.float32)
    y = rng.randint(0, n_classes, size=n_samples).astype(np.int32)
    x = prototypes[y] + noise * rng.randn(n_samples, n_features).astype(np.float32)
    if not flat and image_shape is not None:
        x = x.reshape((n_samples,) + tuple(image_shape))
    return x, y


def synthetic_mnist(n_train: int = 6000, n_test: int = 1000, seed: int = 0,
                    flat: bool = True):
    """784-feature, 10-class MNIST-shaped task."""
    shape = (28, 28, 1)
    x, y = make_classification(n_train + n_test, 784, 10, seed=seed,
                               noise=2.0, flat=flat, image_shape=shape)
    return (x[:n_train], y[:n_train]), (x[n_train:], y[n_train:])


def synthetic_cifar10(n_train: int = 5000, n_test: int = 1000, seed: int = 0):
    """32×32×3, 10-class CIFAR-shaped task (images, for conv models)."""
    shape = (32, 32, 3)
    x, y = make_classification(n_train + n_test, 32 * 32 * 3, 10, seed=seed,
                               noise=3.0, flat=False, image_shape=shape)
    return (x[:n_train], y[:n_train]), (x[n_train:], y[n_train:])


def synthetic_federated(
    alpha: float = 1.0,
    beta: float = 1.0,
    num_clients: int = 30,
    n_features: int = 60,
    n_classes: int = 10,
    seed: int = 0,
):
    """The reference's ``synthetic_1_1``-style generator (Li et al.,
    "Federated Optimization in Heterogeneous Networks"): per-client logistic
    models W_k ~ N(u_k, 1) with u_k ~ N(0, alpha), and per-client feature
    distributions x ~ N(v_k, diag(j^-1.2)) with v_k ~ N(B_k, 1),
    B_k ~ N(0, beta). alpha controls model heterogeneity, beta data
    heterogeneity. Returns (client_xs, client_ys, test_x, test_y) with the
    natural per-client partition."""
    rng = np.random.RandomState(seed)
    diag = np.array([(j + 1) ** -1.2 for j in range(n_features)])
    samples_per = rng.lognormal(4, 1, num_clients).astype(int) + 50
    u = rng.normal(0, alpha, num_clients)
    b_loc = rng.normal(0, beta, num_clients)
    cxs, cys = [], []
    for k in range(num_clients):
        v_k = rng.normal(b_loc[k], 1.0, n_features)
        w_k = rng.normal(u[k], 1.0, (n_features, n_classes))
        bias_k = rng.normal(u[k], 1.0, n_classes)
        x = rng.multivariate_normal(v_k, np.diag(diag), samples_per[k]
                                    ).astype(np.float32)
        logits = x @ w_k + bias_k
        y = np.argmax(logits, axis=1).astype(np.int32)
        cxs.append(x)
        cys.append(y)
    # global test set: held-out 10% of each client's data (disjoint)
    txs, tys, new_cxs, new_cys = [], [], [], []
    for x, y in zip(cxs, cys):
        cut = max(len(x) // 10, 5)
        txs.append(x[:cut])
        tys.append(y[:cut])
        new_cxs.append(x[cut:])
        new_cys.append(y[cut:])
    return new_cxs, new_cys, np.concatenate(txs), np.concatenate(tys)


def synthetic_multilabel(
    n_train: int = 4000, n_test: int = 500, n_features: int = 1000,
    n_tags: int = 50, seed: int = 0,
):
    """Stackoverflow-LR stand-in: sparse bag-of-words features, multi-hot
    tag labels from a sparse linear model (the reference's task is 10k
    features / 500 tags tag-prediction with BCE)."""
    rng = np.random.RandomState(seed)
    n = n_train + n_test
    x = (rng.rand(n, n_features) < 0.02).astype(np.float32)
    w = rng.randn(n_features, n_tags) * (rng.rand(n_features, n_tags) < 0.05)
    scores = x @ w
    thresh = np.percentile(scores, 90, axis=0, keepdims=True)
    y = (scores > thresh).astype(np.float32)
    return (x[:n_train], y[:n_train]), (x[n_train:], y[n_train:])


def synthetic_sequences(n_train: int = 2000, n_test: int = 400,
                        seq_len: int = 32, vocab: int = 64, seed: int = 0):
    """Next-token-predictable integer sequences (Shakespeare-NWP stand-in):
    class = parity pattern of a hidden Markov-ish generator."""
    rng = np.random.RandomState(seed)
    n = n_train + n_test
    # order-1 Markov chain with a random sparse transition structure
    trans = rng.dirichlet(np.ones(vocab) * 0.1, size=vocab).astype(np.float32)
    seqs = np.zeros((n, seq_len), np.int32)
    state = rng.randint(0, vocab, size=n)
    for t in range(seq_len):
        seqs[:, t] = state
        u = rng.rand(n, 1)
        state = (np.cumsum(trans[state], axis=1) < u).sum(axis=1).clip(0, vocab - 1)
    x = seqs[:, :-1]
    y = seqs[:, 1:]
    return (x[:n_train], y[:n_train]), (x[n_train:], y[n_train:])


def synthetic_segmentation(n_train: int = 400, n_test: int = 80,
                           size: int = 16, n_classes: int = 3,
                           seed: int = 0):
    """Dense-labeling stand-in for FedSeg: each image contains an axis-
    aligned rectangle of a random foreground class on background class 0;
    the label map is per-pixel. Learnable by a small encoder-decoder."""
    rs = np.random.RandomState(seed)
    n = n_train + n_test
    x = rs.rand(n, size, size, 3).astype(np.float32) * 0.3
    y = np.zeros((n, size, size), np.int64)
    for i in range(n):
        c = rs.randint(1, n_classes)
        h0, w0 = rs.randint(0, size // 2, 2)
        h1 = h0 + rs.randint(3, size // 2)
        w1 = w0 + rs.randint(3, size // 2)
        x[i, h0:h1, w0:w1, :] += np.asarray(
            [0.8 if ch == (c - 1) % 3 else 0.1 for ch in range(3)],
            np.float32)
        y[i, h0:h1, w0:w1] = c
    return (x[:n_train], y[:n_train]), (x[n_train:], y[n_train:])
