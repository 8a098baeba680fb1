"""The port's Paillier FHE (``fedml_tpu_torch/core/fhe``, a copy of
``fedml_tpu/core/fhe``) against the JAX package's:

* ``keygen`` with the same ``seed_primes`` gives the same keys, and each
  package decrypts the other's ciphertexts;
* ``fhe_fedavg`` decrypts to the JAX package's weighted average bit for
  bit (encryption is randomized, the plaintexts are exact);
* the ``FedMLFHE`` facade's flags and round trip;
* ``enable_secure_agg`` / ``enable_fhe`` are accepted and inert, as in the
  JAX package: a run with either on equals a run with both off bitwise.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fedml_tpu.core import fhe as J
from fedml_tpu.core.fhe import paillier as JP
import fedml_tpu_torch
from fedml_tpu_torch.core import fhe as T
from fedml_tpu_torch.core.fhe import paillier as TP

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def primes():
    """Two 256-bit primes (a 512-bit modulus: fast, NOT for production)."""
    p = JP._gen_prime(256)
    q = JP._gen_prime(256)
    while q == p:
        q = JP._gen_prime(256)
    return p, q


def test_same_primes_same_keys_and_cross_decrypt(primes):
    jpub, jpriv = J.keygen(512, seed_primes=primes)
    tpub, tpriv = T.keygen(512, seed_primes=primes)
    assert (tpub.n, tpriv.lam, tpriv.mu) == (jpub.n, jpriv.lam, jpriv.mu)
    a, b = 123456789, 987654321
    ca, cb = tpub.encrypt_int(a), jpub.encrypt_int(b)
    assert jpriv.decrypt_int(ca) == a and tpriv.decrypt_int(cb) == b
    assert tpriv.decrypt_int(jpub.add(ca, cb)) == a + b
    assert tpub.encrypt_int(a) != ca       # randomized encryption
    assert TP._is_probable_prime(primes[0]) and TP._is_probable_prime(
        primes[1])


def test_fhe_fedavg_bitwise(primes):
    pub, priv = T.keygen(512, seed_primes=primes)
    jpub, jpriv = J.keygen(512, seed_primes=primes)
    rs = np.random.RandomState(1)
    vecs = [rs.randn(300) for _ in range(4)]
    weights = [10.0, 20.0, 30.0, 40.0]
    got = T.fhe_fedavg(vecs, weights, pub, priv)
    want = J.fhe_fedavg(vecs, weights, jpub, jpriv)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    plain = sum(v * (w / sum(weights)) for v, w in zip(vecs, weights))
    np.testing.assert_allclose(got, plain, atol=1e-4)
    # packed slots: the port's ciphertexts unpack with the JAX package
    cts = [TP.pack_vector(v, pub) for v in vecs[:2]]
    np.testing.assert_array_equal(
        JP.unpack_vector(TP.add_ciphertexts(cts, pub), jpriv, 300, 2),
        TP.unpack_vector(JP.add_ciphertexts(cts, jpub), priv, 300, 2))


def test_facade_flags():
    class A:
        enable_fhe = True
        fhe_key_bits = 256

    f = T.FedMLFHE(A())
    assert f.is_fhe_enabled() and f.key_bits == 256
    assert not T.FedMLFHE(None).is_fhe_enabled()
    v = np.array([0.5, -1.25, 3.0])
    cts = f.fhe_enc(v)
    np.testing.assert_allclose(f.fhe_dec(cts, 3), v, atol=1e-4)
    np.testing.assert_allclose(f.fhe_dec(f.fhe_agg([cts, cts]), 3,
                                         n_added=2), 2 * v, atol=1e-4)


CFG = dict(dataset="synthetic_mnist", model="lr", client_num_in_total=4,
           client_num_per_round=2, comm_round=2, epochs=1, batch_size=16,
           learning_rate=0.1, random_seed=3, max_total_samples=64,
           enable_tracking=False)


@pytest.mark.parametrize("backend", ["gpu", "sp"])
def test_secure_agg_and_fhe_flags_are_inert(backend):
    off = fedml_tpu_torch.run_simulation(backend=backend, device="cpu",
                                         **CFG)
    for knob in ("enable_secure_agg", "enable_fhe"):
        on = fedml_tpu_torch.run_simulation(backend=backend, device="cpu",
                                            **CFG, **{knob: True})
        for k, v in off["params"].items():
            assert torch.equal(v, on["params"][k]), (knob, k)
        metrics = ("train_loss", "test_acc", "test_loss")
        assert [[h.get(m) for m in metrics] for h in on["history"]] == \
            [[h.get(m) for m in metrics] for h in off["history"]]
