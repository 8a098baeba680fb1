"""The minimum end-to-end slice (``tests/test_e2e_slice.py``) on the port:
FedAvg on MNIST-shaped data with logistic regression through the SP golden
loop and the GPU engine (on the CPU) — learning happens, and the two
backends agree. The port's SP loop is also held to the JAX package's SP
loop from the same flax-drawn parameters (carried across by
``fedml_tpu_torch.interop``).

Tolerance: the house float32 one, ``rtol=2e-4, atol=2e-5``.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu.data as jdata
import fedml_tpu.model as jmodel
from fedml_tpu.arguments import Arguments as JArguments
import fedml_tpu_torch
from fedml_tpu_torch import data as tdata
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.interop import flax_to_state_dict
from fedml_tpu_torch.model import model_hub as thub

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 2e-4, 2e-5


def make_args(**kw):
    base = dict(dataset="synthetic_mnist", model="lr",
                client_num_in_total=8, client_num_per_round=8,
                comm_round=4, epochs=1, batch_size=16, learning_rate=0.1,
                frequency_of_the_test=2, random_seed=42)
    base.update(kw)
    return base


def _run(backend, **kw):
    return fedml_tpu_torch.run_simulation(backend=backend, device="cpu",
                                          **make_args(**kw))


def _assert_params_close(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("backend", ["sp", "gpu"])
def test_backend_learns(backend):
    result = _run(backend, comm_round=10)
    assert result["final_test_acc"] > 0.5, result["history"][-1]


def test_sp_gpu_parity():
    r_sp, r_gpu = _run("sp"), _run("gpu")
    _assert_params_close(r_sp["params"], r_gpu["params"])
    for hs, hg in zip(r_sp["history"], r_gpu["history"]):
        assert set(hs) <= set(hg)
        for k in ("train_loss", "train_acc", "test_acc", "test_loss"):
            if k in hs:
                np.testing.assert_allclose(hg[k], hs[k], rtol=RTOL,
                                           atol=ATOL, err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(client_num_in_total=16, client_num_per_round=5, comm_round=3),
    dict(client_num_in_total=11, client_num_per_round=6, comm_round=2)],
    ids=["partial_participation", "uneven_11_over_6"])
def test_partial_participation_parity(kw):
    r_sp, r_gpu = _run("sp", **kw), _run("gpu", **kw)
    assert np.isfinite(r_gpu["final_test_acc"])
    _assert_params_close(r_sp["params"], r_gpu["params"])


@pytest.mark.parametrize("kw", [{}, dict(client_num_in_total=11,
                                         client_num_per_round=6)],
                         ids=["full", "partial"])
def test_sp_matches_jax_sp(kw):
    """The port's golden loop against the JAX package's, from the flax
    parameters the JAX loop draws (``split(PRNGKey(seed))[0]``)."""
    cfg = make_args(**kw)
    jargs = JArguments(backend="sp", **cfg)
    fed, out_dim = jdata.load(jargs)
    key = jax.random.split(jax.random.PRNGKey(cfg["random_seed"]))[0]
    p0 = jax.device_get(jmodel.create(jargs, out_dim).init(
        key, fed.train.x[0, 0]))
    rj = fedml_tpu.run_simulation(backend="sp", args=JArguments(
        backend="sp", **cfg))
    rt = fedml_tpu_torch.run_simulation(
        backend="sp", device="cpu", init_params=flax_to_state_dict(p0),
        **cfg)
    assert len(rt["history"]) == len(rj["history"]) == cfg["comm_round"]
    for ht, hj in zip(rt["history"], rj["history"]):
        assert set(ht) == set(hj)
        for k in set(hj) - {"round"}:
            np.testing.assert_allclose(ht[k], hj[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    _assert_params_close(rt["params"],
                         flax_to_state_dict(jax.device_get(rj["params"])))
    assert rt["final_test_acc"] == rj["final_test_acc"]


@pytest.mark.parametrize("dataset,model", [
    ("synthetic_mnist", "lr"), ("synthetic_fashionmnist", "mlp"),
    ("synthetic_mnist", "resnet20")])
def test_mnist_shaped_data_exactly_equal(dataset, model):
    """The MNIST-shaped stand-ins, flat for the linear models."""
    cfg = dict(dataset=dataset, model=model, client_num_in_total=5,
               batch_size=8, random_seed=1, max_total_samples=120,
               synthetic_test_size=24)
    fj, _ = jdata.load(JArguments(**cfg))
    ft, out_dim = tdata.load(Arguments(**cfg))
    assert out_dim == 10 and ft.provenance == "synthetic"
    assert ft.input_shape == fj.input_shape
    for name in ("x", "y", "mask", "num_samples"):
        np.testing.assert_array_equal(getattr(ft.train, name),
                                      np.asarray(getattr(fj.train, name)))
    for name in ("x", "y", "mask"):
        np.testing.assert_array_equal(ft.test[name],
                                      np.asarray(fj.test[name]))


@pytest.mark.parametrize("model", ["lr", "logistic_regression", "mlp"])
def test_linear_models_match_flax(model):
    """Logits of the port's linear models on flax's parameters, carried
    across by name (``Dense_k``)."""
    cfg = dict(dataset="synthetic_mnist", model=model)
    jb = jmodel.create(JArguments(**cfg), 10)
    x = np.random.RandomState(0).randn(6, 784).astype(np.float32)
    pj = jax.device_get(jb.init(jax.random.PRNGKey(3), x))
    tb = thub.create(Arguments(**cfg), 10, (784,))
    sd = flax_to_state_dict(pj)
    assert set(sd) == set(tb.template())
    got = tb.apply({k: torch.tensor(v) for k, v in sd.items()},
                   torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jb.apply(pj, x)),
                               rtol=RTOL, atol=ATOL)


def test_sp_backend_aliases_and_refusals():
    assert Arguments(backend="single_process").backend == "sp"
    assert Arguments(backend="mesh").backend == "gpu"
    # the SP loop has no chaos (as in the JAX package), and async rounds
    # are the GPU engine's (the SP loop names Async_FedAvg, as JAX does);
    # its pacer and contribution run
    with pytest.raises(NotImplementedError, match="chaos_dropout_prob"):
        _run("sp", chaos_dropout_prob=0.2)
    with pytest.raises(ValueError, match="round_mode.*Async_FedAvg"):
        _run("sp", round_mode="async_buffered")
    with pytest.raises(NotImplementedError, match="backend"):
        _run("fedml_native")
