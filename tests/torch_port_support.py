"""Shared fixture and helpers of the ``tests/test_torch_*.py`` files.

Import ``single_torch_thread`` into a test module to make it autouse there.
The helpers build both packages' simulators from one configuration dict
(``jax_sim``, ``port_sim``, ``jax_init``) and compare their parameters.
"""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """Run the module's torch ops on one thread. The tier-1 run puts several
    pytest workers on one shared CPU; at these tiny shapes torch's per-worker
    thread pool only oversubscribes it and slows every worker."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- the round under faults and selection: both packages' simulators -------

RTOL, ATOL = 2e-4, 2e-5

LR_BASE = dict(dataset="synthetic_mnist", model="lr", client_num_in_total=8,
               client_num_per_round=4, comm_round=3, epochs=1,
               batch_size=16, learning_rate=0.1, frequency_of_the_test=100,
               random_seed=7, max_total_samples=400)


def jax_init(cfg):
    """The flax parameters the JAX simulators draw for ``cfg`` (the init
    half of ``split(PRNGKey(random_seed))``)."""
    import jax
    import fedml_tpu.data as jdata
    import fedml_tpu.model as jmodel
    from fedml_tpu.arguments import Arguments as JArguments

    jargs = JArguments(backend="sp", **cfg)
    fed, out_dim = jdata.load(jargs)
    key = jax.random.split(jax.random.PRNGKey(cfg["random_seed"]))[0]
    return jax.device_get(jmodel.create(jargs, out_dim).init(
        key, fed.train.x[0, 0]))


def jax_sim(cfg, backend="tpu", server_aggregator=None):
    """The JAX package's simulator for ``cfg`` (``TPUSimulator`` on the
    CPU's virtual devices, or the SP loop), built as ``run_simulation``
    builds it."""
    import fedml_tpu
    import fedml_tpu.data as jdata
    import fedml_tpu.model as jmodel
    from fedml_tpu.runner import FedMLRunner as JRunner

    jargs = fedml_tpu.init(None, backend=backend, **cfg)
    jargs.training_type = "simulation"
    fed, out_dim = jdata.load(jargs)
    return JRunner(jargs, dataset=fed, model=jmodel.create(jargs, out_dim),
                   server_aggregator=server_aggregator).runner


def port_sim(cfg, backend="gpu", init_params=None, server_aggregator=None):
    """The port's simulator for ``cfg`` on the CPU."""
    from fedml_tpu_torch import data as tdata
    from fedml_tpu_torch import model as tmodel
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.runner import FedMLRunner

    args = Arguments(backend=backend, **cfg)
    fed, out_dim = tdata.load(args)
    bundle = tmodel.create(args, out_dim, fed.input_shape)
    return FedMLRunner(args, device="cpu", dataset=fed, model=bundle,
                       server_aggregator=server_aggregator,
                       init_params=init_params).runner


def jax_params(params):
    """JAX params as the port's state dict (numpy)."""
    import jax
    from fedml_tpu_torch.interop import flax_to_state_dict

    return flax_to_state_dict(jax.device_get(params))


def assert_params_close(port_params, want, **tol):
    import numpy as np

    assert set(port_params) == set(want)
    for k in want:
        np.testing.assert_allclose(
            np.asarray(port_params[k]), np.asarray(want[k]),
            **(tol or dict(rtol=RTOL, atol=ATOL)), err_msg=k)


def assert_params_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# -- the model zoo and tasks: one configuration through both packages --------


@pytest.fixture
def narrow_lstm(monkeypatch):
    """Both packages' ``model.create`` build the Shakespeare LSTM at
    hidden 16 (embedding 8, 2 layers), so the run stays small."""
    import fedml_tpu.model as jmodel
    import fedml_tpu_torch.model as tmodel
    from fedml_tpu.model.model_hub import ModelBundle as JBundle
    from fedml_tpu.model.nlp.rnn import RNNShakespeare as JRNN
    from fedml_tpu_torch.model.model_hub import ModelBundle as TBundle
    from fedml_tpu_torch.model.nlp.rnn import RNNShakespeare as TRNN

    monkeypatch.setattr(jmodel, "create", lambda args, out: JBundle(
        JRNN(out, 8, 16, 2), "rnn"))
    monkeypatch.setattr(tmodel, "create", lambda args, out, shape=None:
                        TBundle(TRNN(out, 8, 16, 2), "rnn"))


def zoo_jax_init(cfg, tmp_path):
    """The flax parameters the JAX engine starts ``cfg`` from, as the
    port's state dict."""
    import jax
    import fedml_tpu.data as jdata
    import fedml_tpu.model as jmodel
    from fedml_tpu.arguments import Arguments as JArguments
    from fedml_tpu_torch.interop import flax_to_state_dict

    args = JArguments(backend="tpu", data_cache_dir=str(tmp_path), **cfg)
    fed, out = jdata.load(args)
    key = jax.random.split(jax.random.PRNGKey(cfg["random_seed"]))[0]
    return flax_to_state_dict(jax.device_get(
        jmodel.create(args, out).init(key, fed.train.x[0, 0])))


def zoo_runs(cfg, tmp_path):
    """``cfg`` through ``fedml_tpu.run_simulation`` (TPU engine on the
    virtual CPU devices) and the port's GPU engine and SP loop on the CPU,
    from the same params: the port's GPU engine within the house tolerance
    of JAX (params and history), bitwise equal to its SP loop. Returns
    (the port's GPU run, the JAX run)."""
    import jax
    import numpy as np
    import fedml_tpu
    import fedml_tpu_torch
    from fedml_tpu_torch.interop import flax_to_state_dict

    p0 = zoo_jax_init(cfg, tmp_path)
    rj = fedml_tpu.run_simulation(backend="tpu", data_cache_dir=str(
        tmp_path / "j"), **cfg)
    runs = {b: fedml_tpu_torch.run_simulation(
        backend=b, device="cpu", init_params=p0,
        data_cache_dir=str(tmp_path / "t"), **cfg) for b in ("gpu", "sp")}
    want = flax_to_state_dict(jax.device_get(rj["params"]))
    assert_params_close(runs["gpu"]["params"], want)
    assert_params_equal(runs["gpu"]["params"], runs["sp"]["params"])
    for ht, hj in zip(runs["gpu"]["history"], rj["history"]):
        for k in ("train_loss", "train_acc", "test_acc", "test_loss"):
            np.testing.assert_allclose(ht[k], hj[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    moved = max(float(np.abs(want[k] - p0[k]).max()) for k in want)
    assert moved > 1e-3
    return runs["gpu"], rj




# -- the port over W gloo rank processes against the JAX engine on W devices --


def rank_runs(target, world, timeout=300.0, **kwargs):
    """``tests/torch_rank_programs.py``'s ``target`` over ``world`` gloo
    rank processes (``core/launch.py::run_ranks``): each rank's return."""
    import os

    from fedml_tpu_torch.core.launch import run_ranks
    here = os.path.dirname(os.path.abspath(__file__))
    return run_ranks(f"torch_rank_programs:{target}", world, kwargs,
                     timeout=timeout, sys_path=[here])


def jax_on_devices(cfg, w, monkeypatch, **kw):
    """The JAX package's simulator for ``cfg`` on ``mesh_shape={"client":
    w}`` over the first ``w`` virtual CPU devices."""
    import jax

    import fedml_tpu.simulation.tpu.engine as jengine
    from fedml_tpu.core.mesh import build_mesh as jbuild_mesh
    monkeypatch.setattr(jengine, "build_mesh", lambda shape: jbuild_mesh(
        shape, devices=jax.devices()[:w]))
    sim = jax_sim(dict(cfg, mesh_shape={"client": w}), **kw)
    assert sim.n_devices == w
    return sim


def assert_history_close(got, want, **tol):
    import numpy as np

    assert len(got) == len(want)
    for ht, hj in zip(got, want):
        for k in ("train_loss", "train_acc", "test_acc", "test_loss"):
            if k in hj:
                np.testing.assert_allclose(
                    ht[k], hj[k], **(tol or dict(rtol=RTOL, atol=ATOL)),
                    err_msg=k)


def assert_ranks_bitwise(runs, name):
    """Every rank's params and history equal rank 0's, bitwise."""
    import numpy as np

    for other in runs[1:]:
        for k, v in runs[0][name]["params"].items():
            assert np.array_equal(v, other[name]["params"][k]), (name, k)
        assert other[name]["history"] == runs[0][name]["history"], name
