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
