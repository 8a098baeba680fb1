"""The port's federated serving (``training_type: fedml_serving``) against
the JAX package's.

A 1-round session (synthetic MNIST, LR, 2 silos over INPROC, seed 9, the
JAX init carried across) runs through each package's
``FederatedServingRunner`` on the server side; the aggregate goes live on
``/predict``, and the port's HTTP prediction equals the JAX endpoint's
within house tolerance (the same classes). The runner dispatches
``fedml_serving`` (and ``serving``), and a silo's role runs a plain silo.
"""

from __future__ import annotations

import copy
import json
import threading
import urllib.request

import jax
import numpy as np
import pytest

from fedml_tpu import data as jdata
from fedml_tpu import model as jmodel
from fedml_tpu.arguments import Arguments as JArgs
from fedml_tpu_torch import data as tdata
from fedml_tpu_torch import model as tmodel
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.interop import flax_to_state_dict

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 2e-4, 2e-5
SERVE = dict(dataset="synthetic_mnist", model="lr", client_num_in_total=2,
             client_num_per_round=2, comm_round=1, epochs=1, batch_size=32,
             learning_rate=0.1, frequency_of_the_test=1, random_seed=9,
             max_total_samples=256, backend="INPROC", role="server",
             serving_block=False, enable_tracking=False)


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _serve(server_runner, clients):
    threads = [threading.Thread(target=c.run, daemon=True) for c in clients]
    for t in threads:
        t.start()
    result = server_runner.run()
    for t in threads:
        t.join(timeout=30)
    return result


def _jax_endpoint(cfg):
    from fedml_tpu.core.distributed.communication.inproc import InProcBroker
    from fedml_tpu.cross_silo.horizontal.runner import build_client
    from fedml_tpu.runner import FedMLRunner as JRunner
    args = JArgs(**dict(cfg, training_type="fedml_serving"))
    args.inproc_broker = InProcBroker()
    fed, od = jdata.load(args)
    bundle = jmodel.create(args, od)
    key = jax.random.split(jax.random.PRNGKey(cfg["random_seed"]))[0]
    init = flax_to_state_dict(jax.device_get(bundle.init(
        key, fed.train.x[0, 0])))
    runner = JRunner(args, dataset=fed, model=bundle)
    clients = [build_client(args, fed, bundle, rank=r, backend="INPROC")
               for r in (1, 2)]
    result = _serve(runner, clients)
    return runner.runner.inference_runner, result, init, fed


def test_served_aggregate_matches_jax():
    from fedml_tpu_torch.core.distributed.communication.inproc import \
        InProcBroker
    from fedml_tpu_torch.cross_silo.horizontal.runner import build_client
    from fedml_tpu_torch.runner import FedMLRunner
    from fedml_tpu_torch.serving.federated import FederatedServingRunner
    jrunner, jresult, init, jfed = _jax_endpoint(SERVE)
    args = Arguments(**dict(SERVE, training_type="fedml_serving"))
    args.inproc_broker = InProcBroker()
    fed, od = tdata.load(args)
    bundle = tmodel.create(args, od, fed.input_shape)
    runner = FedMLRunner(args, device="cpu", dataset=fed, model=bundle,
                         init_params=init)
    assert isinstance(runner.runner, FederatedServingRunner)
    clients = [build_client(args, fed, copy.deepcopy(bundle), rank=r,
                            backend="INPROC", device="cpu") for r in (1, 2)]
    try:
        result = _serve(runner, clients)
        port = result["serving_port"]
        x = np.asarray(fed.test["x"])[0, :8]
        got = _post(port, {"inputs": x.tolist()})
        ref = _post(jresult["serving_port"], {"inputs": x.tolist()})
        np.testing.assert_allclose(got["outputs"], ref["outputs"],
                                   rtol=RTOL, atol=ATOL)
        assert got["classes"] == ref["classes"]
        assert result["final_test_acc"] == jresult["final_test_acc"]
    finally:
        jrunner.stop()
        if runner.runner.inference_runner is not None:
            runner.runner.inference_runner.stop()


@pytest.mark.parametrize("ttype", ["fedml_serving", "serving"])
def test_client_role_is_a_plain_silo(ttype):
    from fedml_tpu_torch.core.distributed.communication.inproc import \
        InProcBroker
    from fedml_tpu_torch.cross_silo.client.fedml_client_master_manager \
        import ClientMasterManager
    from fedml_tpu_torch.runner import FedMLRunner
    from fedml_tpu_torch.serving.federated import FederatedServingRunner
    args = Arguments(**dict(SERVE, training_type=ttype, role="client",
                            rank=1))
    args.inproc_broker = InProcBroker()
    fed, od = tdata.load(args)
    runner = FedMLRunner(args, device="cpu", dataset=fed,
                         model=tmodel.create(args, od, fed.input_shape))
    assert isinstance(runner.runner, FederatedServingRunner)
    manager = runner.runner.inner.manager
    assert isinstance(manager, ClientMasterManager)
    manager.com_manager.stop_receive_message()
