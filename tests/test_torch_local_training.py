"""One client's local SGD in the port against the JAX package's
``run_local_sgd``: same start params, same padded batches, same PRNG key ->
the same trajectory (params and summed metrics) within the house float32
tolerance. The epoch order, the dynamic real-step count and masked padded
batches all have to match for that to hold.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.core.algframe import client_trainer as jct
from fedml_tpu.core.algframe.local_training import run_local_sgd as j_run
from fedml_tpu.core.algframe.types import ClientData as JClientData
from fedml_tpu.core.algframe.types import TrainHyper as JHyper
from fedml_tpu.model.model_hub import ModelBundle as JBundle
from fedml_tpu.model.cv.resnet import CifarResNet as JResNet
from fedml_tpu_torch import prng
from fedml_tpu_torch.core.algframe import client_trainer as tct
from fedml_tpu_torch.core.algframe.local_training import (evaluate,
                                                          run_local_sgd)
from fedml_tpu_torch.core.algframe.types import ClientData, TrainHyper
from fedml_tpu_torch.interop import flax_to_state_dict
from fedml_tpu_torch.model.model_hub import ModelBundle as TBundle
from fedml_tpu_torch.model.cv.resnet import CifarResNet as TResNet

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 2e-4, 2e-5


def _client(n_batches, bs, real_counts, seed):
    """Padded client arrays: ``real_counts[i]`` real samples in batch i."""
    rs = np.random.RandomState(seed)
    x = rs.randn(n_batches, bs, 8, 8, 3).astype(np.float32)
    y = rs.randint(0, 10, (n_batches, bs)).astype(np.int32)
    mask = np.zeros((n_batches, bs), np.float32)
    for i, c in enumerate(real_counts):
        mask[i, :c] = 1.0
    x *= mask[..., None, None, None]
    return x, y, mask, np.float32(mask.sum())


CASES = {
    # name: (batches, real samples per batch, epochs, optimizer, kwargs)
    "multi_batch_sgd": (3, [4, 4, 4], 2, "sgd", {}),
    "ragged_padded_momentum_wd": (
        5, [4, 4, 1, 0, 0], 2, "sgd",
        dict(momentum=0.9, weight_decay=5e-4)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_one_client_matches_jax(case):
    nb, counts, epochs, name, opt_kw = CASES[case]
    x, y, mask, n = _client(nb, 4, counts, seed=3)
    lr = 0.05
    jb = JBundle(JResNet(10, 1), "resnet")
    p0 = jax.device_get(jb.init(jax.random.PRNGKey(0), jnp.asarray(x[0])))
    key = prng.fold_in(prng.PRNGKey(5), 2)
    pj, _, mj = j_run(
        jct.ClassificationTrainer(jb.apply),
        jct.make_inner_optimizer(name, lr, **opt_kw), p0,
        JClientData(x=jnp.asarray(x), y=jnp.asarray(y),
                    mask=jnp.asarray(mask), num_samples=jnp.float32(n)),
        jnp.asarray(key), JHyper(learning_rate=jnp.float32(lr),
                                 epochs=epochs))
    tb = TBundle(TResNet(10, 1), "resnet")
    sd = {k: torch.tensor(v) for k, v in flax_to_state_dict(p0).items()}
    cdata = ClientData(x, y, mask, np.float32(n)).to(torch.device("cpu"))
    pt, steps, mt = run_local_sgd(
        tct.ClassificationTrainer(tb.apply),
        tct.make_inner_optimizer(name, lr, **opt_kw), sd, cdata, key,
        TrainHyper(learning_rate=lr, epochs=epochs))
    assert steps == epochs * sum(1 for c in counts if c)
    for k in ("loss_sum", "correct", "count"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    assert float(mt["count"]) == epochs * sum(counts)
    want = flax_to_state_dict(jax.device_get(pj))
    moved = 0.0
    for k, v in pt.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
        moved = max(moved, float(np.abs(want[k] - sd[k].numpy()).max()))
    assert moved > 1e-3  # the client really trained


@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("sgd", dict(momentum=0.9)),
    ("sgd", dict(momentum=0.9, weight_decay=1e-2)),
    ("adam", {}), ("adam", dict(weight_decay=1e-2)),
    ("adamw", dict(weight_decay=1e-2))])
def test_inner_optimizer_matches_optax(name, kw):
    """Five in-place steps of the port's inner optimizer against optax on
    the same params and gradient stream."""
    rs = np.random.RandomState(4)
    p = {"a": rs.randn(5, 3).astype(np.float32),
         "b": rs.randn(7).astype(np.float32)}
    tx = jct.make_inner_optimizer(name, 0.1, **kw)
    st = tx.init(p)
    ours = tct.make_inner_optimizer(name, 0.1, **kw)
    pt = {k: torch.tensor(v) for k, v in p.items()}
    ost = ours.init(pt)
    for _ in range(5):
        g = {k: rs.randn(*v.shape).astype(np.float32) for k, v in p.items()}
        u, st = tx.update(g, st, p)
        p = optax.apply_updates(p, u)
        ours.step_(pt, {k: torch.tensor(v) for k, v in g.items()}, ost)
    for k in p:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(p[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_unknown_inner_optimizer_raises():
    with pytest.raises(ValueError, match="client_optimizer"):
        tct.make_inner_optimizer("lamb", 0.1)


def test_evaluate_sums_masked_stats():
    x, y, mask, _ = _client(2, 4, [4, 2], seed=8)
    tb = TBundle(TResNet(10, 1), "resnet")
    params = tb.init(torch.Generator().manual_seed(0), torch.device("cpu"))
    spec = tct.ClassificationTrainer(tb.apply)
    stats = evaluate(spec, params, torch.tensor(x), torch.tensor(y),
                     torch.tensor(mask))
    assert float(stats["count"]) == 6.0
    assert 0.0 <= float(stats["correct"]) <= 6.0
    assert np.isfinite(float(stats["loss_sum"]))


class _Programs:
    """What the GPU engine hands ``local_train``: one step program and one
    gradient program, built at first use."""

    def __init__(self, opt, params, server_state, cdata, hyper):
        from fedml_tpu_torch.core.algframe.local_training import GradProgram
        self.step = opt.make_step_program(params, server_state, cdata, hyper)
        self.grad = GradProgram(opt.spec, params, cdata)

    def step_program(self, hyper):
        return self.step

    def grad_program(self, cdata):
        return self.grad


@pytest.mark.parametrize("name", ["FedProx", "SCAFFOLD", "FedDyn", "Mime"])
def test_step_program_with_transform_equals_eager_loop(name):
    """The optimizer's ``grad_transform`` inside the step program (its ctx
    copied into static tensors per client) against the eager loop with the
    same transform, bitwise, for three clients through one program; the
    transform moves the update away from FedAvg's."""
    from types import SimpleNamespace
    from fedml_tpu_torch.core.algframe.local_training import batch_real_of
    from fedml_tpu_torch.core.collectives import tree_map
    from fedml_tpu_torch.optimizers import create_optimizer

    tb = TBundle(TResNet(10, 1), "resnet")
    spec = tct.ClassificationTrainer(tb.apply)
    params = tb.init(torch.Generator().manual_seed(0), torch.device("cpu"))
    args = SimpleNamespace(federated_optimizer=name, fedprox_mu=0.5,
                           feddyn_alpha=0.3, server_momentum=0.7,
                           client_num_in_total=4, client_num_per_round=2)
    opt = create_optimizer(args, spec)
    fedavg = create_optimizer(SimpleNamespace(), spec)
    gen = torch.Generator().manual_seed(1)
    rand = lambda t: 0.05 * torch.randn(t.shape, generator=gen)  # noqa
    server_state = tree_map(rand, opt.server_init(params))
    hyper = TrainHyper(learning_rate=0.05, epochs=2)
    clients = [ClientData(*_client(3, 4, c, seed)).to(torch.device("cpu"))
               for c, seed in (([4, 4, 2], 1), ([4, 0, 0], 2),
                               ([3, 4, 4], 3))]
    programs = _Programs(opt, params, server_state, clients[0], hyper)
    for i, cdata in enumerate(clients):
        cstate = tree_map(rand, opt.client_state_init(params))
        key = np.asarray([0, i + 11], np.uint32)
        real = batch_real_of(cdata.mask)
        eager, se = opt.local_train(params, server_state, cstate, cdata,
                                    key, hyper, batch_real=real)
        prog, sp_ = opt.local_train(params, server_state, cstate, cdata,
                                    key, hyper, batch_real=real,
                                    programs=programs)
        assert se == sp_ == 2 * int(real.sum())
        for field in ("update", "client_state", "extras", "metrics"):
            a, b = getattr(eager, field), getattr(prog, field)
            tree_map(lambda x, y: torch.equal(x, y) or pytest.fail(
                f"{name} client {i}: {field} differs"), a, b)
        plain, _ = fedavg.local_train(params, {}, {}, cdata, key, hyper,
                                      batch_real=real)
        if name == "Mime":   # its SGD runs on the first half of split(key)
            continue
        assert max(float((prog.update[k] - plain.update[k]).abs().max())
                   for k in params) > 1e-6
    assert programs.step.grad_transform is not None
    assert programs.step.captures == 0 and programs.step.replays == 0
