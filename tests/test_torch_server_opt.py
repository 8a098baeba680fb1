"""The optimizers' pieces on the port against the JAX package, one function
at a time:

- FedOpt's four server optimizers (``fedopt.ServerOptimizer``) against
  optax 0.2.6 for 5 steps on the same seeded float32 trees (sgd with and
  without momentum, adam, adagrad, yogi); bound ``rtol=1e-5, atol=1e-6``,
  as the inner optimizer's test: the two differ by float rounding only
  (``decay**count`` and ``rsqrt``);
- FedNova's ``a_i`` at momentum 0 and 0.9, and ``effective_steps``
  (including a client with no real batch, which counts 1 step);
- ``full_batch_grad`` and ``full_batch_grad_sum`` on a tiny ResNet-20
  client with an all-padding batch (whose loss must stay finite: its
  gradient enters the sum weighted by 0) against the JAX package's, and
  the port's eager pass against its :class:`GradProgram` (bitwise);
- every optimizer's ``server_update_async`` (after one ``server_update``,
  so the server state is not at its start) against the JAX optimizer's.

Tolerance elsewhere: the house float32 one, ``rtol=2e-4, atol=2e-5``.
"""

from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.core.algframe import client_trainer as jct
from fedml_tpu.core.algframe import local_training as jlt
from fedml_tpu.core.algframe.types import ClientData as JClientData
from fedml_tpu.model.cv.resnet import CifarResNet as JResNet
from fedml_tpu.model.model_hub import ModelBundle as JBundle
from fedml_tpu.optimizers import create_optimizer as jcreate
from fedml_tpu.optimizers.fedopt import make_server_optimizer as j_make
from fedml_tpu_torch.core.algframe import client_trainer as tct
from fedml_tpu_torch.core.algframe import local_training as tlt
from fedml_tpu_torch.core.algframe.types import ClientData
from fedml_tpu_torch.interop import flax_to_state_dict
from fedml_tpu_torch.model.cv.resnet import CifarResNet as TResNet
from fedml_tpu_torch.model.model_hub import ModelBundle as TBundle
from fedml_tpu_torch.optimizers import create_optimizer as tcreate
from fedml_tpu_torch.optimizers.fedopt import make_server_optimizer as t_make

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 2e-4, 2e-5


def _tree(rs):
    return {"a": rs.randn(5, 3).astype(np.float32),
            "b": rs.randn(7).astype(np.float32)}


def _torch(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


@pytest.mark.parametrize("name,momentum", [
    ("sgd", 0.9), ("sgd", 0.0), ("adam", 0.9), ("adagrad", 0.9),
    ("yogi", 0.9)], ids=["sgd_momentum", "sgd", "adam", "adagrad", "yogi"])
def test_server_optimizer_matches_optax(name, momentum):
    rs = np.random.RandomState(4)
    p = _tree(rs)
    tx = j_make(name, 0.05, momentum)
    st = tx.init(p)
    ours = t_make(name, 0.05, momentum)
    pt = _torch(p)
    ost = ours.init(pt)
    for _ in range(5):
        g = _tree(rs)
        # a few tiny entries, where adam's and yogi's denominators are
        # their eps
        g["b"][:2] *= 1e-6
        u, st = tx.update(g, st, p)
        p = optax.apply_updates(p, u)
        ut, ost = ours.update(_torch(g), ost)
        pt = {k: pt[k] + ut[k] for k in pt}
    for k in p:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(p[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_unknown_server_optimizer_raises():
    with pytest.raises(ValueError, match="server_optimizer"):
        t_make("lamb", 0.1)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_fednova_a_i_matches_jax(momentum):
    args = SimpleNamespace(federated_optimizer="FedNova", momentum=momentum)
    jo, to = jcreate(args, None), tcreate(args, None)
    for tau in (1.0, 2.0, 7.0, 30.0):
        want = float(jo._a_i(jnp.float32(tau)))
        got = to._a_i(np.float32(tau))
        assert isinstance(got, np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-6)
        if momentum == 0.0:
            assert got == tau


@pytest.mark.parametrize("counts,epochs,work_scale", [
    ([4, 4, 1, 0], 1, 1.0), ([4, 4, 1, 0], 3, 1.0), ([4, 0, 0, 0], 2, 0.5),
    ([0, 0, 0, 0], 2, 1.0), ([4, 4, 4, 4], 1, 0.3)])
def test_effective_steps_matches_jax(counts, epochs, work_scale):
    mask = np.zeros((len(counts), 4), np.float32)
    for i, c in enumerate(counts):
        mask[i, :c] = 1.0
    cdata = JClientData(x=jnp.zeros((len(counts), 4, 1)),
                        y=jnp.zeros((len(counts), 4), jnp.int32),
                        mask=jnp.asarray(mask), num_samples=jnp.float32(0))
    want = jlt.effective_steps(cdata, epochs, jnp.float32(work_scale))
    got = tlt.effective_steps(tlt.batch_real_of(mask), epochs, work_scale)
    assert isinstance(got, np.float32) and got >= 1.0
    assert got == np.float32(want)


def _resnet_client():
    rs = np.random.RandomState(3)
    counts = [4, 2, 0, 3]       # batch 2 is all padding
    x = rs.randn(len(counts), 4, 8, 8, 3).astype(np.float32)
    y = rs.randint(0, 10, (len(counts), 4)).astype(np.int32)
    mask = np.zeros((len(counts), 4), np.float32)
    for i, c in enumerate(counts):
        mask[i, :c] = 1.0
    return x * mask[..., None, None, None], y, mask, np.float32(mask.sum())


def test_full_batch_grad_matches_jax():
    x, y, mask, n = _resnet_client()
    jb = JBundle(JResNet(10, 1), "resnet")
    p0 = jax.device_get(jb.init(jax.random.PRNGKey(0), jnp.asarray(x[0])))
    jspec = jct.ClassificationTrainer(jb.apply)
    jdata = JClientData(x=jnp.asarray(x), y=jnp.asarray(y),
                        mask=jnp.asarray(mask), num_samples=jnp.float32(n))
    key = jax.random.PRNGKey(5)
    jsum, jm = jlt.full_batch_grad_sum(jspec, p0, jdata, key)
    jgrad, _ = jlt.full_batch_grad(jspec, p0, jdata, key)

    tb = TBundle(TResNet(10, 1), "resnet")
    spec = tct.ClassificationTrainer(tb.apply)
    params = {k: torch.tensor(v) for k, v in flax_to_state_dict(p0).items()}
    cdata = ClientData(x, y, mask, n).to(torch.device("cpu"))
    # the all-padding batch alone: finite loss, zero gradient
    pad = {"x": cdata.x[2], "y": cdata.y[2], "mask": cdata.mask[2]}
    loss, aux = spec.loss(params, pad)
    assert torch.isfinite(loss) and float(aux["count"]) == 0.0

    tsum, tm = tlt.full_batch_grad_sum(spec, params, cdata, np.zeros(2))
    tgrad, _ = tlt.full_batch_grad(spec, params, cdata, np.zeros(2))
    program = tlt.GradProgram(spec, params, cdata)
    psum, pm = program.run(params, cdata)
    pgrad, _ = tlt.full_batch_grad(spec, params, cdata, None, program)
    for k in ("loss_sum", "correct", "count"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
        assert torch.equal(tm[k], pm[k]), k
    assert float(tm["count"]) == n
    for tree, want in ((tsum, jsum), (tgrad, jgrad)):
        want = flax_to_state_dict(jax.device_get(want))
        for k, v in tree.items():
            assert torch.isfinite(v).all(), k
            np.testing.assert_allclose(v.numpy(), want[k], rtol=RTOL,
                                       atol=ATOL, err_msg=k)
    for k in tsum:
        assert torch.equal(tsum[k], psum[k]), k
        assert torch.equal(tgrad[k], pgrad[k]), k
    assert program.captures == 0 and program.replays == 0


ASYNC = [("FedAvg", {}), ("FedProx", {}),
         ("FedOpt", dict(server_optimizer="sgd")),
         ("FedOpt", dict(server_optimizer="adam", server_lr=0.05)),
         ("FedOpt", dict(server_optimizer="adagrad", server_lr=0.05)),
         ("FedOpt", dict(server_optimizer="yogi", server_lr=0.05)),
         ("FedSGD", dict(server_lr=0.5)), ("FedLocalSGD", {}),
         ("SCAFFOLD", dict(server_lr=0.8)), ("FedNova", {}),
         ("FedDyn", {}), ("Mime", {})]


def _extras(name, rs, like):
    if name == "SCAFFOLD":
        return {"delta_c": _tree(rs)}
    if name == "FedNova":
        return {"a": np.float32(3.5)}
    if name == "Mime":
        return {"full_grad": _tree(rs)}
    return {}


@pytest.mark.parametrize("name,kw", ASYNC, ids=[
    n + ("_" + kw["server_optimizer"] if "server_optimizer" in kw else "")
    for n, kw in ASYNC])
def test_server_update_async_matches_jax(name, kw):
    args = SimpleNamespace(federated_optimizer=name, client_num_in_total=8,
                           client_num_per_round=3, **kw)
    jo, to = jcreate(args, None), tcreate(args, None)
    rs = np.random.RandomState(11)
    p = _tree(rs)
    js, ts = jo.server_init(p), to.server_init(_torch(p))
    jp, tp = p, _torch(p)
    for step in range(2):
        u, ex = _tree(rs), _extras(name, rs, p)
        u = {k: 0.1 * v for k, v in u.items()}
        tex = {k: (torch.tensor(v) if not isinstance(v, dict) else _torch(v))
               for k, v in ex.items()}
        if step == 0:
            jp, js = jo.server_update(jp, js, u, ex, jnp.int32(0))
            tp, ts = to.server_update(tp, ts, _torch(u), tex, 0)
        else:
            jp, js = jo.server_update_async(
                jp, js, u, ex, jnp.int32(1), jnp.float32(0.37),
                jnp.float32(0.25))
            tp, ts = to.server_update_async(
                tp, ts, _torch(u), tex, 1, np.float32(0.37),
                np.float32(0.25))
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    for key in ("c", "h", "m"):
        if key in js:
            for k in p:
                np.testing.assert_allclose(
                    ts[key][k].numpy(), np.asarray(js[key][k]), rtol=RTOL,
                    atol=ATOL, err_msg=f"{key}/{k}")
