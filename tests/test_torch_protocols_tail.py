"""The port's FedGKT, FedNAS, FedSeg, FedGAN and TurboAggregate
simulators against the JAX package's.

Each JAX simulator is built on the same seeded data (both loaders give
the same arrays), its initial parameters are carried into the port's
(``init_params``, through ``fedml_tpu_torch.interop``), and both run 2
rounds on the CPU. The histories and the final parameters agree within
the house tolerance (rtol 2e-4, atol 2e-5); accuracies and FedNAS's
derived architecture exactly. TurboAggregate's ring output is bit-equal to
the JAX package's on the same updates. The runner dispatches every name
(and a segmentation dataset, and the ``gan`` bundle pair) on either
backend, and refuses the engine's chaos knobs on these loops.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from fedml_tpu import data as jdata
from fedml_tpu.arguments import Arguments as JArgs
from fedml_tpu_torch import data as tdata
from fedml_tpu_torch import model as tmodel
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.interop import flax_to_state_dict

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 2e-4, 2e-5
BASE = dict(dataset="synthetic_mnist", model="lr", client_num_in_total=4,
            client_num_per_round=4, comm_round=2, epochs=1, batch_size=32,
            learning_rate=0.1, frequency_of_the_test=1, random_seed=17,
            max_total_samples=320, enable_tracking=False)
CFGS = {
    "FedGKT": dict(BASE, federated_optimizer="FedGKT"),
    "FedNAS": dict(BASE, federated_optimizer="FedNAS", learning_rate=0.05),
    "FedSeg": dict(BASE, federated_optimizer="FedSeg",
                   dataset="synthetic_seg", batch_size=16,
                   learning_rate=0.2, client_num_per_round=3),
    "FedGAN": dict(BASE, federated_optimizer="FedGAN", model="gan",
                   learning_rate=2e-4),
    "turbo_aggregate": dict(BASE, federated_optimizer="turbo_aggregate",
                            client_num_in_total=6, client_num_per_round=5,
                            turbo_groups=2),
}


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(port, ref, what, atol=ATOL):
    port = {k: _np(v) for k, v in port.items()}
    assert sorted(port) == sorted(ref), what
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], rtol=RTOL, atol=atol,
                                   err_msg=f"{what}: {k}")


def _history(port, ref, exact=("test_acc", "architecture", "round")):
    assert len(port) == len(ref)
    for hp, hr in zip(port, ref):
        assert sorted(hp) == sorted(hr)
        for k in hr:
            if k in exact:
                assert hp[k] == hr[k], (k, hp[k], hr[k])
            else:
                np.testing.assert_allclose(hp[k], hr[k], rtol=RTOL,
                                           atol=ATOL, err_msg=k)


def _loaders(cfg):
    jargs, args = JArgs(**cfg), Arguments(**cfg)
    jfed, jod = jdata.load(jargs)
    fed, od = tdata.load(args)
    np.testing.assert_array_equal(np.asarray(jfed.train.x), fed.train.x)
    return jargs, jfed, jod, args, fed, od


def _port(args, fed, od, init, backend="sp"):
    from fedml_tpu_torch.runner import FedMLRunner
    args.backend = backend
    runner = FedMLRunner(args, device="cpu", dataset=fed,
                         model=tmodel.create(args, od, fed.input_shape),
                         init_params=init)
    return runner.runner, runner.run()


def _sd(tree):
    return flax_to_state_dict(jax.device_get(tree))


def test_fedgkt_matches_jax():
    from fedml_tpu.simulation.sp.fedgkt import FedGKTSimulator as J
    from fedml_tpu_torch.simulation.sp.fedgkt import FedGKTSimulator
    jargs, jfed, _, args, fed, od = _loaders(CFGS["FedGKT"])
    jsim = J(jargs, jfed)
    init = {"edge": [_sd(p) for p in jsim.edge_params],
            "head": _sd(jsim.head_params)}
    ref = jsim.run()
    sim, got = _port(args, fed, od, init)
    assert isinstance(sim, FedGKTSimulator)
    _history(got["history"], ref["history"])
    _close(got["params"], _sd(ref["params"]), "head")
    for c, (pe, je) in enumerate(zip(got["edge_params"],
                                     ref["edge_params"])):
        _close(pe, _sd(je), f"edge {c}")


def test_fednas_matches_jax():
    from fedml_tpu.simulation.sp.fednas import FedNASSimulator as J
    from fedml_tpu_torch.simulation.sp.fednas import FedNASSimulator
    jargs, jfed, _, args, fed, od = _loaders(CFGS["FedNAS"])
    jsim = J(jargs, jfed)
    init = {"params": _sd(jsim.params), "alphas": np.asarray(jsim.alphas)}
    assert all(".op_" not in k or k.endswith((".kernel", ".bias"))
               for k in init["params"])
    ref = jsim.run()
    sim, got = _port(args, fed, od, init)
    assert isinstance(sim, FedNASSimulator)
    _history(got["history"], ref["history"])
    _close(got["params"], _sd(ref["params"]), "weights")
    _close({"a": got["alphas"]}, {"a": np.asarray(ref["alphas"])}, "alphas")
    assert got["architecture"] == ref["architecture"]


def test_fedseg_matches_jax():
    """synthetic_seg (16x16x3, 3 classes) through the loader's
    segmentation branch: the runner picks FedSeg from the task alone."""
    from fedml_tpu.simulation.sp.fedseg import FedSegSimulator as J
    from fedml_tpu_torch.simulation.sp.fedseg import FedSegSimulator
    cfg = dict(CFGS["FedSeg"], federated_optimizer="FedAvg")
    jargs, jfed, _, args, fed, od = _loaders(cfg)
    assert fed.task == jfed.task == "segmentation"
    np.testing.assert_array_equal(np.asarray(jfed.train.y), fed.train.y)
    jsim = J(jargs, jfed)
    init = _sd(jsim.params)
    ref = jsim.run()
    sim, got = _port(args, fed, od, init)
    assert isinstance(sim, FedSegSimulator)
    _history(got["history"], ref["history"], exact=("round",))
    _close(got["params"], _sd(ref["params"]), "segnet")


def test_fedgan_matches_jax():
    """The latent draws are jax.random's bit for bit, so both runs train
    on the same fakes; the runner picks FedGAN from the bundle pair. The
    parameters are held to the house tolerance plus two learning rates:
    Adam divides each gradient by its own running size, so an entry whose
    gradient is at the level of float rounding (a unit off for most of the
    batch) takes a step of up to ``lr`` one way in one framework and the
    other way in the other, ``2 lr`` apart."""
    from fedml_tpu.model import create as jcreate
    from fedml_tpu.simulation.sp.fedgan import FedGANSimulator as J
    from fedml_tpu_torch.simulation.sp.fedgan import FedGANSimulator
    cfg = dict(CFGS["FedGAN"], federated_optimizer="FedAvg")
    jargs, jfed, jod, args, fed, od = _loaders(cfg)
    jsim = J(jargs, jfed, jcreate(jargs, jod))
    init = {"gen": _sd(jsim.gen_params), "disc": _sd(jsim.disc_params)}
    ref = jsim.run()
    sim, got = _port(args, fed, od, init)
    assert isinstance(sim, FedGANSimulator)
    _history(got["history"], ref["history"], exact=("round", "disc_acc"))
    atol = ATOL + 2 * cfg["learning_rate"]
    _close(got["gen_params"], _sd(ref["gen_params"]), "generator", atol)
    _close(got["disc_params"], _sd(ref["disc_params"]), "discriminator",
           atol)


def test_gan_latents_equal_jax_bitwise():
    from fedml_tpu_torch import prng
    key = jax.random.fold_in(jax.random.PRNGKey(3), 5)
    rng, kz1, kz2 = jax.random.split(key, 3)
    for k in (kz1, kz2):
        want = np.asarray(jax.random.normal(k, (32, 100)))
        got = prng.normal_t(np.asarray(k), (32, 100), "cpu").numpy()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        prng.split(np.asarray(key), 3)[0], np.asarray(rng))


@pytest.mark.parametrize("groups", [1, 2, 3])
def test_turbo_ring_output_bitwise(groups):
    """The group ring over the same float64 updates: the dequantized
    aggregate equals the JAX package's bit for bit, and FedAvg's weighted
    mean to one 2^-16 quantum per client."""
    from fedml_tpu.simulation.sp import turbo_aggregate as J
    from fedml_tpu_torch.simulation.sp.turbo_aggregate import ring_aggregate
    rs = np.random.RandomState(groups)
    n, d = 5, 1000
    updates = [rs.randn(d).astype(np.float32).astype(np.float64) * 0.01
               for _ in range(n)]
    weights = [float(w) for w in rs.randint(10, 100, n)]
    jsim = J.TurboAggregateSimulator.__new__(J.TurboAggregateSimulator)
    jsim.groups, jsim.scale = groups, 2.0 ** 16
    want = jsim._ring_aggregate(updates, weights, 3)
    got = ring_aggregate(updates, weights, 3, groups, 2.0 ** 16)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    mean = sum(u * w for u, w in zip(updates, weights)) / sum(weights)
    assert np.max(np.abs(got - mean)) <= n * 2.0 ** -16


def test_turbo_aggregate_matches_jax():
    from fedml_tpu.core.algframe.client_trainer import make_trainer_spec
    from fedml_tpu.model import create as jcreate
    from fedml_tpu.optimizers.registry import create_optimizer
    from fedml_tpu.simulation.sp.turbo_aggregate import \
        TurboAggregateSimulator as J
    from fedml_tpu_torch.simulation.sp.turbo_aggregate import \
        TurboAggregateSimulator
    jargs, jfed, jod, args, fed, od = _loaders(CFGS["turbo_aggregate"])
    bundle = jcreate(jargs, jod)
    spec = make_trainer_spec(jfed, bundle)
    inner = JArgs(**dict(CFGS["turbo_aggregate"],
                         federated_optimizer="FedAvg"))
    jsim = J(jargs, jfed, bundle, create_optimizer(inner, spec), spec)
    init = _sd(jsim.params)
    ref = jsim.run()
    sim, got = _port(args, fed, od, init, backend="gpu")
    assert isinstance(sim, TurboAggregateSimulator)
    _history(got["history"], ref["history"])
    _close(got["params"], _sd(ref["params"]), "turbo")


@pytest.mark.parametrize("fo", ["FedGKT", "FedNAS", "FedSeg", "FedGAN",
                                "turbo_aggregate", "turboaggregate",
                                "centralized"])
def test_protocols_refuse_engine_chaos(fo):
    from fedml_tpu_torch.runner import check_ported
    with pytest.raises(NotImplementedError, match="chaos_dropout_prob"):
        check_ported(Arguments(federated_optimizer=fo,
                               chaos_dropout_prob=0.2))


@pytest.mark.parametrize("fo", ["FedGKT", "FedNAS", "FedSeg", "FedGAN",
                                "turbo_aggregate", "centralized"])
def test_run_simulation_runs_each_protocol(fo):
    """``fedml_tpu_torch.run_simulation`` on both backends: one round at a
    tiny size, finite results."""
    import fedml_tpu_torch as fedml
    cfg = dict(CFGS.get(fo, BASE), federated_optimizer=fo, comm_round=1,
               max_total_samples=128)
    for backend in ("gpu", "sp"):
        r = fedml.run_simulation(backend=backend, device="cpu", **cfg)
        assert r["rounds"] == 1 and np.isfinite(r["final_test_acc"])
