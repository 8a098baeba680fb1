"""Contribution assessment in the port (``core/contribution``, the GPU
engine's and the SP loop's use of it) against the JAX package, on the CPU.

* LOO and GTG-Shapley over a synthetic coalition-value function: values
  and the number of coalition evaluations exactly equal to the JAX
  drivers' (the permutation stream, truncation and convergence tests are
  copied);
* the tree API (``leave_one_out`` / ``gtg_shapley`` on stacked updates)
  against the JAX one on the same float32 inputs, exact (accuracy values);
* on a run of the ``lr`` model, whose predictions the two frameworks
  agree on: the engine's and the SP loop's per-round values exactly the
  JAX engine's and SP loop's, with equal evaluation counts, and the
  params at the house tolerance;
* the fused path ≡ the host path, bitwise (values and params), also under
  an attack and a defense (values from the post-attack matrix);
* the host path's 2 GiB guard skips the assessment, loudly.
"""

from __future__ import annotations

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core.contribution import contribution_assessor as jca
from fedml_tpu_torch.core.contribution import contribution_assessor as tca
from fedml_tpu_torch.interop import flax_to_state_dict
from fedml_tpu_torch.simulation.gpu import engine as gpu_engine

from torch_port_support import (LR_BASE, assert_params_close,  # noqa: F401
                                assert_params_equal, jax_init, jax_params,
                                jax_sim, port_sim, single_torch_thread)

pytestmark = pytest.mark.torch_port


def _value_fn(k, seed):
    """A deterministic coalition value, quantized like an accuracy."""
    w = np.random.RandomState(seed).uniform(-0.2, 1.0, k)

    def v(mask):
        m = np.asarray(mask, np.float64)
        return float(np.round(np.tanh(m @ w) * 200) / 200)
    return v


def _counted(fn):
    calls = []

    def v(mask):
        calls.append(1)
        return fn(mask)
    return v, calls


@pytest.mark.parametrize("k,seed", [(3, 0), (5, 1), (8, 2)])
def test_drivers_equal_jax_on_a_synthetic_value(k, seed):
    for ours, theirs, kw in (
            (tca.leave_one_out_values, jca.leave_one_out_values, {}),
            (tca.gtg_shapley_values, jca.gtg_shapley_values,
             dict(max_perms=12, seed=seed))):
        vo, co = _counted(_value_fn(k, seed))
        vt, ct = _counted(_value_fn(k, seed))
        np.testing.assert_array_equal(ours(vo, k, **kw), theirs(vt, k, **kw))
        assert len(co) == len(ct)


def test_tree_api_equals_jax():
    rs = np.random.RandomState(0)
    k, d = 5, 12
    upd = rs.normal(size=(k, d)).astype(np.float32)
    w = rs.uniform(1, 5, k).astype(np.float32)
    p = rs.normal(size=d).astype(np.float32)
    proj = rs.normal(size=(d, 32)).astype(np.float32)

    # an accuracy: a count of hits over 32, exact in float32 both ways
    # (XLA may turn a division by a constant into a multiplication)
    def tev(q):
        return (torch.from_numpy(proj).T @ q["v"] > 0).float().sum() / 32.0

    def jev(q):
        return jnp.sum((jnp.asarray(proj).T @ q["v"] > 0)
                       .astype(jnp.float32)) / 32.0

    tp, tu, tw = ({"v": torch.from_numpy(p)}, {"v": torch.from_numpy(upd)},
                  torch.from_numpy(w))
    jp, ju, jw = {"v": jnp.asarray(p)}, {"v": jnp.asarray(upd)}, \
        jnp.asarray(w)
    np.testing.assert_array_equal(tca.leave_one_out(tp, tu, tw, tev),
                                  jca.leave_one_out(jp, ju, jw, jev))
    np.testing.assert_array_equal(
        tca.gtg_shapley(tp, tu, tw, tev, max_perms=6),
        jca.gtg_shapley(jp, ju, jw, jev, max_perms=6))


def _jax_counted(sim):
    """Count the JAX manager's coalition evaluations."""
    mgr, calls = sim.contribution, []
    inner = mgr.assess_values

    def assess_values(value_of_mask, k, **kw):
        def v(mask):
            calls.append(1)
            return value_of_mask(mask)
        return inner(v, k, **kw)

    mgr.assess_values = assess_values
    return calls


@pytest.mark.parametrize("backend", ["gpu", "sp"])
@pytest.mark.parametrize("method", ["loo", "gtg"])
def test_run_values_equal_jax(method, backend):
    cfg = dict(LR_BASE, contribution_method=method, shapley_max_perms=6)
    p0 = flax_to_state_dict(jax_init(cfg))
    js = jax_sim(cfg, backend="tpu" if backend == "gpu" else "sp")
    calls = _jax_counted(js)
    ts = port_sim(cfg, backend=backend, init_params=p0)
    rj, rt = js.run(), ts.run()
    assert_params_close(rt["params"], jax_params(rj["params"]))
    hj, ht = js.contribution.history, ts.contribution.history
    assert [h["round"] for h in ht] == [0, 1, 2]
    for a, b in zip(ht, hj):
        assert a["client_ids"] == [int(c) for c in b["client_ids"]]
        assert a["contributions"] == b["contributions"]
    assert ts.contribution.evaluations == len(calls)
    if method == "loo":
        assert len(calls) == 3 * (4 + 1)


ATTACKED = dict(enable_attack=True, attack_type="byzantine_flip",
                byzantine_client_num=1, attack_scale=2.0,
                enable_defense=True, defense_type="multi_krum",
                krum_param_m=2)


@pytest.mark.parametrize("extra", [{}, ATTACKED], ids=["plain", "attacked"])
@pytest.mark.parametrize("method", ["loo", "gtg"])
def test_fused_equals_host(method, extra):
    cfg = dict(LR_BASE, contribution_method=method, **extra)
    fused, host = port_sim(cfg), port_sim(dict(cfg, robust_fused="host"))
    assert fused.robust_fused and not host.robust_fused
    rf, rh = fused.run(), host.run()
    assert_params_equal(rf["params"], rh["params"])
    assert fused.contribution.history == host.contribution.history
    assert fused.contribution.evaluations == host.contribution.evaluations
    if extra:
        # the values come from the post-attack matrix: round 0's equal the
        # SP loop's, which attacks on the host before it assesses
        sp = port_sim(cfg, backend="sp")
        sp.run()
        assert sp.contribution.history[0] == fused.contribution.history[0]


def test_host_guard_skips_assessment(monkeypatch, caplog):
    monkeypatch.setattr(gpu_engine, "CONTRIBUTION_HOST_GUARD_BYTES", 1024)
    cfg = dict(LR_BASE, contribution_method="loo", comm_round=1)
    host = port_sim(dict(cfg, robust_fused="host"))
    with caplog.at_level(logging.ERROR):
        host.run()
    assert host.contribution.history == []
    assert "2 GiB host guard" in caplog.text
    fused = port_sim(cfg)       # the fused path has no host guard
    fused.run()
    assert len(fused.contribution.history) == 1
