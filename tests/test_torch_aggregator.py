"""The user ``ServerAggregator`` and the one-card quantized relayout in the
port's GPU engine, against the JAX package, on the CPU.

* a user aggregator (coordinate-wise median, with a weight hook before and
  a scale hook after) in the port against the same aggregator in the JAX
  runner, from the same flax parameters, at the house tolerance
  ``rtol=2e-4, atol=2e-5``; its hook chain runs on the ``[K, D]`` matrix;
* a defense takes precedence over the aggregator, with the JAX engine's
  warning: the run equals the defense-only run bitwise;
* ``server_aggregator`` refused on the SP backend;
* ``robust_relayout_quant``: the row rounding equals the JAX engine's
  formula bitwise on the same matrices (int8 per-row scales, ties to even,
  zero rows; bf16); in the int8 and bf16 runs under multi_krum the
  defense's input is the JAX rounding of the port's rows bitwise in every
  round, and in round 0 the ``TPUSimulator`` defense's input (its feature
  shards joined) up to float32 rounding (int8 codes equal, scales within
  4 ulp; bf16 at most 0.1% of entries apart, by one level or, on a tiny
  entry, by ``1e-8``); the runs agree at
  ``rtol=2e-4`` and an absolute tolerance of about one quantum (int8:
  ``atol=1e-3``, these updates' largest row entry / 127 is ~9e-4; bf16:
  ``atol=5e-4``): the two frameworks' updates differ by float32 rounding,
  and an entry that lands that close to a rounding boundary rounds to the
  neighbouring level in one of them, a whole quantum times its weight in
  the aggregate; and the port's run is 10x nearer the JAX quantized run
  than the dense run is;
* the knob refused for an unknown mode and kept off, with a warning, on
  the host path.
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core.algframe.server_aggregator import \
    ServerAggregator as JServerAggregator
import fedml_tpu_torch
from fedml_tpu_torch.core.algframe.server_aggregator import ServerAggregator
from fedml_tpu_torch.core.security.defense import robust_agg
from fedml_tpu_torch.interop import flax_to_state_dict
from fedml_tpu_torch.simulation.gpu.engine import quantize_rows

from torch_port_support import (LR_BASE, assert_params_close,  # noqa: F401
                                assert_params_equal, jax_init, jax_params,
                                jax_sim, port_sim, single_torch_thread)

pytestmark = pytest.mark.torch_port


class MedianAggregator(ServerAggregator):
    """Coordinate median of the rows whose weight passes a floor, scaled
    by 0.9 afterwards; records what each hook saw."""

    def __init__(self):
        self.seen = []

    def on_before_aggregation(self, update_matrix, weights):
        self.seen.append(tuple(update_matrix.shape))
        return update_matrix, torch.clamp(weights, min=1.0)

    def aggregate(self, update_matrix, weights):
        return robust_agg.median0(update_matrix)

    def on_after_aggregation(self, agg_vec):
        return agg_vec * 0.9


class JMedianAggregator(JServerAggregator):
    def on_before_aggregation(self, update_matrix, weights):
        return update_matrix, jnp.maximum(weights, 1.0)

    def aggregate(self, update_matrix, weights):
        return jnp.median(update_matrix, axis=0)

    def on_after_aggregation(self, agg_vec):
        return agg_vec * 0.9


@pytest.mark.parametrize("extra", [{}, dict(enable_attack=True,
                                            attack_type="byzantine_flip",
                                            byzantine_client_num=1,
                                            attack_scale=2.0)],
                         ids=["plain", "attacked"])
def test_user_aggregator_matches_jax_runner(extra):
    cfg = dict(LR_BASE, **extra)
    p0 = flax_to_state_dict(jax_init(cfg))
    agg = MedianAggregator()
    ts = port_sim(cfg, init_params=p0, server_aggregator=agg)
    assert ts.robust_mode and not ts.robust_fused
    rt = ts.run()
    rj = jax_sim(cfg, server_aggregator=JMedianAggregator()).run()
    assert_params_close(rt["params"], jax_params(rj["params"]))
    d = sum(v.numel() for v in rt["params"].values())
    assert agg.seen == [(4, d)] * 3


def test_run_simulation_takes_the_aggregator():
    agg = MedianAggregator()
    r = fedml_tpu_torch.run_simulation(device="cpu", server_aggregator=agg,
                                       **dict(LR_BASE, comm_round=1))
    assert np.isfinite(r["history"][0]["train_loss"]) and len(agg.seen) == 1


def test_defense_takes_precedence(caplog):
    cfg = dict(LR_BASE, enable_defense=True,
               defense_type="coordinate_median")
    agg = MedianAggregator()
    with caplog.at_level(logging.WARNING):
        both = port_sim(cfg, server_aggregator=agg)
    assert "the defense takes precedence" in caplog.text
    # the aggregator puts the defense on the host kernels, as in JAX
    assert not both.robust_fused and not both._sharded
    rb = both.run()
    rd = port_sim(dict(cfg, robust_fused="host",
                       sharded_defense=False)).run()
    assert agg.seen == []
    assert_params_equal(rb["params"], rd["params"])


def test_sp_backend_refuses_the_aggregator():
    with pytest.raises(NotImplementedError, match="server_aggregator"):
        port_sim(LR_BASE, backend="sp", server_aggregator=MedianAggregator())


def _jax_quantize(mat, mode):
    """The JAX engine's relayout rounding (``engine.py`` ``relayout``) of
    whole rows, before the ``all_to_all`` moves them."""
    m = jnp.asarray(mat)
    if mode == "bf16":
        return np.asarray(m.astype(jnp.bfloat16).astype(jnp.float32))
    amax = jnp.max(jnp.abs(m), axis=1, keepdims=True)
    scale = jnp.where(amax > 0, amax, 1.0) / 127.0
    q = jnp.round(m / scale).astype(jnp.int8)
    return np.asarray(q.astype(jnp.float32) * scale[:, 0][:, None])


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_row_rounding_equals_jax_formula(mode):
    rs = np.random.RandomState(0)
    mat = (rs.normal(size=(6, 257)) * rs.uniform(1e-3, 3, (6, 1))
           ).astype(np.float32)
    mat[2] = 0.0                        # a zero row keeps scale 1 / 127
    mat[3, :4] = [127.0, -63.5, 0.5, 1.5]   # exact ties at scale 1
    got = quantize_rows(torch.from_numpy(mat), mode).numpy()
    np.testing.assert_array_equal(got, _jax_quantize(mat, mode))
    if mode == "int8":
        assert all(len(np.unique(r)) <= 255 for r in got)
        np.testing.assert_array_equal(got[3, :4], [127.0, -64.0, 0.0, 2.0])
    t = torch.from_numpy(mat)
    assert quantize_rows(t, None) is t


QUANT_TOL = {"int8": dict(rtol=2e-4, atol=1e-3),
             "bf16": dict(rtol=2e-4, atol=5e-4)}


def _record_defense_inputs(monkeypatch):
    """Record the ``[K, D]`` matrix each engine's defense sees, per round:
    the port's as it enters ``defend_shard_stateful`` (with the raw rows
    ``quantize_rows`` took); the JAX engine's feature shards through a
    debug callback inside its fused program, as ``(device, shard)``
    (:func:`_jax_rounds` joins them)."""
    import fedml_tpu.core.security.defense.sharded as jsharded
    import fedml_tpu_torch.core.security.defense.sharded as tsharded
    import fedml_tpu_torch.simulation.gpu.engine as tengine

    rec = {"raw": [], "port": [], "jax": []}

    def port_quantize(mat, mode):
        rec["raw"].append(mat.clone().numpy())
        return quantize_rows(mat, mode)

    def port_defend(mat, *a, _f=tsharded.defend_shard_stateful, **kw):
        rec["port"].append(mat.clone().numpy())
        return _f(mat, *a, **kw)

    def jax_defend(mat_s, w, axis, *a, _f=jsharded.defend_shard_stateful,
                   **kw):
        jax.debug.callback(
            lambda i, m: rec["jax"].append((int(i), np.asarray(m))),
            jax.lax.axis_index(axis), mat_s)
        return _f(mat_s, w, axis, *a, **kw)

    monkeypatch.setattr(tengine, "quantize_rows", port_quantize)
    monkeypatch.setattr(tsharded, "defend_shard_stateful", port_defend)
    monkeypatch.setattr(jsharded, "defend_shard_stateful", jax_defend)
    return rec


def _jax_rounds(shards, n_dev, d):
    """The JAX engine's recorded ``(device, [K, D/n])`` shards -> one
    ``[K, d]`` matrix per round, shards in device order, padding cut."""
    assert len(shards) % n_dev == 0
    out = []
    for r in range(0, len(shards), n_dev):
        part = sorted(shards[r:r + n_dev], key=lambda s: s[0])
        assert [i for i, _ in part] == list(range(n_dev))
        out.append(np.concatenate([m for _, m in part], axis=1)[:, :d])
    return out


def _levels(mat, mode):
    """Each entry's level: the int8 code under its row's scale, or the
    bfloat16 bit pattern; and the int8 per-row scales (None for bf16)."""
    if mode == "bf16":
        return mat.view(np.int32) >> 16, None
    scale = np.abs(mat).max(axis=1) / np.float32(127.0)
    scale = np.where(scale > 0, scale, np.float32(1 / 127.0))
    return np.rint(mat / scale[:, None]).astype(np.int64), scale


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_relayout_run_matches_jax_engine(mode, monkeypatch):
    """The defense's input, round by round: the port's is the JAX rounding
    of its own rows bitwise, and in round 0 (same start parameters) the
    JAX engine's up to float32 rounding: int8 codes equal, per-row scales
    within 4 ulp; bf16 at most 0.1% of entries apart, each by one level
    (``rtol=2**-7``) or, on an entry under 1e-5 of its row's largest where
    float32 rounding of the update spans several levels, by ``1e-8``.
    Later rounds start from parameters that differ by float32 rounding,
    so only the run is held: at ``QUANT_TOL`` (a level flip moves the
    aggregate by a quantum times its weight), and, in the mean over each
    leaf, 10x nearer the JAX quantized run than the dense run is."""
    cfg = dict(LR_BASE, enable_defense=True, defense_type="multi_krum",
               krum_param_m=2, robust_relayout_quant=mode)
    p0 = flax_to_state_dict(jax_init(cfg))
    rec = _record_defense_inputs(monkeypatch)
    ts = port_sim(cfg, init_params=p0)
    assert ts.robust_fused and ts._relayout_quant == mode
    rt = ts.run()
    rj = jax_sim(cfg).run()
    jmats = _jax_rounds(rec["jax"], jax.device_count(), ts.layout.size)
    assert len(rec["raw"]) == len(rec["port"]) == len(jmats) == \
        cfg["comm_round"]
    for raw, got in zip(rec["raw"], rec["port"]):
        np.testing.assert_array_equal(got, _jax_quantize(raw, mode))
        assert not np.array_equal(got, raw)
    (lt, st), (lj, sj) = (_levels(m[0], mode) for m in (rec["port"], jmats))
    if mode == "int8":
        np.testing.assert_array_equal(lt, lj)
        np.testing.assert_array_max_ulp(st, sj, maxulp=4)
    else:
        assert np.count_nonzero(lt != lj) <= lt.size // 1000
        np.testing.assert_allclose(rec["port"][0], jmats[0], rtol=2**-7,
                                   atol=1e-8)
    jp = jax_params(rj["params"])
    assert_params_close(rt["params"], jp, **QUANT_TOL[mode])
    dense = port_sim(dict(cfg, robust_relayout_quant=None),
                     init_params=p0).run()
    for k, want in jp.items():  # the mean: a flip moves a few entries
        want = torch.tensor(want)
        assert (rt["params"][k] - want).abs().mean() * 10 <= \
            (dense["params"][k] - want).abs().mean()


def test_relayout_knob_refusals(caplog):
    with pytest.raises(ValueError, match="none|int8|bf16"):
        port_sim(dict(LR_BASE, enable_defense=True, defense_type="krum",
                      robust_relayout_quant="fp4"))
    with caplog.at_level(logging.WARNING):
        host = port_sim(dict(LR_BASE, enable_defense=True,
                             defense_type="krum", robust_fused="host",
                             robust_relayout_quant="int8"))
    assert host._relayout_quant is None
    assert "the dense f32 matrix is kept" in caplog.text
