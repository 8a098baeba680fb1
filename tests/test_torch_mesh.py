"""The port's rank mesh (``core/mesh.py``) and LLM parameter specs
(``llm/sharding.py::llm_param_specs``) against the JAX package's
``core/mesh.py`` and ``llm/sharding.py`` on the virtual CPU devices.

* ``mesh_shape`` over n ranks: the axis names, the sizes, the ``-1`` rule
  and the errors (JAX's wording) of JAX's ``build_mesh`` over n devices;
  ``build_mesh`` over 4 gloo rank processes lays the ranks out row-major,
  as JAX lays out its devices;
* ``llm_param_specs`` leaf for leaf equal to JAX's ``PartitionSpec``s,
  for the tied and the untied causal LM, with LoRA adapters, at
  ``{"fsdp": 2, "tensor": 2}`` and ``{"tensor": 2}``;
* ``fsdp_param_sharding``'s choice of dimension, and the replicated /
  client / data placements, against JAX's specs.
"""

from __future__ import annotations

import os
import types

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util
from torch.distributed.tensor import Replicate, Shard

from fedml_tpu.core import mesh as jmesh
from fedml_tpu.llm import lora as jlora
from fedml_tpu.llm import model as jmodel
from fedml_tpu.llm.sharding import llm_param_specs as jspecs
from fedml_tpu_torch.core import mesh as tmesh
from fedml_tpu_torch.core.launch import run_ranks
from fedml_tpu_torch.llm.sharding import llm_param_specs as tspecs

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

HERE = os.path.dirname(os.path.abspath(__file__))

SHAPES = [None, {"client": 4}, {"client": -1}, {"client": 2, "fsdp": -1},
          {"data": 2, "fsdp": 2, "tensor": 2}, {"fsdp": -1, "tensor": 2},
          {"client": -1, "fsdp": -1}, {"client": 3}, {"sp": 16}]


def _jax(shape, n):
    try:
        m = jmesh.build_mesh(shape, devices=jax.devices()[:n])
    except ValueError as e:
        return ("ValueError", str(e))
    return list(m.axis_names), [m.shape[a] for a in m.axis_names]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_mesh_axes_follow_jax_build_mesh(shape, n):
    want = _jax(shape, n)
    try:
        got = tmesh.mesh_axes(shape, n)
    except ValueError as e:
        got = ("ValueError", str(e))
    assert tuple(got) == tuple(want)


def test_build_mesh_over_ranks():
    shapes = [None, {"data": 2, "fsdp": -1}, {"fsdp": 2, "tensor": 2},
              {"client": 3}, (2, 2)]
    out = run_ranks("torch_rank_programs:mesh_layouts", 4, {"shapes": shapes},
                    timeout=120.0, sys_path=[HERE])
    for r, got in enumerate(out):
        assert got[0] == (["client"], [4], [0, 1, 2, 3]), r
        assert got[1] == (["data", "fsdp"], [2, 2], [[0, 1], [2, 3]]), r
        assert got[2] == (["fsdp", "tensor"], [2, 2], [[0, 1], [2, 3]]), r
        assert got[3] == ("ValueError", "mesh shape {'client': 3} != 4 "
                          "devices"), r
        assert got[4][0] == "TypeError", r


def _tree(tied, lora):
    cfg = jmodel.LLMConfig(vocab_size=64, hidden_size=32,
                           intermediate_size=64, num_layers=2, num_heads=4,
                           num_kv_heads=2, max_seq_len=16,
                           tie_embeddings=tied)
    _, params = jmodel.init_llm(cfg, jax.random.PRNGKey(0))
    flat = traverse_util.flatten_dict(jax.device_get(params))
    if lora:
        ad = jlora.lora_init(jax.random.PRNGKey(2), params, rank=4)
        flat.update(traverse_util.flatten_dict(jax.device_get(ad)))
    return traverse_util.unflatten_dict(flat)


def _norm(spec, ndim):
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


@pytest.mark.parametrize("shape", [{"fsdp": 2, "tensor": 2}, {"tensor": 2}],
                         ids=str)
@pytest.mark.parametrize("lora", [False, True], ids=["base", "lora"])
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_llm_param_specs_match_jax(tied, lora, shape):
    tree = _tree(tied, lora)
    n = int(np.prod(list(shape.values())))
    want = traverse_util.flatten_dict(
        jspecs(tree, jmesh.build_mesh(shape, devices=jax.devices()[:n])),
        sep=".")
    flat = traverse_util.flatten_dict(tree, sep=".")
    got = tspecs({k: torch.zeros(v.shape) for k, v in flat.items()},
                 _fake_mesh(shape))
    assert set(got) == set(want)
    assert any(k.endswith("lora_a") for k in got) == lora
    for k, spec in want.items():
        assert got[k] == _norm(spec, np.ndim(flat[k])), k


def _fake_mesh(sizes):
    return types.SimpleNamespace(mesh_dim_names=tuple(sizes),
                                 mesh=np.zeros(tuple(sizes.values())))


def _as_spec(placements, names, ndim):
    spec = [None] * ndim
    for name, p in zip(names, placements):
        if isinstance(p, Shard):
            spec[p.dim] = name
        else:
            assert isinstance(p, Replicate)
    return tuple(spec)


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("shape", [(8, 6), (6, 8), (3, 5), (4, 4), (5, 12, 2),
                                   (7,), (2, 3, 4)], ids=str)
def test_fsdp_param_sharding_picks_jax_dim(shape, size):
    sizes = {"data": 1, "fsdp": size}
    jm = jmesh.build_mesh(sizes, devices=jax.devices()[:size])
    want = _norm(jmesh.fsdp_param_sharding(jm, shape).spec, len(shape))
    got = tmesh.fsdp_param_sharding(_fake_mesh(sizes), shape)
    assert _as_spec(got, tuple(sizes), len(shape)) == want


def test_placements_match_jax_specs():
    sizes = {"client": 2, "data": 2}
    jm = jmesh.build_mesh(sizes, devices=jax.devices()[:4])
    tm = _fake_mesh(sizes)
    for jfn, tfn, ndim in ((lambda m: jmesh.replicated(m), tmesh.replicated,
                            2),
                           (lambda m: jmesh.client_sharded(m, 3),
                            lambda m: tmesh.client_sharded(m, 3), 3),
                           (lambda m: jmesh.data_sharded(m, 2),
                            lambda m: tmesh.data_sharded(m, 2), 2)):
        assert _as_spec(tfn(tm), tuple(sizes), ndim) == \
            _norm(jfn(jm).spec, ndim)
    assert tmesh.client_axis_size(tm) == jmesh.client_axis_size(jm) == 2
    assert tmesh.logical_sharding_rules() == jmesh.logical_sharding_rules()
