"""The FSDP + tensor-parallel LLM step (``llm/sharding.py``) against the JAX
package's ``make_sharded_train_step`` on the same mesh, on the CPU: the
port's ranks are gloo processes (``core/launch.py::run_ranks``), the JAX
step runs over as many of the 8 virtual CPU devices.

One SGD step (lr 0.1) of the 2-layer causal LM of ``tests/test_llm.py``'s
``test_fsdp_tp_sharded_step`` on a batch of 8: the loss within atol 1e-5
and every updated parameter within atol 1e-4 of JAX's (that test's
bounds), and each rank's local shard shape equal to the JAX array's
addressable shard shape, at ``{"data": 2, "fsdp": 2, "tensor": 2}`` (8
ranks) and ``{"tensor": 2}`` with the untied head, and at ``{"fsdp": 2,
"tensor": 2}`` with the tied one (the vocabulary-parallel embedding and
head).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from flax import traverse_util

from fedml_tpu.core.mesh import build_mesh as jbuild_mesh
from fedml_tpu.llm import CausalLMTrainer as JTrainer
from fedml_tpu.llm import model as jmodel
from fedml_tpu.llm.sharding import (llm_param_specs as jspecs,
                                    make_sharded_train_step as jstep,
                                    shard_llm_params as jshard)
from fedml_tpu_torch.core.launch import run_ranks
from fedml_tpu_torch.interop import flax_to_state_dict

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

HERE = os.path.dirname(os.path.abspath(__file__))
LR = 0.1
MESHES = {
    "data2_fsdp2_tensor2_untied": ({"data": 2, "fsdp": 2, "tensor": 2},
                                   False),
    "tensor2_untied": ({"tensor": 2}, False),
    "fsdp2_tensor2_tied": ({"fsdp": 2, "tensor": 2}, True),
}


def _cfg(tied):
    return dict(vocab_size=64, hidden_size=32, intermediate_size=64,
                num_layers=2, num_heads=4, max_seq_len=16,
                tie_embeddings=tied)


def _jax_step(shape, tied, batch):
    model, params = jmodel.init_llm(jmodel.LLMConfig(**_cfg(tied)),
                                    jax.random.PRNGKey(0))
    spec = JTrainer(lambda p, x, rng=None, train=False:
                    model.apply({"params": p}, x))
    n = int(np.prod(list(shape.values())))
    mesh = jbuild_mesh(shape, devices=jax.devices()[:n])
    specs = jspecs(params, mesh)
    opt = optax.sgd(LR)
    with mesh:
        sharded = jshard(params, mesh)
        step = jstep(lambda p, b, r: spec.loss(p, b, r), opt, mesh, specs)
        new, _, loss = step(sharded, opt.init(sharded),
                            {k: jnp.asarray(v) for k, v in batch.items()},
                            jax.random.PRNGKey(0))
    shards = traverse_util.flatten_dict(jax.tree_util.tree_map(
        lambda a: tuple(a.addressable_shards[0].data.shape), new), sep=".")
    return (jax.device_get(params), float(loss),
            flax_to_state_dict(jax.device_get(new)), shards)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_sharded_step_matches_jax(name):
    shape, tied = MESHES[name]
    x = np.random.RandomState(3).randint(4, 64, (8, 16)).astype(np.int32)
    batch = {"x": x, "y": x, "mask": np.ones(8, np.float32)}
    params, loss, want, shards = _jax_step(shape, tied, batch)
    n = int(np.prod(list(shape.values())))
    out = run_ranks("torch_rank_programs:sharded_step", n,
                    dict(cfg_kw=_cfg(tied), params=flax_to_state_dict(params),
                         batch=batch, mesh_shape=shape, lr=LR),
                    timeout=240.0, sys_path=[HERE])
    start = flax_to_state_dict(params)
    for r, (t_loss, t_params, t_shapes) in enumerate(out):
        np.testing.assert_allclose(t_loss, loss, atol=1e-5)
        assert set(t_params) == set(want)
        for k in want:
            np.testing.assert_allclose(t_params[k], want[k], atol=1e-4,
                                       err_msg=f"rank {r} {k}")
        # the local shard of every rank is the JAX array's
        assert {k: tuple(v) for k, v in t_shapes.items()} == shards, r
    moved = max(float(np.abs(want[k] - start[k]).max()) for k in want)
    assert moved > 1e-4
