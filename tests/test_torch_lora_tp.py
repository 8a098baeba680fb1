"""LoRA adapters in the FSDP + tensor-parallel LLM step (``llm/model.py``'s
side path under ``llm/sharding.py::tensor_parallel``) against the JAX
package's unsharded LoRA step, on the CPU.

The factors stay replicated, as the JAX package's ``llm_param_specs``
keeps them (``P()``); each tensor rank's side path uses its slice of them:
a column-parallel projection (q, k, v, gate, up) all of ``lora_a`` and
its output columns of ``lora_b``, a row-parallel one (o, down) its input
rows of ``lora_a`` and all of ``lora_b``, its side output summed with the
main output in the same all-reduce. Each factor's gradient is a per-rank
partial, summed over ``tensor`` before the step.

One SGD step (lr 0.1) of the 2-layer causal LM of ``tests/
test_torch_sharding.py`` with a rank-4 adapter on every target (both
factors drawn nonzero, so both carry a gradient) and the base parameters
trained together, from the same parameters: the port's step over gloo
ranks at ``{"fsdp": 2, "tensor": 2}`` and ``{"tensor": 4}``, and on one
rank, against JAX's step through ``lora_merge`` (``W + a b * scale``):
the loss within atol 1e-5, every updated parameter and factor within
atol 1e-4 (``tests/test_llm.py``'s bounds), and each factor's gradient
(``(start - new) / lr``) within atol 1e-3 (the 1e-4 bound over the lr).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fedml_tpu.llm import CausalLMTrainer as JTrainer
from fedml_tpu.llm import lora_merge as jlora_merge
from fedml_tpu.llm import model as jmodel
from fedml_tpu_torch.interop import flax_to_state_dict

from torch_port_support import rank_runs, single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

LR = 0.1
RANK, ALPHA = 4, 16.0
CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
           num_heads=4, max_seq_len=16, tie_embeddings=False)
MESHES = {"fsdp2_tensor2": {"fsdp": 2, "tensor": 2},
          "tensor4": {"tensor": 4}, "one_rank": {"tensor": 1}}


@pytest.fixture(scope="module")
def setup():
    """The start (base params and a nonzero adapter, flat), the batch, and
    JAX's step: loss, updated base and adapter, the adapter's gradient."""
    model, params = jmodel.init_llm(jmodel.LLMConfig(**CFG),
                                    jax.random.PRNGKey(0))
    base = flax_to_state_dict(jax.device_get(params))
    rs = np.random.RandomState(5)
    from fedml_tpu_torch.llm.lora import lora_shapes
    import torch
    lora = {k: (rs.randn(*s) * 0.1).astype(np.float32)
            for k, s in lora_shapes({k: torch.tensor(v)
                                     for k, v in base.items()}, RANK).items()}
    x = rs.randint(4, 64, (8, 16)).astype(np.int32)
    batch = {"x": x, "y": x, "mask": np.ones(8, np.float32)}
    spec = JTrainer(lambda p, x, rng=None, train=False:
                    model.apply({"params": p}, x))
    jl = {k: jnp.asarray(v) for k, v in lora.items()}

    def loss(p, l):
        return spec.loss(jlora_merge(p, _unflat(l), alpha=ALPHA),
                         {k: jnp.asarray(v) for k, v in batch.items()},
                         None)[0]

    (val, (gp, gl)) = jax.value_and_grad(loss, argnums=(0, 1))(params, jl)
    new_base = jax.tree_util.tree_map(lambda a, g: a - LR * g, params, gp)
    new_lora = {k: np.asarray(jl[k] - LR * gl[k]) for k in jl}
    return dict(base=base, lora=lora, batch=batch, loss=float(val),
                new_base=flax_to_state_dict(jax.device_get(new_base)),
                new_lora=new_lora, grad_lora={k: np.asarray(g)
                                              for k, g in gl.items()})


def _unflat(flat):
    from flax import traverse_util
    return traverse_util.unflatten_dict(flat, sep=".")


@pytest.mark.parametrize("name", sorted(MESHES))
def test_lora_tensor_parallel_step_matches_jax(setup, name):
    shape = MESHES[name]
    n = int(np.prod(list(shape.values())))
    out = rank_runs("sharded_lora_step", n, timeout=240.0,
                    cfg_kw=CFG, params=setup["base"], lora=setup["lora"],
                    batch=setup["batch"], mesh_shape=shape, lr=LR,
                    scale=ALPHA / RANK)
    for r, (loss, got) in enumerate(out):
        np.testing.assert_allclose(loss, setup["loss"], atol=1e-5)
        for k, want in setup["new_base"].items():
            np.testing.assert_allclose(got[k], want, atol=1e-4,
                                       err_msg=f"rank {r} {k}")
        for k, want in setup["new_lora"].items():
            np.testing.assert_allclose(got[k], want, atol=1e-4,
                                       err_msg=f"rank {r} {k}")
            grad = (setup["lora"][k] - got[k]) / LR
            np.testing.assert_allclose(grad, setup["grad_lora"][k],
                                       atol=1e-3, err_msg=f"rank {r} {k}")
    # the factors moved, by more than the bound
    assert max(float(np.abs(g).max()) * LR
               for g in setup["grad_lora"].values()) > 1e-3
