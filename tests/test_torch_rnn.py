"""The port's federated RNNs against flax's at shared parameters, at narrow
widths (hidden 16, sequence 12, vocabulary 32).

Logits and gradients agree within the house float32 tolerance (rtol 2e-4,
atol 2e-5; gradients 1e-4, as they sum over the batch and the 12 steps):
the recurrence runs the same products in the same order (flax's
``(h @ Wh + b) + x @ Wi``), so 12 steps of f32 rounding stay far inside it.
The parameter trees cross unchanged (``OptimizedLSTMCell_k.ii.kernel``,
...), and the FLOP counter sees the LSTM's matmuls.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from fedml_tpu.model.nlp import rnn as jrnn
from fedml_tpu_torch.interop import flax_to_state_dict, state_dict_to_flax
from fedml_tpu_torch.model.nlp import rnn as trnn

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 2e-4, 2e-5
GRAD_TOL = 1e-4
BS, L, V, H, E = 3, 12, 32, 16, 8


def _models(name):
    if name == "shakespeare":
        return (jrnn.RNNShakespeare(V, E, H, 2),
                trnn.RNNShakespeare(V, E, H, 2))
    return (jrnn.RNNStackOverflow(V, E, H),
            trnn.RNNStackOverflow(V, E, H))


@pytest.mark.parametrize("name", ["shakespeare", "stackoverflow"])
def test_rnn_logits_and_gradients_match_flax(name):
    jm, tm = _models(name)
    x = np.random.RandomState(0).randint(0, V, size=(BS, L)).astype(np.int32)
    cot = np.random.RandomState(1).randn(BS, L, V).astype(np.float32)
    pj = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                jnp.asarray(x))["params"])

    def loss_j(p):
        out = jm.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(out * cot), out

    (_, out_j), g_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(pj)
    sd = flax_to_state_dict(pj)
    assert set(sd) == set(tm.state_dict())
    pt = {k: torch.tensor(v).requires_grad_() for k, v in sd.items()}
    out_t = torch.func.functional_call(tm, pt, (torch.tensor(x),))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=RTOL, atol=ATOL)
    grads = torch.autograd.grad((out_t * torch.tensor(cot)).sum(),
                                list(pt.values()))
    g_ref = flax_to_state_dict(jax.device_get(g_j))
    for k, g in zip(pt, grads):
        np.testing.assert_allclose(g.numpy(), g_ref[k], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=k)
    back = state_dict_to_flax(sd)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: np.array_equal(a, b), back, pj))


def test_full_width_shakespeare_tree():
    """At full width the tree is flax's: 820,522 parameters, the same
    names and shapes."""
    jm = jrnn.RNNShakespeare()
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 80), jnp.int32)))["params"]
    want = {k: tuple(v.shape) for k, v in flax_to_state_dict(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                               shapes)).items()}
    tm = trnn.RNNShakespeare()
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == want
    assert sum(int(np.prod(s)) for s in got.values()) == 820522


def test_flop_counter_sees_the_lstm():
    """One forward's matmul FLOPs: per LSTM layer 2 * 4 (in + h) h per
    token, plus the embedding-free Dense head."""
    tm = trnn.RNNShakespeare(V, E, H, 2)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randint(0, V, (BS, L))
    with FlopCounterMode(display=False) as c:
        tm(x)
    lstm = sum(2 * 4 * (i + H) * H * L * BS for i in (E, H))
    assert c.get_total_flops() == lstm + 2 * H * V * L * BS


def test_engine_round_flops_count_the_lstm(tmp_path):
    """The GPU engine's ``round_cost_flops`` (the MFU numerator) counts
    the LSTM's matmuls: the closed form ``3 * 2 * 4 (in + h) h * L * bs``
    per layer (the backward does two products per forward product) plus
    the Dense head's, times the round's real steps, less one product per
    layer the backward skips: the zero carry at step 0 needs no
    gradient."""
    import fedml_tpu_torch.data as tdata
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.core.algframe.types import TrainHyper
    from fedml_tpu_torch.model.model_hub import ModelBundle
    from fedml_tpu_torch.runner import FedMLRunner

    args = Arguments(dataset="shakespeare", model="rnn", backend="gpu",
                     client_num_in_total=4, client_num_per_round=3,
                     batch_size=8, epochs=2, data_cache_dir=str(tmp_path))
    fed, n_out = tdata.load(args)
    bundle = ModelBundle(trnn.RNNShakespeare(n_out, E, H, 2), "rnn")
    sim = FedMLRunner(args, device="cpu", dataset=fed, model=bundle).runner
    flops = sim.round_cost_flops(TrainHyper(learning_rate=0.1, epochs=2))
    bs, seq = 8, fed.train.x.shape[-1]
    fwd = (sum(2 * 4 * (i + H) * H * seq * bs for i in (E, H))
           + 2 * H * n_out * seq * bs)
    real = np.any(fed.train.mask > 0, axis=-1).sum(axis=-1)
    steps = 3 * 2 * float(np.mean(real))
    closed = 3 * fwd * steps
    carry = 2 * (2 * H * 4 * H * bs) * steps
    assert flops == pytest.approx(closed - carry, rel=1e-12)
    assert abs(closed - flops) / closed < 1 / seq
