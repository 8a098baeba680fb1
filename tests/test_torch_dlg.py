"""Gradient inversion in the port (``core/security/dlg.py``) against the
JAX package's, on the CPU, on the ``lr`` model of ``synthetic_mnist``:

* iDLG's label from the bias gradient, exact (host integer);
* ``invert_gradient``'s reconstruction after a few Adam steps from the
  same key and the same flax parameters, at ``rtol=1e-4, atol=1e-5``: each
  step differentiates a gradient in float32, and the two frameworks sum
  the second-order terms in different orders, so the trajectories part by
  a few float32 ulps a step (a fivefold rounding of the house tolerance's
  relative part; the iDLG-pinned and the soft-label runs both);
* the port's inversion recovers the input (cosine > 0.8), as the JAX
  package's own test asks of it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.arguments import Arguments as JArguments
from fedml_tpu.core.algframe.client_trainer import \
    ClassificationTrainer as JTrainer
from fedml_tpu.core.security import dlg as jdlg
from fedml_tpu.model import create as jcreate
from fedml_tpu_torch import prng
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.core.algframe.client_trainer import ClassificationTrainer
from fedml_tpu_torch.core.security import dlg
from fedml_tpu_torch.interop import flax_to_state_dict
from fedml_tpu_torch.model import create as tcreate

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-4, atol=1e-5)


def _problem(label=3, bs=1):
    """The JAX package's DLG test problem: one sample's gradient of the
    ``lr`` model; returned for both packages."""
    jargs = JArguments(dataset="synthetic_mnist", model="lr")
    bundle = jcreate(jargs, 10)
    spec = JTrainer(bundle.apply)
    rng = jax.random.PRNGKey(0)
    x = jax.random.normal(jax.random.fold_in(rng, 1), (bs, 784))
    y = jnp.full((bs,), label)
    params = bundle.init(jax.random.fold_in(rng, 2), x)
    batch = {"x": x, "y": y, "mask": jnp.ones((bs,))}
    grads, _ = jax.grad(spec.loss, has_aux=True)(params, batch, rng)
    tb = tcreate(Arguments(dataset="synthetic_mnist", model="lr"), 10,
                 (784,))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in
          flax_to_state_dict(jax.device_get(params)).items()}
    tg = {k: torch.from_numpy(np.array(v)) for k, v in
          flax_to_state_dict(jax.device_get(grads)).items()}
    return ((spec, params, grads), (ClassificationTrainer(tb.apply), tp, tg),
            np.asarray(x))


@pytest.mark.parametrize("label", [0, 3, 9])
def test_idlg_label_exact(label):
    (_, _, jg), (_, _, tg), _ = _problem(label)
    assert dlg.infer_label_idlg(tg, 10) == label
    assert dlg.infer_label_idlg(tg, 10) == jdlg.infer_label_idlg(jg, 10)


def test_idlg_label_none_without_a_bias_leaf():
    (_, _, _), (_, _, tg), _ = _problem()
    assert dlg.infer_label_idlg(tg, 7) is None


@pytest.mark.parametrize("bs", [1, 2], ids=["idlg_pinned", "soft_label"])
def test_invert_gradient_matches_jax(bs):
    (js, jp, jg), (ts, tp, tg), _ = _problem(bs=bs)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 3)
    kw = dict(steps=5, lr=0.05)
    rj = jdlg.invert_gradient(js, jp, jg, (bs, 784), 10, key, **kw)
    rt = dlg.invert_gradient(ts, tp, tg, (bs, 784), 10,
                             np.asarray(key, np.uint32), **kw)
    np.testing.assert_allclose(rt["x"].numpy(), np.asarray(rj["x"]), **TOL)
    np.testing.assert_allclose(rt["y_logits"].numpy(),
                               np.asarray(rj["y_logits"]), **TOL)
    np.testing.assert_allclose(rt["loss_curve"].numpy(),
                               np.asarray(rj["loss_curve"]), **TOL)


def test_invert_gradient_recovers_the_input():
    (_, _, _), (ts, tp, tg), x = _problem()
    out = dlg.invert_gradient(ts, tp, tg, (1, 784), 10,
                              prng.fold_in(prng.PRNGKey(0), 3), steps=2000,
                              lr=0.05)
    rec, truth = out["x"][0].numpy(), x[0]
    cos = np.dot(rec, truth) / (np.linalg.norm(rec) * np.linalg.norm(truth))
    assert cos > 0.8, cos
    assert int(np.argmax(out["y_logits"][0].numpy())) == 3
