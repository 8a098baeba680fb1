"""The port's ResNet-18 and CNNs against the flax models at shared
parameters, and its dropout masks against flax's.

Parameters are drawn by flax and carried across by
``fedml_tpu_torch.interop``; both models run on the same seeded numpy
input. Logits must agree within the house float32 tolerance (rtol 2e-4,
atol 2e-5) and gradients within 1e-4 (they sum over every pixel and
sample); CNNFemnist's dropout masks must equal flax's bit for bit.
"""

from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.model.cv import cnn as jcnn
from fedml_tpu.model.cv.resnet import ResNet18 as JResNet18
from fedml_tpu_torch import prng
from fedml_tpu_torch.arguments import Arguments as TArguments
from fedml_tpu_torch.interop import flax_to_state_dict, state_dict_to_flax
from fedml_tpu_torch.model import model_hub as thub
from fedml_tpu_torch.model.cv import cnn as tcnn
from fedml_tpu_torch.model.cv.resnet import BasicBlock as TBlock
from fedml_tpu_torch.model.cv.resnet import ResNet18 as TResNet18
from fedml_tpu_torch.model.dropout import Dropout, scope_salt

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 2e-4, 2e-5
GRAD_TOL = 1e-4


def _compare(jm, tm, x, n_out, rngs=None, rng_t=None, train=False,
             out_shape=None):
    """Logits and gradients of ``sum(out * cot)`` on both sides."""
    cot = np.random.RandomState(1).randn(
        *(out_shape or (x.shape[0], n_out))).astype(np.float32)
    pj = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                jnp.asarray(x))["params"])

    def loss_j(p):
        out = jm.apply({"params": p}, jnp.asarray(x), train=train, rngs=rngs)
        return jnp.sum(out * cot), out

    (_, out_j), g_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(pj)
    sd = flax_to_state_dict(pj)
    assert set(sd) == set(tm.state_dict()), sorted(
        set(sd) ^ set(tm.state_dict()))
    pt = {k: torch.tensor(v).requires_grad_() for k, v in sd.items()}
    tm.train(train)
    kwargs = {} if rng_t is None else {"rng": rng_t}
    out_t = torch.func.functional_call(tm, pt, (torch.tensor(x),), kwargs)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=RTOL, atol=ATOL)
    grads = torch.autograd.grad((out_t * torch.tensor(cot)).sum(),
                                list(pt.values()))
    g_ref = flax_to_state_dict(jax.device_get(g_j))
    for k, g in zip(pt, grads):
        np.testing.assert_allclose(g.numpy(), g_ref[k], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=k)
    # the trees cross back unchanged
    back = state_dict_to_flax(sd)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: np.array_equal(a, b), back, pj))


@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (2, 72, 72, 3)],
                         ids=["cifar_stem", "imagenet_stem"])
def test_resnet18_logits_and_gradients(shape):
    """Both stems: the 3x3 one below 65 rows, the 7x7 stride-2 conv and
    the SAME 3x3 stride-2 max-pool (36 rows pad one -inf row at the end)
    above. The JAX side's fused="reference" runs the fused block's plain
    math on the two 64-channel blocks, "" flax's modules; the port runs
    its plain block for "reference" (its kernel's CPU version)."""
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    for fused in ("", "reference"):
        tm = TResNet18(10, shape[1:], fused=fused)
        assert tm.small == (shape[1] <= 64)
        assert sum(b.use_fused for b in tm.modules()
                   if isinstance(b, TBlock)) == (2 if fused else 0)
        _compare(JResNet18(10, fused=fused), tm, x, 10)


@pytest.mark.parametrize("name,shape,n_out", [
    ("CNNFemnist", (3, 28, 28, 1), 62), ("CNNFemnist_flat", (3, 784), 62),
    ("SimpleCNN", (3, 32, 32, 3), 10), ("DeviceCNN", (3, 28, 28, 1), 10),
    ("DeviceCNN_flat", (3, 784), 10)])
def test_cnn_logits_and_gradients(name, shape, n_out):
    """Eval mode: SAME convs with biases, GroupNorm(8), VALID max-pools and
    the NHWC flatten before Dense_0 (DeviceCNN's order is the native
    trainer's)."""
    cls = name.split("_")[0]
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    tm = getattr(tcnn, cls)(n_out, input_shape=shape[1:])
    _compare(getattr(jcnn, cls)(n_out), tm, x, n_out)


class _TwoDropouts(fnn.Module):
    """flax's Dropout_0 and Dropout_1 at the top level, as in
    CNNFemnist."""

    @fnn.compact
    def __call__(self, a, b):
        return (fnn.Dropout(0.25, deterministic=False)(a),
                fnn.Dropout(0.5, deterministic=False)(b))


@pytest.mark.parametrize("seed", [0, 7, 123456])
def test_dropout_masks_equal_flax_bitwise(seed):
    """The keep masks of CNNFemnist's two Dropout scopes (at its shapes:
    [bs, 14, 14, 64] and [bs, 128]) equal flax's bit for bit, and so do the
    scaled outputs."""
    key = jax.random.PRNGKey(seed)
    a = np.random.RandomState(seed).randn(4, 14, 14, 64).astype(np.float32)
    b = np.random.RandomState(seed + 1).randn(4, 128).astype(np.float32)
    ja, jb = _TwoDropouts().apply({}, jnp.asarray(a), jnp.asarray(b),
                                  rngs={"dropout": key})
    rng = prng.key_t(np.asarray(key), "cpu")
    d0 = Dropout(0.25, "Dropout_0").train()
    d1 = Dropout(0.5, "Dropout_1").train()
    ta, tb = d0(torch.tensor(a), rng), d1(torch.tensor(b), rng)
    for t, j in ((ta, ja), (tb, jb)):
        np.testing.assert_array_equal(t.numpy() != 0, np.asarray(j) != 0)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # eval mode, or rate 0, is the identity
    assert torch.equal(d0.eval()(torch.tensor(a), rng), torch.tensor(a))


def test_scope_salt_is_flax_fold_in_static():
    from flax.core.scope import _fold_in_static
    key = jax.random.PRNGKey(3)
    for path in (("Dropout_0", 1), ("Dropout_1", 1), ("Dropout_12", 3)):
        want = np.asarray(_fold_in_static(key, path))
        got = prng.fold_in(np.asarray(key), scope_salt(*path))
        np.testing.assert_array_equal(got, want)


def test_cnn_femnist_training_forward_matches_flax():
    """CNNFemnist in training mode with dropout on both sides from one
    key: logits and gradients within the house tolerance, so each mask
    hits the same activations."""
    x = np.random.RandomState(4).randn(3, 28, 28, 1).astype(np.float32)
    key = jax.random.PRNGKey(11)
    tm = tcnn.CNNFemnist(62, input_shape=(28, 28, 1))
    _compare(jcnn.CNNFemnist(62), tm, x, 62, rngs={"dropout": key},
             rng_t=prng.key_t(np.asarray(key), "cpu"), train=True)


def test_model_hub_builds_the_new_models():
    """create() dispatches each name as the JAX hub does, with
    ``_has_dropout`` on CNNFemnist only among them; the RNN names pick
    RNNStackOverflow on a stackoverflow dataset."""
    cases = {"cnn": ((28, 28, 1), "CNNFemnist", True),
             "cnn_dropout": ((28, 28, 1), "CNNFemnist", True),
             "femnist_cnn": ((784,), "CNNFemnist", True),
             "device_cnn": ((28, 28, 1), "DeviceCNN", False),
             "mobile_cnn": ((784,), "DeviceCNN", False),
             "simple_cnn": ((32, 32, 3), "SimpleCNN", False),
             "cifar_cnn": ((32, 32, 3), "SimpleCNN", False),
             "resnet18": ((32, 32, 3), "ResNet18", False),
             "rnn": ((80,), "RNNShakespeare", False),
             "lstm": ((80,), "RNNShakespeare", False),
             "rnn_shakespeare": ((80,), "RNNShakespeare", False),
             "stacked_lstm": ((80,), "RNNShakespeare", False)}
    for name, (shape, cls, drop) in cases.items():
        b = thub.create(TArguments(model=name), 10, shape)
        assert type(b.module).__name__ == cls, name
        assert b.has_dropout is drop, name
    b = thub.create(TArguments(model="rnn", dataset="stackoverflow_nwp"), 32,
                    (20,))
    assert type(b.module).__name__ == "RNNStackOverflow"
