"""The port's LeNet-5, finance nets, VGG-11/16, MobileNetV3-Small,
EfficientNet-lite B0-B2, the GAN pair, SegNet and the FedGKT / FedNAS
nets against the flax models at shared parameters.

flax draws the parameters, ``fedml_tpu_torch.interop`` carries them
across (the state dict's keys must be exactly the flax tree's paths), and
both sides run the same seeded numpy input. Outputs agree within the
house tolerance (rtol 2e-4, atol 2e-5), and so do the gradients of
``sum(out * cotangent)`` with the absolute part scaled by each
gradient's largest entry (when above 1): an entry of a conv kernel's
gradient sums over every pixel and sample of a deep net, so its rounding
follows the size of the largest terms of that sum, not its own (the
MobileNet stem's is ~1e-5 of a gradient whose largest entry is 6.5).
The dropout models (VGG, EfficientNet) also run in training
mode from one key on both sides, so the masks must hit the same units.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu_torch import prng
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.interop import flax_to_state_dict, state_dict_to_flax
from fedml_tpu_torch.model import model_hub as thub

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 2e-4, 2e-5


def _compare(jm, tm, inputs, train=False, key=None, init_args=None,
             first=lambda out: out, grads=True):
    """Outputs and (``grads``) gradients of both models on ``inputs`` (a
    tuple of numpy arrays); ``first`` picks the array to compare from a
    tuple output."""
    jin = tuple(jnp.asarray(a) for a in inputs)
    pj = jax.device_get(jax.jit(lambda k, *a: jm.init(k, *a)["params"])(
        jax.random.PRNGKey(0), *(init_args or jin)))
    rngs = None if key is None else {"dropout": key}
    kw = {"train": train} if train else {}

    def loss_j(p):
        out = first(jm.apply({"params": p}, *jin, rngs=rngs, **kw))
        return jnp.sum(out * cot), out

    out0 = jax.eval_shape(lambda p: first(jm.apply({"params": p}, *jin,
                                                   rngs=rngs, **kw)), pj)
    cot = np.random.RandomState(1).randn(*out0.shape).astype(np.float32)
    if grads:
        (_, out_j), g_j = jax.jit(jax.value_and_grad(loss_j,
                                                     has_aux=True))(pj)
    else:
        out_j = jax.jit(lambda p: loss_j(p)[1])(pj)
    sd = flax_to_state_dict(pj)
    assert set(sd) == set(tm.state_dict()), sorted(
        set(sd) ^ set(tm.state_dict()))
    pt = {k: torch.tensor(v).requires_grad_() for k, v in sd.items()}
    tm.train(train)
    kwargs = {} if key is None else {"rng": prng.key_t(np.asarray(key),
                                                       "cpu")}
    out_t = first(torch.func.functional_call(
        tm, pt, tuple(torch.tensor(a) for a in inputs), kwargs))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=RTOL, atol=ATOL)
    if not grads:
        return
    grads = torch.autograd.grad((out_t * torch.tensor(cot)).sum(),
                                list(pt.values()))
    g_ref = flax_to_state_dict(jax.device_get(g_j))
    for k, g in zip(pt, grads):
        scale = max(1.0, float(np.max(np.abs(g_ref[k]))))
        np.testing.assert_allclose(g.numpy(), g_ref[k], rtol=RTOL,
                                   atol=ATOL * scale, err_msg=k)
    back = state_dict_to_flax(sd)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: np.array_equal(a, b), back, pj))


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(3, 28, 28, 1), (2, 32, 32, 3)])
def test_lenet(shape):
    from fedml_tpu.model.cv.lenet import LeNet5 as J
    from fedml_tpu_torch.model.cv.lenet import LeNet5
    _compare(J(10), LeNet5(10, input_shape=shape[1:]), (_x(*shape),))


@pytest.mark.parametrize("name", ["VFLFeatureExtractor", "VFLClassifier",
                                  "LendingClubMLP"])
def test_finance_nets(name):
    from fedml_tpu.model import finance as J
    from fedml_tpu_torch.model import finance as T
    x = _x(5, 12)
    jm = J.VFLFeatureExtractor(out_dim=7) if name.startswith("VFLF") else \
        getattr(J, name)(3)
    tm = T.VFLFeatureExtractor(12, out_dim=7) if name.startswith("VFLF") \
        else getattr(T, name)(12, 3)
    _compare(jm, tm, (x,))


@pytest.mark.parametrize("name", ["vgg11", "vgg16"])
def test_vgg_eval_and_train(name):
    """Training mode with dropout from one key (VGG-11 in eval mode
    too)."""
    from fedml_tpu.model.cv.vgg import create_vgg as J
    from fedml_tpu_torch.model.cv.vgg import create_vgg
    x = _x(2, 32, 32, 3)
    if name == "vgg11":
        _compare(J(name, 10), create_vgg(name, 10), (x,))
    _compare(J(name, 10), create_vgg(name, 10), (x,), train=True,
             key=jax.random.PRNGKey(5))


@pytest.mark.parametrize("shape", [(2, 28, 28, 1), (2, 784)],
                         ids=["femnist", "flat"])
def test_mobilenet_v3_small(shape):
    """FEMNIST's 28x28x1 (the hierarchical benchmark's input), and a flat
    784 input reshaped to it (the logits: the same path after the
    reshape)."""
    from fedml_tpu.model.cv.mobilenet import MobileNetV3Small as J
    from fedml_tpu_torch.model.cv.mobilenet import MobileNetV3Small
    _compare(J(62), MobileNetV3Small(62, input_shape=shape[1:]),
             (_x(*shape),), grads=len(shape) == 4)


@pytest.mark.parametrize("hs,se", [(True, True), (False, False)])
def test_inverted_residual_stride2_depthwise_5x5_even_input(hs, se):
    """A stride-2 5x5 depthwise block on an even 8x8 input: XLA's SAME
    pads it (1, 2), the grouped conv takes the [5, 5, 1, C] kernel."""
    from fedml_tpu.model.cv.mobilenet import InvertedResidual as J
    from fedml_tpu_torch.model.cv.mobilenet import InvertedResidual
    x = _x(2, 8, 8, 24)
    tm = InvertedResidual(24, 96, 40, 5, 2, se, hs)
    assert tuple(tm.Conv_1.kernel.shape) == (5, 5, 1, 96)
    _compare(J(96, 40, 5, 2, se, hs), tm, (x,))


def test_efficientnet_eval_and_train():
    """B0 in training mode with dropout from one key (in eval mode the
    one Dropout is the identity; the rest is the same path)."""
    from fedml_tpu.model.cv.efficientnet import create_efficientnet as J
    from fedml_tpu_torch.model.cv.efficientnet import create_efficientnet
    name = "efficientnet-b0"
    _compare(J(name, 10), create_efficientnet(name, 10), (_x(2, 32, 32, 3),),
             train=True, key=jax.random.PRNGKey(9))


@pytest.mark.parametrize("name", ["efficientnet-b1", "efficientnet-b2"])
def test_efficientnet_scaled_widths_and_depths(name):
    """B1 / B2 are B0's module at other multipliers: their parameter
    trees (the width rule ``max(8, int(f wm + 4) // 8 * 8)``, the depth
    rule ``round(n dm)``) equal flax's name for name and shape for shape;
    B0's module is held to flax numerically above."""
    from fedml_tpu.model.cv.efficientnet import create_efficientnet as J
    from fedml_tpu_torch.model.cv.efficientnet import create_efficientnet
    x = jnp.zeros((1, 32, 32, 3))
    tree = jax.eval_shape(lambda k: J(name, 10).init(k, x)["params"],
                          jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in flax_to_state_dict(
        jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                               tree)).items()}
    got = {k: tuple(v.shape)
           for k, v in create_efficientnet(name, 10).state_dict().items()}
    assert got == want


def test_gan_pair():
    from fedml_tpu.model.cv.gan import Discriminator as JD
    from fedml_tpu.model.cv.gan import Generator as JG
    from fedml_tpu_torch.model.cv.gan import Discriminator, Generator
    _compare(JG(), Generator(), (_x(4, 100),))
    _compare(JD(), Discriminator(784), (_x(4, 28, 28, 1),))


@pytest.mark.parametrize("shape", [(2, 16, 16, 3), (2, 12, 20, 3)],
                         ids=["square", "non_square"])
def test_segnet(shape):
    """flax's ConvTranspose (SAME, stride 2, kernel not flipped) as the
    port's flipped conv_transpose2d cropped to 2H x 2W."""
    from fedml_tpu.simulation.sp.fedseg import SegNet as J
    from fedml_tpu_torch.simulation.sp.fedseg import SegNet
    _compare(J(3, width=8), SegNet(3, width=8), (_x(*shape),))


def test_gkt_nets():
    from fedml_tpu.simulation.sp import fedgkt as J
    from fedml_tpu_torch.simulation.sp import fedgkt as T
    # the logits (through the features h)
    _compare(J._EdgeNet(64, 10), T._EdgeNet(784, 64, 10),
             (_x(4, 28, 28, 1),), first=lambda out: out[1])
    _compare(J._ServerHead(10), T._ServerHead(64, 10), (_x(4, 64),))


def test_nas_supernet():
    """cell{i}.op_linear / op_relu / op_proj keep flax's kernel layout;
    the alphas are an input of both."""
    from fedml_tpu.simulation.sp.fednas import _SuperNet as J
    from fedml_tpu_torch.simulation.sp.fednas import _SuperNet
    alphas = _x(2, 4, seed=3)
    _compare(J(10), _SuperNet(784, 10), (_x(4, 784), alphas))


@pytest.mark.parametrize("name,cls", [
    ("lenet", "LeNet5"), ("vgg11", "VGG"), ("vgg16", "VGG"),
    ("mobilenet", "MobileNetV3Small"), ("efficientnet-b0", "EfficientNetLite"),
    ("efficientnet-b1", "EfficientNetLite"),
    ("efficientnet-b2", "EfficientNetLite"),
    ("vfl_feature_extractor", "VFLFeatureExtractor"),
    ("local_model", "VFLFeatureExtractor"), ("dense_model", "VFLClassifier"),
    ("vfl_classifier", "VFLClassifier"), ("finance_mlp", "LendingClubMLP"),
    ("lending_club_mlp", "LendingClubMLP")])
def test_model_hub_builds_each_name(name, cls):
    """The hub's names, their dropout flag (the JAX hub's
    ``_has_dropout``) and ``precision`` -> the compute dtype; each
    module's init draws from a generator and the parameter names equal
    flax's."""
    shape = (28, 28, 1) if name in ("lenet", "mobilenet") else (
        (12,) if "vfl" in name or "model" in name or "mlp" in name
        else (32, 32, 3))
    b = thub.create(Arguments(model=name, precision="bf16"), 10, shape)
    assert type(b.module).__name__ == cls
    assert b.compute_dtype == torch.bfloat16
    assert b.has_dropout == (cls in ("VGG", "EfficientNetLite"))
    p = b.init(torch.Generator().manual_seed(0), torch.device("cpu"))
    x = torch.zeros((2,) + shape)
    out = b.apply(p, x, rng=prng.key_t(np.asarray(jax.random.PRNGKey(0)),
                                       "cpu"), train=True)
    assert out.shape == (2, 10) and out.dtype == torch.float32


def test_model_hub_gan_pair_and_unknown_names():
    g, d = thub.create(Arguments(model="gan", precision="bf16"), 10,
                       (28, 28, 1))
    assert (g.name, d.name) == ("generator", "discriminator")
    assert g.compute_dtype == d.compute_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="resnet99x"):
        thub.create(Arguments(model="resnet99x"), 10, (32, 32, 3))
    with pytest.raises(ValueError, match="alexnet"):
        thub.create(Arguments(model="alexnet"), 10, (32, 32, 3))
