"""The port's CIFAR ResNet against the flax model at shared parameters.

Parameters are drawn by flax, carried across by ``fedml_tpu_torch.interop``
and both models run on the same numpy input: logits and gradients must
agree within the house float32 tolerance for every ``fused`` mode (the JAX
side's ``pallas`` mode runs the Pallas kernel in interpret mode).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.model import model_hub as jhub
from fedml_tpu.model.cv.resnet import BasicBlock as JBlock
from fedml_tpu.model.cv.resnet import CifarResNet as JResNet
from fedml_tpu_torch.arguments import Arguments as TArguments
from fedml_tpu_torch.interop import flax_to_state_dict, state_dict_to_flax
from fedml_tpu_torch.model import model_hub as thub
from fedml_tpu_torch.model.cv.resnet import BasicBlock as TBlock
from fedml_tpu_torch.model.cv.resnet import CifarResNet as TResNet

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 2e-4, 2e-5


def _flax_params(module, x, seed=0):
    return jax.device_get(
        module.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"])


def _torch_params(sd):
    return {k: torch.tensor(v) for k, v in sd.items()}


@pytest.mark.parametrize("fused", ["", "reference", "pallas"])
def test_logits_and_gradients_match_flax(fused):
    x = np.random.RandomState(0).randn(2, 8, 8, 3).astype(np.float32)
    cot = np.random.RandomState(1).randn(2, 10).astype(np.float32)
    jm = JResNet(10, blocks_per_stage=1, fused=fused)
    pj = _flax_params(jm, x)

    def loss_j(p):
        out = jm.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(out * cot), out

    (_, out_j), g_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(pj)
    tm = TResNet(10, blocks_per_stage=1, fused=fused)
    assert sum(b.use_fused for b in tm.modules()
               if isinstance(b, TBlock)) == (3 if fused else 0)
    pt = _torch_params(flax_to_state_dict(pj))
    for v in pt.values():
        v.requires_grad_()
    out_t = torch.func.functional_call(tm, pt, (torch.tensor(x),))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=RTOL, atol=ATOL)
    grads = torch.autograd.grad((out_t * torch.tensor(cot)).sum(),
                                list(pt.values()))
    g_t = flax_to_state_dict(jax.device_get(g_j))
    # gradients sum over every pixel and sample (entries reach O(10)), so
    # the bound is 1e-4 rather than the house atol 2e-5
    for k, g in zip(pt, grads):
        np.testing.assert_allclose(g.numpy(), g_t[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_bf16_bundle_matches_flax_bundle():
    """``precision: bfloat16`` casts params and input at the boundary on
    both sides; logits agree within bf16 rounding (0.06, the JAX
    package's own bf16 bound for the block)."""
    x = np.random.RandomState(2).randn(2, 8, 8, 3).astype(np.float32)
    jb = jhub.ModelBundle(JResNet(10, 1), "resnet", compute_dtype=jnp.bfloat16)
    pj = _flax_params(jb.module, x, seed=3)
    tb = thub.ModelBundle(TResNet(10, 1), "resnet",
                          compute_dtype=torch.bfloat16)
    out_t = tb.apply(_torch_params(flax_to_state_dict(pj)), torch.tensor(x))
    assert out_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(),
                               np.asarray(jb.apply(pj, jnp.asarray(x))),
                               rtol=0.06, atol=0.06)


def test_converter_both_ways():
    x = np.zeros((1, 8, 8, 3), np.float32)
    pj = _flax_params(JResNet(10, blocks_per_stage=3), x)
    sd = flax_to_state_dict(pj)
    tm = TResNet(10, blocks_per_stage=3)
    want = tm.state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        assert sd[k].shape == tuple(v.shape), k
    assert sd["Dense_0.weight"].shape == (10, 64)
    np.testing.assert_array_equal(sd["Dense_0.weight"],
                                  pj["Dense_0"]["kernel"].T)
    back = state_dict_to_flax(_torch_params(sd))
    flat_a = jax.tree_util.tree_leaves_with_path(pj)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (p, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b, err_msg=str(p))


@pytest.mark.parametrize("value", [None, False, "", "false", "off", True,
                                   "true", "pallas", "1", "reference",
                                   "xla"])
def test_fused_conv_mode_strings(value):
    kw = {} if value is None else {"fused_conv_block": value}

    class _Args:
        pass

    a = _Args()
    a.__dict__.update(kw)
    assert thub._fused_conv_mode(a) == jhub._fused_conv_mode(a)
    assert thub._fused_conv_mode(TArguments(**kw)) == jhub._fused_conv_mode(a)


def test_fused_conv_mode_refuses_unknown():
    with pytest.raises(ValueError, match="pallas"):
        thub._fused_conv_mode(TArguments(fused_conv_block="mystery"))


def test_wide_blocks_stay_unfused():
    """Blocks wider than MAX_FUSED_CHANNELS keep the unfused path even with
    the knob on, and so give exactly the unfused module's output (and
    match flax's)."""
    wide = 128
    x = np.random.RandomState(21).randn(2, 4, 4, wide).astype(np.float32)
    jm = JBlock(wide, strides=1)
    pj = _flax_params(jm, x, seed=22)
    pt = _torch_params(flax_to_state_dict(pj))
    base = TBlock(wide, wide)
    fused = TBlock(wide, wide, fused="pallas")
    assert not fused.use_fused
    out_b = torch.func.functional_call(base, pt, (torch.tensor(x),))
    out_f = torch.func.functional_call(fused, pt, (torch.tensor(x),))
    assert torch.equal(out_b, out_f)
    np.testing.assert_allclose(
        out_f.numpy(), np.asarray(jm.apply({"params": pj}, jnp.asarray(x))),
        rtol=RTOL, atol=ATOL)


def test_model_hub_refuses_unported_models():
    with pytest.raises(NotImplementedError, match="model"):
        thub.create(TArguments(model="cnn"), 10)
    with pytest.raises(NotImplementedError, match="resnet18"):
        thub.create(TArguments(model="resnet18"), 10)
    bundle = thub.create(TArguments(model="resnet56", precision="bf16",
                                    fused_conv_block=True), 10)
    assert bundle.compute_dtype == torch.bfloat16
    assert bundle.module.num_blocks == 27
