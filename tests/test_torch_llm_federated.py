"""The federated LoRA fine-tune: ``fedml_tpu_torch.llm.run_federated_llm(
device="cpu")`` against ``fedml_tpu.llm.run_federated_llm`` (the JAX
``TPUSimulator``), and the small repairs the LLM path needed in the
runner, the trainer-spec dispatch, the simulator and the data containers.

The port runs its default flash attention (on CPU tensors, the kernels'
plain versions inside the same autograd Function); the JAX side runs dense
attention. Both start from the same flax-drawn base weights and adapters;
the 2-round histories and the final adapters must agree within the house
float32 tolerance.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.arguments import Arguments as JArguments
from fedml_tpu.data import containers as jcontainers
from fedml_tpu.llm import federated as jfed
from fedml_tpu.llm import lora as jlora
from fedml_tpu.llm import model as jmodel
from fedml_tpu_torch.arguments import Arguments as TArguments
from fedml_tpu_torch.core.algframe.client_trainer import (
    ClassificationTrainer, make_trainer_spec)
from fedml_tpu_torch.core.kernels import flash_attention as fa
from fedml_tpu_torch.data import containers as tcontainers
from fedml_tpu_torch.interop import flax_to_state_dict, state_dict_to_flax
from fedml_tpu_torch.llm import federated as tfed
from fedml_tpu_torch.llm.trainer import CausalLMTrainer
from fedml_tpu_torch.runner import FedMLRunner

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 2e-4, 2e-5
CFG = dict(dataset="llm_synth", model="causal_lm", client_num_in_total=2,
           client_num_per_round=2, comm_round=2, epochs=1, batch_size=8,
           learning_rate=5e-3, client_optimizer="adam", llm_corpus_size=64,
           llm_max_seq_len=48, llm_hidden_size=32, llm_num_layers=1,
           llm_num_heads=2, llm_intermediate_size=64, lora_rank=4,
           random_seed=7, frequency_of_the_test=1)


def _jax_start(cfg):
    """The JAX run's frozen base and starting adapters: ``init_llm`` on
    ``PRNGKey(seed)`` and ``lora_init`` on the engine's init key, the first
    half of ``split(PRNGKey(seed))``."""
    args = JArguments(backend="tpu", **cfg)
    jcfg = jfed.llm_config_from_args(args)
    key = jax.random.PRNGKey(cfg["random_seed"])
    _, base = jmodel.init_llm(jcfg, key)
    lora = jlora.lora_init(jax.random.split(key)[0], base,
                           rank=cfg["lora_rank"])
    return jax.device_get(base), jax.device_get(lora)


@pytest.fixture(scope="module")
def jax_run():
    base, lora = _jax_start(CFG)
    result = jfed.run_federated_llm(JArguments(
        backend="tpu", training_type="simulation",
        llm_attention_impl="dense", **CFG))
    return base, lora, result


def test_two_round_lora_run_matches_jax(jax_run):
    base, lora, rj = jax_run
    launches = (fa.flash_fwd.launches, fa.flash_dq.launches,
                fa.flash_dkv.launches)
    rt = tfed.run_federated_llm(
        TArguments(**CFG), device="cpu",
        base_params=flax_to_state_dict(base),
        init_params=flax_to_state_dict(lora))
    # CPU tensors take the plain versions: no kernel launch
    assert (fa.flash_fwd.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == launches
    assert rt["rounds"] == rj["rounds"] == 2
    assert len(rt["history"]) == len(rj["history"])
    for ht, hj in zip(rt["history"], rj["history"]):
        assert ht["local_steps"] > 0
        for k in ("train_loss", "train_acc", "test_acc", "test_loss"):
            np.testing.assert_allclose(ht[k], hj[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    want = flax_to_state_dict(jax.device_get(rj["params"]))
    start = flax_to_state_dict(lora)
    assert set(rt["params"]) == set(want)
    for k, v in rt["params"].items():
        assert v.device.type == "cpu" and v.dtype == torch.float32
        np.testing.assert_allclose(v.numpy(), want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    # the adapters trained: lora_b left zero
    assert max(float(np.abs(want[k] - start[k]).max()) for k in want
               if k.endswith("lora_b")) > 1e-3


def test_adapter_tree_interop_round_trip(jax_run):
    _, lora, _ = jax_run
    sd = flax_to_state_dict(lora)
    assert all(k.rsplit(".", 1)[1] in ("lora_a", "lora_b") for k in sd)
    back = state_dict_to_flax(sd)
    flat_a = flax_to_state_dict(back)
    assert set(flat_a) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(flat_a[k], sd[k])


def test_fresh_seeded_run_is_reproducible():
    """Without base_params/init_params the port draws both from
    torch.Generators seeded by ``random_seed``: two runs agree exactly."""
    cfg = dict(CFG, comm_round=1, llm_corpus_size=24)
    a = tfed.run_federated_llm(TArguments(**cfg), device="cpu")
    b = tfed.run_federated_llm(TArguments(**cfg), device="cpu")
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    assert np.isfinite(a["history"][0]["train_loss"])


def test_full_fine_tune_when_rank_is_zero():
    cfg = dict(CFG, comm_round=1, llm_corpus_size=24, lora_rank=0)
    r = tfed.run_federated_llm(TArguments(**cfg), device="cpu")
    bundle, _ = tfed.build_llm_bundle(TArguments(**cfg))
    assert bundle.base_params is None
    assert set(r["params"]) == set(bundle.module.state_dict())


@pytest.mark.parametrize("knob,value", [
    ("llm_attention_impl", "ring"),
    ("chaos_serving_nan_at_step", 4)])
def test_unported_llm_knobs_raise(knob, value):
    cfg = dict(CFG, comm_round=1, llm_corpus_size=24, **{knob: value})
    with pytest.raises(NotImplementedError, match=knob):
        tfed.run_federated_llm(TArguments(**cfg), device="cpu")


def test_needs_cuda_unless_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfed.run_federated_llm(TArguments(**CFG))


def test_default_attention_is_flash():
    assert tfed.llm_config_from_args(TArguments(**CFG)).attention_impl == \
        "flash"
    assert tfed.llm_config_from_args(TArguments(
        llm_attention_impl="dense", **CFG)).attention_impl == "dense"


# -------------------------------------------------------------- repairs --


def _tiny_dataset(task):
    rng = np.random.RandomState(0)
    xs = [rng.randint(0, 9, (5, 6)).astype(np.int32) for _ in range(2)]
    ys = [rng.randint(0, 9, (5, 6)).astype(np.int32) for _ in range(2)]
    tx = rng.randint(0, 9, (3, 6)).astype(np.int32)
    return (xs, ys, tx, tx), dict(batch_size=2, num_classes=9,
                                  dtype=np.int32, task=task)


@pytest.mark.parametrize("task", ["classification", "llm"])
def test_build_federated_dataset_takes_task(task):
    arrays, kw = _tiny_dataset(task)
    ft = tcontainers.build_federated_dataset(*arrays, **kw)
    fj = jcontainers.build_federated_dataset(*arrays, **kw)
    assert ft.task == fj.task == task
    np.testing.assert_array_equal(ft.train.x, np.asarray(fj.train.x))
    np.testing.assert_array_equal(ft.test["mask"],
                                  np.asarray(fj.test["mask"]))


def test_make_trainer_spec_routes_the_llm_task():
    arrays, kw = _tiny_dataset("llm")
    bundle, _ = tfed.build_llm_bundle(TArguments(**CFG))
    for task in ("llm", "causal_lm"):
        fed = tcontainers.build_federated_dataset(*arrays,
                                                  **dict(kw, task=task))
        spec = make_trainer_spec(fed, bundle)
        assert isinstance(spec, CausalLMTrainer)
        assert spec.apply_fn == bundle.apply
    fed = tcontainers.build_federated_dataset(*arrays, **dict(
        kw, task="classification"))
    assert isinstance(make_trainer_spec(fed, bundle), ClassificationTrainer)
    with pytest.raises(NotImplementedError, match="regression"):
        make_trainer_spec(tcontainers.build_federated_dataset(
            *arrays, **dict(kw, task="regression")), bundle)


def test_runner_takes_client_trainer():
    args = TArguments(**CFG)
    fed, bundle, spec, _ = tfed.build_llm(args)
    runner = FedMLRunner(args, device="cpu", dataset=fed, model=bundle,
                         client_trainer=spec)
    assert runner.runner.spec is spec
    default = FedMLRunner(args, device="cpu", dataset=fed, model=bundle)
    assert isinstance(default.runner.spec, CausalLMTrainer)
    assert default.runner.spec is not spec


def test_simulator_checks_init_params_against_the_bundle_template():
    """The LLM's trainable dict is the adapter dict, not the module's
    state dict: the simulator checks names and shapes against the
    bundle's own template."""
    args = TArguments(**CFG)
    fed, bundle, spec, _ = tfed.build_llm(args)
    good = {k: np.zeros(shape, np.float32)
            for k, shape in bundle.template().items()}
    assert all(k.endswith(("lora_a", "lora_b")) for k in good)
    r = FedMLRunner(args, device="cpu", dataset=fed, model=bundle,
                    client_trainer=spec, init_params=good)
    assert set(r.runner.params) == set(good)
    with pytest.raises(ValueError, match="missing"):
        FedMLRunner(args, device="cpu", dataset=fed, model=bundle,
                    client_trainer=spec,
                    init_params=bundle.module.state_dict())
    bad = dict(good)
    key = next(iter(bad))
    bad[key] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        FedMLRunner(args, device="cpu", dataset=fed, model=bundle,
                    client_trainer=spec, init_params=bad)
    with pytest.raises(ValueError, match="base_params keys"):
        tfed.build_llm_bundle(args, base_params={"embed.embedding": 0})
