"""Model artifacts across the two packages: ``serving.save_model`` /
``load_model``, ``run_simulation(save_model_path=...)``,
``CheckpointPredictor`` and the LM's ``from_artifact`` / ``serve_chat``.

An artifact holds the nested flax tree in both packages, so the same
parameters give the same bytes (``interop.state_dict_to_flax`` on the
port's side), and each package serves the other's artifact. Numbers are
held to the house tolerance ``rtol=2e-4, atol=2e-5``; greedy tokens must be
identical (the JAX reference in single mode, off its engine thread). Every server binds port 0 and is stopped, every engine closed.
"""

from __future__ import annotations

import json
import urllib.request

import jax
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu.data
import fedml_tpu.model
from fedml_tpu.arguments import Arguments as JArguments
from fedml_tpu.llm.federated import build_llm_bundle as j_build_bundle
from fedml_tpu.serving import CheckpointPredictor as JCheckpointPredictor
from fedml_tpu.serving import save_model as j_save_model
from fedml_tpu.serving.llm_template import CausalLMPredictor as JPredictor
import fedml_tpu_torch
from fedml_tpu_torch.arguments import Arguments as TArguments
from fedml_tpu_torch.interop import flax_to_state_dict
from fedml_tpu_torch.serving import (CheckpointPredictor,
                                     FedMLInferenceRunner, check_model_magic,
                                     load_model, save_model)
from fedml_tpu_torch.serving.llm_template import (CausalLMPredictor,
                                                  serve_chat)

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 2e-4, 2e-5
TIMEOUT_S = 60.0
PROMPTS = ["add 2 3", "echo hello world", "x",
           "subtract 19 4 and then explain"]
MLP_CFG = dict(dataset="synthetic_mnist", model="mlp",
               client_num_in_total=4, client_num_per_round=2, comm_round=2,
               batch_size=8, learning_rate=0.05, max_total_samples=64,
               synthetic_test_size=64, frequency_of_the_test=1,
               random_seed=3)


def _jax_initial_params(cfg):
    """The JAX engine's starting params: its init key is the first half
    of ``split(PRNGKey(seed))``, on one batch's input shape."""
    args = JArguments(backend="tpu", **cfg)
    fed, out_dim = fedml_tpu.data.load(args)
    bundle = fedml_tpu.model.create(args, out_dim)
    key = jax.random.split(jax.random.PRNGKey(cfg["random_seed"]))[0]
    return jax.device_get(bundle.init(key, fed.train.x[0, 0])), fed


def _tensors(tree):
    return {k: torch.tensor(np.asarray(v))
            for k, v in flax_to_state_dict(tree).items()}


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
        return r.status, json.loads(r.read())


def _lm_kw(**over):
    kw = dict(dataset="llm_synthetic", model="causal_lm",
              client_num_in_total=2, client_num_per_round=2, comm_round=1,
              epochs=1, batch_size=4, learning_rate=1e-3, random_seed=3,
              llm_hidden_size=32, llm_num_layers=2, llm_num_heads=2,
              llm_intermediate_size=64, llm_max_seq_len=64, lora_rank=0,
              llm_attention_impl="dense", serving_slots=4,
              serving_prefill_chunk=8, serving_request_timeout_s=TIMEOUT_S)
    kw.update(over)
    return kw


@pytest.mark.parametrize("model", ["resnet20", "mlp", "causal_lm"])
def test_save_model_is_byte_equal(tmp_path, model):
    if model == "causal_lm":
        jb, _ = j_build_bundle(JArguments(**_lm_kw(lora_rank=4)))
        tree = jax.device_get(jb.base_params)
    else:
        tree, _ = _jax_initial_params(dict(MLP_CFG, model=model))
    j_save_model(tree, str(tmp_path / "j.fmtpu"))
    save_model(_tensors(tree), str(tmp_path / "t.fmtpu"))   # state dict
    save_model(tree, str(tmp_path / "n.fmtpu"))             # nested tree
    want = (tmp_path / "j.fmtpu").read_bytes()
    assert (tmp_path / "t.fmtpu").read_bytes() == want
    assert (tmp_path / "n.fmtpu").read_bytes() == want
    back = load_model(str(tmp_path / "j.fmtpu"))
    got = flax_to_state_dict(back)
    for k, v in _tensors(tree).items():
        assert torch.equal(torch.from_numpy(np.array(got[k])), v), k
    assert not list(tmp_path.glob("*.tmp"))


def test_magic_check_refuses_a_foreign_file(tmp_path):
    bad = tmp_path / "pickle.bin"
    bad.write_bytes(b"\x80\x04K\x01.")
    for fn in (check_model_magic, load_model):
        with pytest.raises(ValueError, match="bad magic"):
            fn(str(bad))
    good = save_model({"w": torch.ones(2)}, str(tmp_path / "ok.fmtpu"))
    check_model_magic(good)


def test_run_simulation_save_model_path_writes_the_jax_artifact(tmp_path):
    p0, _ = _jax_initial_params(MLP_CFG)
    jpath, tpath = tmp_path / "j.fmtpu", tmp_path / "t.fmtpu"
    rj = fedml_tpu.run_simulation(backend="tpu", save_model_path=str(jpath),
                                  **MLP_CFG)
    rt = fedml_tpu_torch.run_simulation(
        backend="gpu", device="cpu", init_params=flax_to_state_dict(p0),
        save_model_path=str(tpath), **MLP_CFG)
    # the port's artifact is the JAX package's save_model of its params
    j_save_model(jax.tree_util.tree_map(
        np.asarray, load_model(str(tpath))), str(tmp_path / "re.fmtpu"))
    assert tpath.read_bytes() == (tmp_path / "re.fmtpu").read_bytes()
    got, want = load_model(str(tpath)), load_model(str(jpath))
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    for k, v in flax_to_state_dict(got).items():
        assert torch.equal(torch.from_numpy(np.array(v)), rt["params"][k])
    np.testing.assert_allclose(
        np.asarray(jax.device_get(rj["params"]["Dense_0"]["kernel"])),
        want["Dense_0"]["kernel"])


@pytest.mark.parametrize("model", ["resnet20", "mlp"])
def test_checkpoint_predictor_matches_jax_and_serves_http(tmp_path, model):
    cfg = dict(MLP_CFG, model=model)
    if model == "resnet20":
        cfg["dataset"] = "synthetic_cifar10"
    tree, fed = _jax_initial_params(cfg)
    path = j_save_model(tree, str(tmp_path / "m.fmtpu"))
    jpred = JCheckpointPredictor.from_files(JArguments(**cfg), path, 10)
    tpred = CheckpointPredictor.from_files(
        TArguments(**cfg), path, 10, input_shape=fed.input_shape,
        device="cpu")
    x = np.random.RandomState(9).randn(
        4, *fed.input_shape).astype(np.float32)
    want = jpred.predict({"inputs": x.tolist()})
    got = tpred.predict({"inputs": x.tolist()})
    np.testing.assert_allclose(got["outputs"], want["outputs"], rtol=RTOL,
                               atol=ATOL)
    # (classes follow the logits; equal to the JAX package's except at a
    # tie of two logits within the tolerance above)
    assert got["classes"] == np.argmax(got["outputs"], -1).tolist()
    runner = FedMLInferenceRunner(tpred, port=0)
    port = runner.start()
    try:
        code, body = _post(port, "/predict", {"inputs": x[:2].tolist()})
        assert code == 200 and body["classes"] == got["classes"][:2]
    finally:
        runner.stop()


@pytest.fixture(scope="module")
def full_ft_artifact(tmp_path_factory):
    """A full fine-tune artifact (lora_rank 0: the params are the whole
    model) saved by the JAX package: its base moved by seeded noise."""
    jb, _ = j_build_bundle(JArguments(**_lm_kw()))
    rs = np.random.RandomState(1)
    tree = jax.tree_util.tree_map(
        lambda l: (np.asarray(l) + 0.02 * rs.randn(*np.shape(l))).astype(
            np.float32), jax.device_get(jb.module.init(
                jax.random.PRNGKey(3), np.zeros((1, 8), np.int32))["params"]))
    return j_save_model(tree, str(tmp_path_factory.mktemp("ft") / "lm.fmtpu"))


def _texts(pred, n=10):
    return [pred.generate(p, max_new_tokens=n) for p in PROMPTS]


@pytest.mark.parametrize("mode", ["single", "batch"])
def test_from_artifact_full_fine_tune_matches_jax(full_ft_artifact, mode):
    """The port's predictor in either mode against the JAX package's
    single mode (on a full fine-tune the two modes agree token for token;
    the JAX reference runs without its engine thread)."""
    jpred = JPredictor.from_artifact(JArguments(**_lm_kw()),
                                     full_ft_artifact)
    tpred = CausalLMPredictor.from_artifact(
        TArguments(**_lm_kw(llm_serving_mode=mode)), full_ft_artifact,
        device="cpu")
    try:
        assert tpred.mode == mode and tpred.bundle.base_params is None
        assert _texts(tpred) == _texts(jpred)
    finally:
        jpred.close()
        tpred.close()


def test_serve_chat_answers_chat_completions(full_ft_artifact):
    args = TArguments(**_lm_kw(llm_serving_mode="batch"))
    runner = serve_chat(args, full_ft_artifact, device="cpu")
    try:
        code, body = _post(runner.port, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "add 2 3"}],
            "max_tokens": 6})
        assert code == 200 and body["object"] == "chat.completion"
        assert body["usage"]["completion_tokens"] <= 6
        want = runner.predictor.generate("add 2 3", max_new_tokens=6)
        assert body["choices"][0]["message"]["content"] == want["text"]
    finally:
        runner.stop()
        runner.predictor.close()
