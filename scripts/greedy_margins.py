"""Greedy decode margins of the full fine-tune that
``tests/test_torch_serving.py::test_full_ft_batch_matches_jax_and_port_single``
serves: for each of its prompts, the JAX reference's top-1 minus top-2
logit at each of the 10 greedy steps. A step whose margin is near the two
frameworks' float32 gap is a near-tie, where a greedy token may flip.

    PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/greedy_margins.py [--show 4]

Prints the smallest margins as (margin, prompt, step, largest |logit|).
"""

from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np

from fedml_tpu.arguments import Arguments
from fedml_tpu.llm.federated import LLMBundle, build_llm_bundle

# the test's model and prompts (``_kw``, ``PROMPTS``, ``full_art``)
MODEL = dict(dataset="llm_synthetic", model="causal_lm",
             client_num_in_total=2, client_num_per_round=2, comm_round=1,
             epochs=1, batch_size=4, learning_rate=1e-3, random_seed=3,
             llm_hidden_size=32, llm_num_layers=2, llm_num_heads=2,
             llm_intermediate_size=64, llm_max_seq_len=64, lora_rank=4,
             llm_attention_impl="dense")
PROMPTS = ["add 2 3", "echo hello world", "x",
           "subtract 19 4 and then explain"]
STEPS = 10


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--show", type=int, default=4)
    show = ap.parse_args().show
    lora, tok = build_llm_bundle(Arguments(**MODEL))
    full = LLMBundle(lora.module, lora.cfg, None, 0, lora.lora_alpha)
    rs = np.random.RandomState(1)       # the test's _perturbed(base, 1, .02)
    params = jax.tree_util.tree_map(
        lambda l: (np.asarray(l) + 0.02 * rs.randn(*np.shape(l))).astype(
            np.float32), jax.device_get(lora.base_params))
    length = full.cfg.max_seq_len
    rows = []
    for prompt in PROMPTS:
        ids = list(tok.encode(prompt))
        for step in range(STEPS):
            buf = np.zeros((1, length), np.int32)
            buf[0, :len(ids)] = ids
            logits = np.asarray(full.apply(params, jnp.asarray(buf))
                                [0, len(ids) - 1])
            top = np.sort(logits)[::-1]
            rows.append((float(top[0] - top[1]), prompt, step,
                         float(np.abs(logits).max())))
            ids.append(int(np.argmax(logits)))
    for row in sorted(rows)[:show]:
        print(row)


if __name__ == "__main__":
    main()
