#!/usr/bin/env python3
"""Single-mode and batch-mode serving of one checkout, alone, in this fresh
process, on one CUDA card.

    python3 scripts/serving_ab.py <checkout>

``<checkout>`` is the root of a checkout (this one, or an older commit
unpacked with ``git archive``). On the FedLLM main path's model
(``chip_smoke.LLM_MAIN_PATH``: d 512, 4 layers, bf16) with a LoRA adapter
drawn from a fixed seed, it builds that checkout's single-mode predictor
(one request at a time behind a lock, as ``chip_smoke.serving_phase``'s
sequential legs; its attention is the checkout's flash kernel, built at
first use) and serves ``chip_smoke.serve_sweep`` at c1, c8 and c64, then
its batch predictor (``chip_smoke.SERVE_BATCH``: 64 slots, blocks of 16,
prefill chunks of 32) at c8 and c64 (``bench_llm_serving``'s prompts, 24
new tokens), each sweep REPEATS times after one warm request. Prints one
JSON line: tokens/s and p99 per sweep, the card. Run two checkouts in
turns (A, B, B, A, ...) in one call to compare them on one card.
"""
import json
import os
import sys
import threading

REPEATS = 3

root = os.path.abspath(sys.argv[1])
os.chdir(root)
sys.path.insert(0, root)
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from fedml_tpu_torch.arguments import Arguments  # noqa: E402
from fedml_tpu_torch.llm import build_llm_bundle, lora_init  # noqa: E402
from fedml_tpu_torch.serving.llm_template import \
    CausalLMPredictor  # noqa: E402

bundle, tok = build_llm_bundle(Arguments(**c.LLM_MAIN_PATH))
gen = torch.Generator().manual_seed(0)
adapter = {k: 0.05 * torch.randn(v.shape, generator=gen) for k, v in
           lora_init(gen, bundle.base_params,
                     rank=c.LLM_MAIN_PATH["lora_rank"]).items()}
out = {"checkout": os.path.basename(root), "card": c.card_line()}


class Serial:
    """The single predictor behind one lock: a request at a time."""

    def __init__(self, pred):
        self.pred, self.lock = pred, threading.Lock()

    def generate(self, prompt, max_new_tokens, adapter=None):
        with self.lock:
            return self.pred.generate(prompt, max_new_tokens=max_new_tokens)


for mode, concs in (("single", c.SERVE_CONC), ("batch", (8, 64))):
    pred = CausalLMPredictor(bundle, adapter, tokenizer=tok, mode=mode,
                             batch_opts=c.SERVE_BATCH)
    target = Serial(pred) if mode == "single" else pred
    try:
        pred.generate("warm", max_new_tokens=2)
        for conc in concs:
            legs = [c.serve_sweep(target, c.SERVE_PROMPTS, conc, [None])[0]
                    for _ in range(REPEATS)]
            tag = f"{mode}_c{conc}" if mode == "single" else f"c{conc}"
            out[f"{tag}_tokens_per_s"] = [x["tokens_per_s"] for x in legs]
            out[f"{tag}_p99_s"] = [x["p99_latency_s"] for x in legs]
    finally:
        pred.close()
print(json.dumps(out), flush=True)
