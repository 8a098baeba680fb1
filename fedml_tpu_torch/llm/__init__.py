"""FedLLM — the LLM fine-tuning pillar (counterpart of ``fedml_tpu/llm/``),
ported for the training path:

- ``model``: Llama-style decoder (RMSNorm/rotary/SwiGLU) under the flax
  parameter names, per-op mixed precision.
- ``attention``: dense golden and flash attention through the CUDA kernels
  of ``core/kernels/flash_attention.py`` (forward B2, backward B3 + B4).
- ``lora``: adapters as a flat dict transform; federated rounds ship
  adapters only; ``lora_stack``/``lora_select`` for the serving bank.
- ``kv_cache``: the paged KV cache of the serving path (pools, gathers,
  scatters, block allocator, prefix index).
- ``trainer``: completion-only causal-LM TrainerSpec.
- ``federated``: ``build_llm`` / ``run_federated_llm`` and the adapter-bank
  export (``save_adapter_artifacts``, ``personalize_adapter``,
  ``export_silo_adapters``).
- ``hf``: local HF/Llama torch-checkpoint import.
- ``data``: byte tokenizer and instruction corpora (a copy).

The cache-aware decode path (``kv_view``, ``cached_attention``) serves
through :mod:`fedml_tpu_torch.serving`. Not ported yet: ``sharding.py``
and ring attention (multi-GPU slice).

    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.llm import run_federated_llm
    result = run_federated_llm(Arguments(
        dataset="llm", model="causal_lm", precision="bfloat16",
        client_num_in_total=2, client_num_per_round=2, comm_round=2,
        batch_size=8, learning_rate=1e-3, llm_corpus_fallback="shakespeare",
        llm_hidden_size=512, llm_intermediate_size=1408, llm_num_layers=4,
        llm_num_heads=8, llm_max_seq_len=256, lora_rank=8))
"""

from .model import CausalLM, LLMConfig, count_params, init_llm
from .lora import (lora_init, lora_merge, lora_param_count, lora_select,
                   lora_stack, lora_zero_like, make_lora_apply)
from .trainer import CausalLMTrainer
from .federated import (LLMBundle, build_llm, build_llm_bundle,
                        llm_config_from_args, run_federated_llm)

__all__ = [
    "CausalLM", "LLMConfig", "count_params", "init_llm",
    "lora_init", "lora_merge", "lora_param_count", "lora_select",
    "lora_stack", "lora_zero_like", "make_lora_apply",
    "CausalLMTrainer",
    "LLMBundle", "build_llm", "build_llm_bundle", "llm_config_from_args",
    "run_federated_llm",
]
