"""Federated LLM fine-tuning (counterpart of ``fedml_tpu/llm/federated.py``).

The trainable dict each silo ships is the LoRA adapter dict alone (base
weights frozen and never communicated), so a federated round aggregates
kilobytes instead of the full model. ``build_llm(args)`` wires the pieces
into the standard (fed, bundle, spec) triple the GPU simulator runs
unchanged; :func:`run_federated_llm` is the one-call entry point.

The adapter-bank export (``llm_adapter_export_dir``) needs the msgpack
artifact codec of the serving slice and is not ported yet; like ring
attention, it raises (``runner.UNPORTED_KNOBS``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from .data import ByteTokenizer, build_llm_federated
from .lora import lora_init, lora_merge, lora_shapes
from .model import CausalLM, LLMConfig
from .trainer import CausalLMTrainer

Params = Dict[str, torch.Tensor]


def llm_config_from_args(args) -> LLMConfig:
    """Map the flat config namespace onto LLMConfig. The default attention
    is ``flash``: the CUDA kernels on the card, their plain versions on
    CPU tensors."""
    precision = str(getattr(args, "precision", "float32")).lower()
    dtype = "bfloat16" if precision in ("bf16", "bfloat16") else "float32"
    return LLMConfig(
        vocab_size=int(getattr(args, "llm_vocab_size",
                               ByteTokenizer.vocab_size)),
        hidden_size=int(getattr(args, "llm_hidden_size", 128)),
        intermediate_size=int(getattr(args, "llm_intermediate_size", 352)),
        num_layers=int(getattr(args, "llm_num_layers", 2)),
        num_heads=int(getattr(args, "llm_num_heads", 4)),
        num_kv_heads=getattr(args, "llm_num_kv_heads", None),
        max_seq_len=int(getattr(args, "llm_max_seq_len", 128)),
        dtype=dtype,
        attention_impl=str(getattr(args, "llm_attention_impl", None)
                           or "flash"),
    )


def _as_tensor(v) -> torch.Tensor:
    return v.detach() if torch.is_tensor(v) else torch.tensor(
        np.asarray(v))


@dataclasses.dataclass
class LLMBundle:
    """ModelBundle-compatible wrapper whose trainable dict is the LoRA
    adapter dict (or the full params when ``lora_rank == 0``). The frozen
    base parameters are the module's own."""

    module: CausalLM
    cfg: LLMConfig
    lora_rank: int
    lora_alpha: float
    name: str = "causal_lm"

    @property
    def base_params(self) -> Optional[Params]:
        """The frozen base (None = full fine-tune)."""
        if self.lora_rank <= 0:
            return None
        return {k: v.detach() for k, v in self.module.state_dict().items()}

    def to(self, device: torch.device) -> "LLMBundle":
        self.module.to(device)
        return self

    def template(self) -> Dict[str, Tuple[int, ...]]:
        """Names and shapes of the trainable parameters."""
        sd = self.module.state_dict()
        if self.lora_rank <= 0:
            return {k: tuple(v.shape) for k, v in sd.items()}
        return lora_shapes(sd, self.lora_rank)

    def init(self, generator: torch.Generator,
             device: torch.device) -> Params:
        self.to(device)
        if self.lora_rank > 0:
            return lora_init(generator, self.base_params, rank=self.lora_rank)
        return {k: v.detach().clone()
                for k, v in self.module.state_dict().items()}

    def apply(self, params: Params, x: torch.Tensor,
              train: bool = False) -> torch.Tensor:
        if self.lora_rank > 0:
            params = lora_merge(self.base_params, params, self.lora_alpha)
        return functional_call(self.module, params, (x,),
                               {"train": train})


def build_llm_bundle(args, base_params: Optional[Dict[str, Any]] = None
                     ) -> Tuple[LLMBundle, ByteTokenizer]:
    """Model-only build. The base weights are ``base_params`` (a flat dict
    under the flax names, e.g. from :func:`fedml_tpu_torch.interop.
    flax_to_state_dict`) or drawn from a generator seeded by
    ``random_seed``."""
    cfg = llm_config_from_args(args)
    module = CausalLM(cfg)
    if base_params is None:
        module.reset_parameters(torch.Generator().manual_seed(
            int(getattr(args, "random_seed", 0))))
    else:
        want = module.state_dict()
        if set(base_params) != set(want):
            raise ValueError(
                f"base_params keys differ from the model's: missing "
                f"{sorted(set(want) - set(base_params))}, unexpected "
                f"{sorted(set(base_params) - set(want))}")
        module.load_state_dict({k: _as_tensor(v).float()
                                for k, v in base_params.items()})
    rank = int(getattr(args, "lora_rank", 8))
    alpha = float(getattr(args, "lora_alpha", 16.0))
    return LLMBundle(module, cfg, rank, alpha), ByteTokenizer()


def build_llm(args, base_params: Optional[Dict[str, Any]] = None
              ) -> Tuple[Any, LLMBundle, CausalLMTrainer, ByteTokenizer]:
    """-> (fed_dataset, bundle, trainer_spec, tokenizer)."""
    bundle, _ = build_llm_bundle(args, base_params)
    n_silos = int(getattr(args, "client_num_in_total", 2))
    fed, tokenizer = build_llm_federated(args, n_silos,
                                         bundle.cfg.max_seq_len)
    return fed, bundle, CausalLMTrainer(bundle.apply), tokenizer


def run_federated_llm(args, device=None,
                      base_params: Optional[Dict[str, Any]] = None,
                      init_params: Optional[Dict[str, Any]] = None) -> dict:
    """Run a federated LoRA fine-tune on ``device`` (CUDA unless
    ``"cpu"``; raises without CUDA) through the GPU simulator.
    ``base_params`` / ``init_params`` (optional) give the frozen base
    weights and the starting adapters (flat dicts under the flax names)
    instead of seeded draws. Returns what ``run_simulation`` returns, with
    the adapter dict as ``params``."""
    from ..device import get_device
    from ..runner import FedMLRunner, check_ported

    device = get_device(device)  # before any work: no CUDA, no quiet CPU
    check_ported(args)            # before the corpus is built
    fed, bundle, spec, _ = build_llm(args, base_params)
    runner = FedMLRunner(args, device=device, dataset=fed, model=bundle,
                         client_trainer=spec, init_params=init_params)
    return runner.run()
