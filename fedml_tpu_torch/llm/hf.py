"""Import HF/torch Llama checkpoints into the port's CausalLM (counterpart of
``fedml_tpu/llm/hf.py``).

The importer consumes a local checkpoint: a torch state dict
(``pytorch_model.bin`` / ``.pt``) or a directory holding one, with
Llama-style parameter naming (``model.layers.N.self_attn.q_proj.weight``).
``torch.nn.Linear`` stores weights ``[out, in]``; the port's kernels keep
flax's ``[in, out]`` (and ``[in, heads, head_dim]`` for the attention
projections), so the transpose and reshape happen here, once.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

from .model import LLMConfig

Params = Dict[str, torch.Tensor]


def _to_tensor(t) -> torch.Tensor:
    if torch.is_tensor(t):
        return t.detach().cpu().float()
    return torch.as_tensor(np.asarray(t, np.float32))


def load_torch_state_dict(path: str) -> Mapping[str, Any]:
    if os.path.isdir(path):
        for name in ("pytorch_model.bin", "model.pt", "checkpoint.pt"):
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                path = cand
                break
        else:
            raise FileNotFoundError(
                f"no torch checkpoint (pytorch_model.bin / model.pt) in {path}")
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return state


def convert_llama_state_dict(state: Mapping[str, Any],
                             cfg: LLMConfig) -> Params:
    """Llama-naming torch state dict -> the port's flat parameter dict
    (f32, under the flax names)."""
    h, nh, kvh, hd = (cfg.hidden_size, cfg.num_heads, cfg.kv_heads,
                      cfg.head_dim)

    def lin(key: str) -> torch.Tensor:          # [out, in] -> [in, out]
        return _to_tensor(state[key]).t().contiguous()

    params: Params = {
        "embed.embedding": _to_tensor(state["model.embed_tokens.weight"]),
        "ln_f.scale": _to_tensor(state["model.norm.weight"]),
    }
    if cfg.tie_embeddings and "lm_head.weight" in state:
        head = _to_tensor(state["lm_head.weight"])
        if not torch.allclose(head, params["embed.embedding"], atol=1e-6):
            raise ValueError(
                "checkpoint has an untied lm_head but cfg.tie_embeddings "
                "is True — importing would silently drop the head; set "
                "tie_embeddings=False on the LLMConfig")
    if not cfg.tie_embeddings and "lm_head.weight" in state:
        params["lm_head.kernel"] = lin("lm_head.weight")
    for i in range(cfg.num_layers):
        p, o = f"model.layers.{i}.", f"layer_{i}."
        params.update({
            o + "ln_attn.scale": _to_tensor(state[p + "input_layernorm.weight"]),
            o + "ln_mlp.scale": _to_tensor(
                state[p + "post_attention_layernorm.weight"]),
            o + "attn.q.kernel": lin(p + "self_attn.q_proj.weight").reshape(
                h, nh, hd),
            o + "attn.k.kernel": lin(p + "self_attn.k_proj.weight").reshape(
                h, kvh, hd),
            o + "attn.v.kernel": lin(p + "self_attn.v_proj.weight").reshape(
                h, kvh, hd),
            o + "attn.o.kernel": lin(p + "self_attn.o_proj.weight"),
            o + "mlp.gate.kernel": lin(p + "mlp.gate_proj.weight"),
            o + "mlp.up.kernel": lin(p + "mlp.up_proj.weight"),
            o + "mlp.down.kernel": lin(p + "mlp.down_proj.weight"),
        })
    return params


def load_hf_llama(path: str, cfg: LLMConfig) -> Params:
    """Local HF-Llama checkpoint -> parameters ready for ``CausalLM`` (pass
    them as ``base_params=`` to ``build_llm`` / ``run_federated_llm``, or
    load them into ``CausalLM(cfg)``)."""
    return convert_llama_state_dict(load_torch_state_dict(path), cfg)
