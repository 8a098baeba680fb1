"""Federated LLM fine-tuning (counterpart of ``fedml_tpu/llm/federated.py``).

The trainable dict each silo ships is the LoRA adapter dict alone (base
weights frozen and never communicated), so a federated round aggregates
kilobytes instead of the full model. ``build_llm(args)`` wires the pieces
into the standard (fed, bundle, spec) triple the GPU simulator runs
unchanged; :func:`run_federated_llm` is the one-call entry point.

The adapter-bank export (``llm_adapter_export_dir``) writes the global
adapter and one personalised adapter per silo as named msgpack artifacts
plus a manifest (:func:`save_adapter_artifacts`), the layout the serving
adapter bank loads; the files are byte-equal to the JAX package's for the
same adapters.
"""

from __future__ import annotations

import dataclasses
import time
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
    the adapter dict as ``params``. With ``llm_adapter_export_dir`` set
    (it needs ``lora_rank > 0``, checked before the run) the global and
    per-silo personalized adapters are then exported there, as
    :func:`export_silo_adapters` does, and ``adapter_export`` holds the
    ``manifest`` path, the exported ``adapters`` and the export's
    ``wall_s``."""
    from ..core import obs
    from ..device import get_device
    from ..runner import FedMLRunner, check_ported

    device = get_device(device)  # before any work: no CUDA, no quiet CPU
    check_ported(args)            # before the corpus is built
    obs.configure(args)           # the obs_* knobs (init is bypassed here)
    export_dir = getattr(args, "llm_adapter_export_dir", None)
    if export_dir and int(getattr(args, "lora_rank", 8)) <= 0:
        # fail BEFORE the (possibly hours-long) run, not after it
        raise ValueError("llm_adapter_export_dir needs lora_rank > 0 "
                         "(the adapter bank serves adapters over a "
                         "frozen base)")
    fed, bundle, spec, _ = build_llm(args, base_params)
    runner = FedMLRunner(args, device=device, dataset=fed, model=bundle,
                         client_trainer=spec, init_params=init_params)
    result = runner.run()
    if export_dir:
        t0 = time.perf_counter()
        adapters = silo_adapters(args, fed, spec, result["params"])
        manifest = _save_silo_adapters(args, export_dir, adapters)
        result["adapter_export"] = {
            "manifest": manifest, "adapters": adapters,
            "wall_s": time.perf_counter() - t0}
    return result


# --- adapter-bank artifacts -------------------------------------------------
# The serving side of the federated-personalization loop: named LoRA
# adapters (kilobytes each) written with the msgpack artifact codec, plus a
# manifest the AdapterBank loads. One gateway then serves every silo's
# personalization side by side over a shared base model.

_MANIFEST = "manifest.json"
_FORMAT = "fedml_tpu_adapter_bank_v1"


def _safe_name(name: str) -> str:
    """An adapter name as a file name inside the export dir: anything but
    ``[A-Za-z0-9_.-]`` (a path separator included) becomes ``_``, so
    ``../escape`` is written as ``.._escape.fmtpu`` in the dir; an empty
    name is refused."""
    import re
    safe = re.sub(r"[^A-Za-z0-9_.-]", "_", str(name))
    if not safe:
        raise ValueError(f"adapter name {name!r} is empty after "
                         "sanitization")
    return safe


def save_adapter_artifacts(adapters: Dict[str, Any], out_dir: str, *,
                           lora_rank: Optional[int] = None,
                           lora_alpha: Optional[float] = None) -> str:
    """Write ``{name: adapter}`` (the port's flat adapter dicts, or nested
    trees) as one msgpack artifact per adapter plus ``manifest.json``;
    returns the manifest path. Each file is replaced atomically, the
    manifest last."""
    import json
    import os

    from ..serving import save_model

    os.makedirs(out_dir, exist_ok=True)
    manifest: Dict[str, Any] = {"format": _FORMAT, "adapters": {}}
    if lora_rank is not None:
        manifest["lora_rank"] = int(lora_rank)
    if lora_alpha is not None:
        manifest["lora_alpha"] = float(lora_alpha)
    for name, tree in adapters.items():
        fname = _safe_name(name) + ".fmtpu"
        save_model(tree, os.path.join(out_dir, fname))
        manifest["adapters"][str(name)] = fname
    path = os.path.join(out_dir, _MANIFEST)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2)
    os.replace(tmp, path)
    return path


def load_adapter_artifacts(manifest_dir: str) -> Dict[str, Any]:
    """Manifest dir -> ``{name: adapter tree}`` (nested, numpy leaves, as
    written; ``interop.flax_to_state_dict`` makes each the port's flat
    adapter). Msgpack artifacts only: the trust story of every served
    model."""
    import json
    import os

    from ..serving import load_model

    with open(os.path.join(manifest_dir, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != _FORMAT:
        raise ValueError(f"{manifest_dir}: not an adapter-bank manifest")
    return {name: load_model(os.path.join(manifest_dir, fname))
            for name, fname in manifest["adapters"].items()}


def personalize_adapter(spec, global_adapter: Params,
                        silo_data: Dict[str, torch.Tensor], *,
                        learning_rate: float = 1e-3,
                        steps: int = 4) -> Params:
    """A few plain SGD steps from the global adapter over one silo's
    batches (``silo_data``: ``{"x": [nb, bs, L], "y", "mask"}`` tensors on
    the adapter's device; ``steps`` batches, cycled): the cheap per-silo
    personalization pass whose output the adapter bank serves. Eager
    steps: on the card each runs B2 forward and B3 + B4 backward once per
    layer."""
    params = {k: v.detach() for k, v in global_adapter.items()}
    n_batches = int(silo_data["x"].shape[0])
    for s in range(int(steps)):
        j = s % n_batches
        batch = {k: silo_data[k][j] for k in ("x", "y", "mask")}
        leaves = {k: v.requires_grad_() for k, v in params.items()}
        loss, _ = spec.loss(leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            params = {k: v - learning_rate * g
                      for (k, v), g in zip(leaves.items(), grads)}
    return params


def export_silo_adapters(args, out_dir: str, result: Optional[dict] = None,
                         prebuilt=None, device=None) -> str:
    """Federated LoRA -> a served adapter bank: run (or reuse) the
    federated fine-tune, personalize the global adapter per silo
    (:func:`silo_adapters`) and write ``global`` + ``silo_<i>`` named
    artifacts. ``prebuilt`` is the run's ``(fed, bundle, spec)`` (else
    built from ``args``, the base from ``random_seed``). Returns the
    manifest path."""
    from ..device import get_device
    if int(getattr(args, "lora_rank", 8)) <= 0:
        raise ValueError("adapter export needs lora_rank > 0 (the bank "
                         "serves adapters over a frozen base)")
    if prebuilt is not None:
        fed, bundle, spec = prebuilt
    else:
        fed, bundle, spec, _ = build_llm(args)
    if result is None:
        from ..runner import FedMLRunner
        result = FedMLRunner(args, device=get_device(device), dataset=fed,
                             model=bundle, client_trainer=spec).run()
    bundle.to(next(iter(result["params"].values())).device)
    return _save_silo_adapters(
        args, out_dir, silo_adapters(args, fed, spec, result["params"]))


def silo_adapters(args, fed, spec, global_adapter: Params
                  ) -> Dict[str, Params]:
    """``global`` and ``silo_<i>``: the global adapter personalized with
    ``llm_adapter_personalize_steps`` SGD steps on silo i's shard, on the
    global adapter's device."""
    dev = next(iter(global_adapter.values())).device
    adapters = {"global": global_adapter}
    steps = int(getattr(args, "llm_adapter_personalize_steps", 4))
    for i in range(fed.num_clients):
        silo = {k: torch.from_numpy(np.ascontiguousarray(
            getattr(fed.train, k)[i])).to(dev) for k in ("x", "y", "mask")}
        adapters[f"silo_{i}"] = personalize_adapter(
            spec, global_adapter, silo,
            learning_rate=float(getattr(args, "learning_rate", 1e-3)),
            steps=steps)
    return adapters


def _save_silo_adapters(args, out_dir: str,
                        adapters: Dict[str, Params]) -> str:
    return save_adapter_artifacts(
        adapters, out_dir,
        lora_rank=int(getattr(args, "lora_rank", 8)),
        lora_alpha=float(getattr(args, "lora_alpha", 16.0)))
