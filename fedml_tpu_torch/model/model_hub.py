"""Model dispatch: ``fedml_tpu_torch.model.create(args, output_dim)``
(counterpart of ``fedml_tpu/model/model_hub.py``).

A :class:`ModelBundle` wraps an ``nn.Module`` with the two functions the
algorithm frame consumes: ``init`` returns the parameters as an ordered dict
of tensors (the module's ``state_dict`` names), and ``apply(params, x)`` runs
the module on those tensors through ``torch.func.functional_call``, so local
training, the FedAvg sum and the server step work on plain dicts.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
from torch import nn
from torch.func import functional_call

from ..core.algframe.types import Params


@dataclasses.dataclass
class ModelBundle:
    module: nn.Module
    name: str
    compute_dtype: torch.dtype = torch.float32

    def to(self, device: torch.device) -> "ModelBundle":
        self.module.to(device)
        return self

    def template(self) -> Dict[str, Tuple[int, ...]]:
        """Names and shapes of the trainable parameters."""
        return {k: tuple(v.shape)
                for k, v in self.module.state_dict().items()}

    def init(self, generator: torch.Generator,
             device: torch.device) -> Params:
        """Fresh parameters drawn from ``generator`` (on the CPU, so a seed
        gives the same values on every device), moved to ``device``."""
        self.module.reset_parameters(generator)
        self.module.to(device)
        return {k: v.detach().clone()
                for k, v in self.module.state_dict().items()}

    def apply(self, params: Params, x: torch.Tensor,
              train: bool = False) -> torch.Tensor:
        if self.compute_dtype != torch.float32:
            # Mixed precision, the JAX package's recipe: master params stay
            # f32 (the optimizer and the FedAvg sum run in f32); the
            # forward/backward compute path runs in the compute dtype via
            # explicit casts at the boundary. Gradients flow back through
            # the casts and land in f32 on the master params.
            dt = self.compute_dtype
            params = {k: v.to(dt) if v.dtype == torch.float32 else v
                      for k, v in params.items()}
            if x.is_floating_point():
                x = x.to(dt)
        self.module.train(train)
        out = functional_call(self.module, params, (x,))
        return out.float()


def _fused_conv_mode(args) -> str:
    """``fused_conv_block`` knob -> BasicBlock ``fused`` mode. Off (the
    default) keeps the unfused module path; true/pallas dispatches the CUDA
    kernel (its plain version for CPU tensors); reference/xla runs the same
    fused math in plain PyTorch (the kernel's numerical golden)."""
    v = getattr(args, "fused_conv_block", None)
    if v is None or v is False:
        return ""
    s = str(v).lower()
    if s in ("", "false", "0", "no", "none", "off"):
        return ""
    if s in ("true", "1", "yes", "on", "pallas"):
        return "pallas"
    if s in ("reference", "xla"):
        return "reference"
    raise ValueError(
        f"unknown fused_conv_block mode {v!r} (false|true|pallas|reference)")


def _compute_dtype(args) -> torch.dtype:
    p = str(getattr(args, "precision", "float32") or "float32").lower()
    if p in ("bf16", "bfloat16", "mixed", "mixed_bfloat16"):
        return torch.bfloat16
    if p in ("fp16", "float16", "half"):
        return torch.float16
    return torch.float32


def create(args, output_dim: int, input_shape=None) -> ModelBundle:
    """The model named by ``args.model``, with ``args.precision`` selecting
    the compute dtype of the bundle's apply path. The linear models need
    one sample's ``input_shape`` (the dataset's)."""
    name = str(getattr(args, "model", "resnet56")).lower()
    if name in ("lr", "logistic_regression", "mlp"):
        from .linear import MLP, LogisticRegression
        if input_shape is None:
            raise ValueError(f"model={name!r} needs the dataset's "
                             f"input_shape")
        cls = MLP if name == "mlp" else LogisticRegression
        module = cls(int(math.prod(input_shape)), output_dim)
    elif name.startswith("resnet"):
        from .cv.resnet import create_resnet
        module = create_resnet(name, output_dim,
                               fused=_fused_conv_mode(args))
    else:
        raise NotImplementedError(
            f"model={name!r} is not ported to fedml_tpu_torch yet "
            f"(ported: resnet20, resnet56, lr, mlp)")
    return ModelBundle(module, name, compute_dtype=_compute_dtype(args))
