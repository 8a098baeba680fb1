"""Model dispatch: ``fedml_tpu_torch.model.create(args, output_dim)``
(counterpart of ``fedml_tpu/model/model_hub.py``).

A :class:`ModelBundle` wraps an ``nn.Module`` with the two functions the
algorithm frame consumes: ``init`` returns the parameters as an ordered dict
of tensors (the module's ``state_dict`` names), and ``apply(params, x,
rng=, train=)`` runs the module on those tensors through
``torch.func.functional_call``, so local training, the FedAvg sum and the
server step work on plain dicts. A model with dropout
(:attr:`ModelBundle.has_dropout`) takes the training step's dropout key,
an int64 ``[2]`` tensor (:mod:`fedml_tpu_torch.prng`), as its forward's
``rng``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

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
        gives the same values on every device), moved to ``device``. The
        module is brought to the CPU first: a copy of a bundle that an
        earlier ``init`` moved to the card draws there too."""
        self.module.to("cpu")
        self.module.reset_parameters(generator)
        self.module.to(device)
        return {k: v.detach().clone()
                for k, v in self.module.state_dict().items()}

    @property
    def has_dropout(self) -> bool:
        """The JAX package's ``_has_dropout``: the model draws dropout
        masks in training, from the key ``apply`` is given."""
        return bool(getattr(self.module, "has_dropout", False))

    def apply(self, params: Params, x: torch.Tensor,
              rng: Optional[torch.Tensor] = None,
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
        kwargs = ({"rng": rng} if rng is not None and self.has_dropout
                  else {})
        out = functional_call(self.module, params, (x,), kwargs)
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


def create(args, output_dim: int, input_shape=None):
    """The model named by ``args.model``, with ``args.precision`` selecting
    the compute dtype of the bundle's apply path: a :class:`ModelBundle`,
    or for ``gan`` / ``mnist_gan`` the ``(generator, discriminator)``
    bundle pair FedGAN trains (each at that dtype). ``input_shape`` is one
    sample's shape (the dataset's): the linear, finance and GAN models,
    the CNNs, LeNet, VGG and ResNet-18 size their layers from it, the
    MobileNet and EfficientNet stems their input channels."""
    name = str(getattr(args, "model", "lr")).lower()
    shape = tuple(input_shape) if input_shape is not None else None
    dt = _compute_dtype(args)

    def need_shape():
        if shape is None:
            raise ValueError(f"model={name!r} needs the dataset's "
                             f"input_shape")
        return shape

    if name in ("lr", "logistic_regression", "mlp"):
        from .linear import MLP, LogisticRegression
        cls = MLP if name == "mlp" else LogisticRegression
        module = cls(int(math.prod(need_shape())), output_dim)
    elif name in ("cnn", "cnn_dropout", "femnist_cnn"):
        from .cv.cnn import CNNFemnist
        module = CNNFemnist(output_dim, input_shape=need_shape())
    elif name in ("device_cnn", "mobile_cnn"):
        from .cv.cnn import DeviceCNN
        module = DeviceCNN(output_dim, input_shape=need_shape())
    elif name in ("simple_cnn", "cifar_cnn"):
        from .cv.cnn import SimpleCNN
        module = SimpleCNN(output_dim, input_shape=need_shape())
    elif name.startswith("resnet"):
        from .cv.resnet import create_resnet
        module = create_resnet(
            name, output_dim, fused=_fused_conv_mode(args),
            input_shape=need_shape() if name.startswith("resnet18")
            else (32, 32, 3))
    elif name in ("rnn", "lstm", "rnn_shakespeare", "stacked_lstm"):
        from .nlp.rnn import RNNShakespeare, RNNStackOverflow
        dataset = str(getattr(args, "dataset", "")).lower()
        cls = (RNNStackOverflow if "stackoverflow" in dataset
               else RNNShakespeare)
        module = cls(vocab_size=output_dim)
    elif name in ("lenet", "lenet5", "mnn_lenet"):
        from .cv.lenet import LeNet5
        module = LeNet5(output_dim, input_shape=need_shape())
    elif name in ("vfl_feature_extractor", "local_model"):
        from .finance import VFLFeatureExtractor
        module = VFLFeatureExtractor(int(math.prod(need_shape())),
                                     out_dim=output_dim)
    elif name in ("vfl_classifier", "dense_model"):
        from .finance import VFLClassifier
        module = VFLClassifier(int(math.prod(need_shape())), output_dim)
    elif name in ("lending_club_mlp", "finance_mlp"):
        from .finance import LendingClubMLP
        module = LendingClubMLP(int(math.prod(need_shape())), output_dim)
    elif name.startswith("mobilenet"):
        from .cv.mobilenet import MobileNetV3Small
        module = MobileNetV3Small(output_dim, input_shape=need_shape())
    elif name.startswith("efficientnet"):
        from .cv.efficientnet import create_efficientnet
        module = create_efficientnet(name, output_dim,
                                     input_shape=need_shape())
    elif name.startswith("vgg"):
        from .cv.vgg import create_vgg
        module = create_vgg(name, output_dim, input_shape=need_shape())
    elif name in ("gan", "mnist_gan"):
        from .cv.gan import Discriminator, Generator
        img_dim = int(math.prod(shape)) if shape is not None else 784
        return (ModelBundle(Generator(), "generator", compute_dtype=dt),
                ModelBundle(Discriminator(img_dim), "discriminator",
                            compute_dtype=dt))
    else:
        raise ValueError(f"unknown model {name!r} (the zoo: "
                         f"{PORTED_MODELS})")
    return ModelBundle(module, name, compute_dtype=dt)


PORTED_MODELS = ("resnet20, resnet56, resnet18, lr, mlp, cnn (dropout), "
                 "simple_cnn, device_cnn, rnn (Shakespeare / StackOverflow "
                 "LSTM), lenet, vgg11 / vgg16 (dropout), mobilenet, "
                 "efficientnet-b0 / b1 / b2 (dropout), gan (the generator "
                 "and discriminator pair), vfl_feature_extractor, "
                 "vfl_classifier, lending_club_mlp")
