"""fedml_tpu_torch — the PyTorch/CUDA port of ``fedml_tpu``.

The JAX package ``fedml_tpu`` stays the reference; this package runs the same
federated round on an NVIDIA H100, with the JAX package's Pallas kernels
rewritten by hand for Hopper. Ported so far: the FedAvg simulation round on
the CIFAR ResNets, with the fused conv block as a CUDA kernel
(``core/kernels/csrc/conv_block.cu``), and the federated LoRA fine-tune of
the causal LM (:mod:`fedml_tpu_torch.llm`), with flash attention's forward
and backward as CUDA kernels (``core/kernels/csrc/flash_attention.cu``),
and continuous-batching serving of the LM and its adapters
(:mod:`fedml_tpu_torch.serving`: paged KV cache, decode scheduler,
batching engine, multi-LoRA adapter bank, HTTP runner).
Modules follow the JAX package's paths. Nothing here imports JAX or
``fedml_tpu``.

    import fedml_tpu_torch as fedml
    result = fedml.run_simulation(dataset="synthetic_cifar10",
                                  model="resnet56", fused_conv_block="pallas")
    from fedml_tpu_torch.llm import run_federated_llm
    result = run_federated_llm(fedml.Arguments(dataset="llm",
                                               model="causal_lm"))

Entry points run on CUDA; ``device="cpu"`` runs the plain PyTorch path on
the CPU, as the parity tests do. Without CUDA and without ``device="cpu"``
they raise.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .arguments import Arguments, add_args, load_arguments
from .constants import FEDML_TRAINING_PLATFORM_SIMULATION
from .runner import FedMLRunner

__version__ = "0.1.0"


def init(args: Optional[Arguments] = None, **overrides: Any) -> Arguments:
    """Parse config: with no ``args``, reads ``--cf <yaml>`` from the CLI if
    present; keyword overrides always win."""
    if args is None:
        cli = add_args()
        merged = dict(rank=cli.rank, role=cli.role, run_id=cli.run_id)
        merged.update(overrides)
        args = load_arguments(cli.yaml_config_file, **merged)
    else:
        for k, v in overrides.items():
            setattr(args, k, v)
        args._finalize()
    return args


def run_simulation(backend: str = "gpu", args: Optional[Arguments] = None,
                   device=None, init_params: Optional[Dict[str, Any]] = None,
                   **overrides: Any) -> Dict[str, Any]:
    """One-call FedAvg simulation on ``device`` (CUDA unless ``"cpu"``).

    ``init_params`` (optional) starts from given parameters, a state dict
    under the model's names (see :mod:`fedml_tpu_torch.interop` to bring
    them from a flax tree), instead of a fresh seeded init. Returns
    ``params``, ``history``, ``wall_time_s``, ``final_test_acc``,
    ``final_test_loss`` and ``rounds``, as the JAX engine does."""
    from . import data as data_mod
    from . import model as model_mod
    from .device import get_device

    device = get_device(device)  # before any work: no CUDA, no quiet CPU
    args = init(args, backend=backend, **overrides)
    args.training_type = FEDML_TRAINING_PLATFORM_SIMULATION
    fed, output_dim = data_mod.load(args)
    bundle = model_mod.create(args, output_dim)
    runner = FedMLRunner(args, device=device, dataset=fed, model=bundle,
                         init_params=init_params)
    return runner.run()
