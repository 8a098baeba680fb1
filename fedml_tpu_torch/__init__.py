"""fedml_tpu_torch — the PyTorch/CUDA port of ``fedml_tpu``.

The JAX package ``fedml_tpu`` stays the reference; this package runs the same
federated round on an NVIDIA H100, with the JAX package's Pallas kernels
rewritten by hand for Hopper. Ported so far: the FedAvg simulation round on
the CIFAR ResNets and the linear models, through the GPU engine (blocks of
rounds over a local step captured in a CUDA graph) or the SP golden loop,
with the fused conv block as a CUDA kernel
(``core/kernels/csrc/conv_block.cu``), and the federated LoRA fine-tune of
the causal LM (:mod:`fedml_tpu_torch.llm`), with flash attention's forward
and backward as CUDA kernels (``core/kernels/csrc/flash_attention.cu``),
and continuous-batching serving of the LM and its adapters
(:mod:`fedml_tpu_torch.serving`: paged KV cache, decode scheduler,
batching engine, multi-LoRA adapter bank, HTTP runner). Around the
simulated round: differential privacy, attacks and defenses, chaos
(dropout, stragglers, crash-at-round), participant selection,
contribution assessment and a user ``ServerAggregator``; buffered-async
rounds (``round_mode: async_buffered`` on the GPU engine, with defended
pours, and the SP ``federated_optimizer: Async_FedAvg`` loop). The
cross-silo runtime (:mod:`fedml_tpu_torch.cross_silo`): the horizontal
FedAvg server and silos over the in-proc, TCP and gRPC transports, with
retries, link-fault injection, wire compression byte-compatible with the
JAX package's, and the record plane (:mod:`fedml_tpu_torch.core.mlops`).
Modules follow the JAX package's paths. Nothing here imports JAX or
``fedml_tpu``.

    import fedml_tpu_torch as fedml
    result = fedml.run_simulation(dataset="synthetic_cifar10",
                                  model="resnet56", fused_conv_block="pallas")
    result = fedml.run_simulation(round_mode="async_buffered",
                                  async_buffer_k=4)  # synthetic_mnist / lr
    from fedml_tpu_torch.llm import run_federated_llm
    result = run_federated_llm(fedml.Arguments(dataset="llm",
                                               model="causal_lm"))
    # cross-silo: one server process and N silo processes
    fedml.run_cross_silo_server(backend="TCP", client_num_per_round=4)
    fedml.run_cross_silo_client(backend="TCP", rank=1,
                                client_num_per_round=4)

Entry points run on CUDA; ``device="cpu"`` runs the plain PyTorch path on
the CPU, as the parity tests do. Without CUDA and without ``device="cpu"``
they raise.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .arguments import Arguments, add_args, load_arguments
from .constants import (FEDML_TRAINING_PLATFORM_CROSS_SILO,
                        FEDML_TRAINING_PLATFORM_SIMULATION)
from .runner import FedMLRunner

__version__ = "0.1.0"


def init(args: Optional[Arguments] = None, device=None,
         **overrides: Any) -> Arguments:
    """Parse config: with no ``args``, reads ``--cf <yaml>`` from the CLI if
    present; keyword overrides always win. Wires the record plane
    (:func:`fedml_tpu_torch.core.mlops.init`: the run's JSONL file under
    ``log_file_dir`` unless ``enable_tracking`` is off, and the ``obs_*``
    knobs), as the JAX package's ``init`` does; ``device`` is the run's
    device, which the system sampler reads."""
    from .core import mlops
    if args is None:
        cli = add_args()
        merged = dict(rank=cli.rank, role=cli.role, run_id=cli.run_id)
        merged.update(overrides)
        args = load_arguments(cli.yaml_config_file, **merged)
    else:
        for k, v in overrides.items():
            setattr(args, k, v)
        args._finalize()
    mlops.init(args, device=device)
    return args


def run_simulation(backend: str = "gpu", args: Optional[Arguments] = None,
                   device=None, init_params: Optional[Dict[str, Any]] = None,
                   server_aggregator=None,
                   **overrides: Any) -> Dict[str, Any]:
    """One-call FedAvg simulation on ``device`` (CUDA unless ``"cpu"``):
    ``backend="gpu"`` (aliases ``cuda``, ``tpu``, ``mesh``, ``nccl``,
    ``mpi``) runs the GPU engine, rounds in blocks of
    ``rounds_per_dispatch`` over a captured local step; ``backend="sp"``
    the eager golden loop. ``round_mode="async_buffered"`` runs the GPU
    engine's buffered-async pours (``comm_round`` counts pours; the
    result adds ``virtual_time_s`` and ``updates_aggregated``);
    ``federated_optimizer="Async_FedAvg"`` the SP loop's
    staleness-weighted merges. With neither ``dataset`` nor ``model``
    given it trains ``synthetic_mnist`` / ``lr``, as the JAX package
    does.

    ``init_params`` (optional) starts from given parameters, a state dict
    under the model's names (see :mod:`fedml_tpu_torch.interop` to bring
    them from a flax tree), instead of a fresh seeded init. Returns
    ``params``, ``history``, ``wall_time_s``, ``final_test_acc``,
    ``final_test_loss`` and ``rounds``, as the JAX engine does (the GPU
    engine adds its ``dispatch_stats``; under DP both add
    ``dp_epsilon_spent``). ``save_model_path`` writes the
    final params there as a serving artifact (the JAX package's bytes);
    ``checkpoint_dir`` / ``checkpoint_every_rounds`` checkpoint the rounds
    and resume from the newest checkpoint. ``server_aggregator`` (a
    :class:`~fedml_tpu_torch.core.algframe.server_aggregator.ServerAggregator`)
    aggregates the GPU engine's rounds through its hooks."""
    from . import data as data_mod
    from . import model as model_mod
    from .device import get_device

    device = get_device(device)  # before any work: no CUDA, no quiet CPU
    args = init(args, device=device, backend=backend, **overrides)
    args.training_type = FEDML_TRAINING_PLATFORM_SIMULATION
    fed, output_dim = data_mod.load(args)
    bundle = model_mod.create(args, output_dim, fed.input_shape)
    runner = FedMLRunner(args, device=device, dataset=fed, model=bundle,
                         server_aggregator=server_aggregator,
                         init_params=init_params)
    result = runner.run()
    save_path = getattr(args, "save_model_path", None)
    if save_path:
        import os

        from .serving import save_model
        save_model(result["params"], os.path.expanduser(str(save_path)))
    return result


def cross_silo_runner(role: str, args: Optional[Arguments] = None,
                      device=None,
                      init_params: Optional[Dict[str, Any]] = None,
                      **overrides: Any) -> FedMLRunner:
    """The cross-silo party ``role`` (``"server"`` or ``"client"``) of
    ``args`` and ``overrides`` on ``device``, built and not yet run
    (``run()`` blocks until the session ends; its manager, e.g. a silo's
    trainer, stays inspectable afterwards)."""
    from . import data as data_mod
    from . import model as model_mod
    from .device import get_device

    device = get_device(device)  # before any work: no CUDA, no quiet CPU
    args = init(args, device=device, **overrides)
    args.training_type = FEDML_TRAINING_PLATFORM_CROSS_SILO
    args.role = role
    fed, output_dim = data_mod.load(args)
    bundle = model_mod.create(args, output_dim, fed.input_shape)
    return FedMLRunner(args, device=device, dataset=fed, model=bundle,
                       init_params=init_params)


def run_cross_silo_server(args: Optional[Arguments] = None, device=None,
                          init_params: Optional[Dict[str, Any]] = None,
                          **overrides: Any) -> Optional[Dict[str, Any]]:
    """Run the cross-silo server (rank 0) of a horizontal FedAvg session
    on ``device`` (CUDA unless ``"cpu"``) until the session ends; the
    silos are :func:`run_cross_silo_client` processes (or threads) on the
    same ``backend`` (``TCP`` or ``GRPC``; unset, or any value that names
    no transport, means GRPC as in the JAX package; ``INPROC`` needs
    ``args.inproc_broker``). ``init_params`` (a state dict) replaces the
    seeded init. Returns ``params``, ``history``, ``final_test_acc`` and
    ``rounds``, and the server's ``round_times`` and ``eval_batches``."""
    return cross_silo_runner("server", args, device, init_params,
                             **overrides).run()


def run_cross_silo_client(args: Optional[Arguments] = None, device=None,
                          **overrides: Any) -> None:
    """Run silo ``rank`` (1..``client_num_per_round``) of a horizontal
    FedAvg session on ``device`` (CUDA unless ``"cpu"``) until the server
    finishes the session."""
    return cross_silo_runner("client", args, device, **overrides).run()
