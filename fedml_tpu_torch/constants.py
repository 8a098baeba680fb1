"""Constants the ported slices read (counterpart of ``fedml_tpu/constants.py``,
reduced to the simulation, cross-silo, cross-device and federated serving
platforms,
their backends and the cross-silo wire's compression names)."""

FEDML_TRAINING_PLATFORM_SIMULATION = "simulation"
FEDML_TRAINING_PLATFORM_CROSS_SILO = "cross_silo"
FEDML_TRAINING_PLATFORM_CROSS_DEVICE = "cross_device"
FEDML_TRAINING_PLATFORM_CROSS_CLOUD = "cross_cloud"
# a cross-silo session whose aggregate is then served (serving/federated.py)
FEDML_TRAINING_PLATFORM_SERVING = "fedml_serving"

# Simulation backends. The JAX package runs the round as one SPMD program on
# a TPU mesh ("tpu"); the port runs it on one CUDA device ("gpu"). SP is the
# golden single-process loop in both. Configs written for the reference's
# NCCL/MPI simulators or for the TPU mesh map to the GPU engine unchanged.
FEDML_SIMULATION_TYPE_SP = "sp"
FEDML_SIMULATION_TYPE_GPU = "gpu"
FEDML_SIMULATION_BACKEND_ALIASES = {
    "sp": FEDML_SIMULATION_TYPE_SP,
    "single_process": FEDML_SIMULATION_TYPE_SP,
    "gpu": FEDML_SIMULATION_TYPE_GPU,
    "cuda": FEDML_SIMULATION_TYPE_GPU,
    "tpu": FEDML_SIMULATION_TYPE_GPU,
    "mesh": FEDML_SIMULATION_TYPE_GPU,
    "nccl": FEDML_SIMULATION_TYPE_GPU,
    "mpi": FEDML_SIMULATION_TYPE_GPU,
}

# Cross-silo scenarios
FEDML_CROSS_SILO_SCENARIO_HORIZONTAL = "horizontal"
FEDML_CROSS_SILO_SCENARIO_HIERARCHICAL = "hierarchical"

# Wire-efficiency for cross-silo updates (``comm_compression`` knobs):
# sparsification/quantization of the client->server update with per-client
# error feedback, plus the server->client sync dtype. Off by default —
# payloads stay byte-identical to the dense float32 path.
COMM_COMPRESSION_TOPK = "topk"
COMM_COMPRESSION_RANDK = "randk"
COMM_COMPRESSION_QSGD = "qsgd"
COMM_COMPRESSION_TOPK_QSGD = "topk_qsgd"
COMM_COMPRESSION_RANDK_QSGD = "randk_qsgd"
COMM_COMPRESSION_METHODS = (
    COMM_COMPRESSION_TOPK, COMM_COMPRESSION_RANDK, COMM_COMPRESSION_QSGD,
    COMM_COMPRESSION_TOPK_QSGD, COMM_COMPRESSION_RANDK_QSGD,
)
COMM_BROADCAST_FULL = "full"          # dense float32 server->client sync
COMM_BROADCAST_BF16 = "bf16"          # dense sync at half the bytes
COMM_BROADCAST_COMPRESS = "compress"  # sync ships the compressed global delta
