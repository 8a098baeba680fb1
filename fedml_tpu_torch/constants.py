"""Constants the ported slices read (counterpart of ``fedml_tpu/constants.py``,
reduced to the simulation platform and its backends)."""

FEDML_TRAINING_PLATFORM_SIMULATION = "simulation"

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
