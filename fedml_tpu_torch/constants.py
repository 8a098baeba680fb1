"""Constants the ported slice reads (counterpart of ``fedml_tpu/constants.py``,
reduced to the simulation platform and its backends)."""

FEDML_TRAINING_PLATFORM_SIMULATION = "simulation"

# Simulation backends. The JAX package runs the round as one SPMD program on
# a TPU mesh ("tpu"); the port runs it on one CUDA device ("gpu"). Configs
# written for the reference's NCCL/MPI simulators or for the TPU mesh map to
# the GPU engine unchanged.
FEDML_SIMULATION_TYPE_GPU = "gpu"
FEDML_SIMULATION_BACKEND_ALIASES = {
    "gpu": FEDML_SIMULATION_TYPE_GPU,
    "cuda": FEDML_SIMULATION_TYPE_GPU,
    "tpu": FEDML_SIMULATION_TYPE_GPU,
    "mesh": FEDML_SIMULATION_TYPE_GPU,
    "nccl": FEDML_SIMULATION_TYPE_GPU,
    "mpi": FEDML_SIMULATION_TYPE_GPU,
}
