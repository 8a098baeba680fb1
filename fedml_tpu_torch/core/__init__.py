"""Core building blocks of the port: data partitioning, kernels and the
algorithm frame."""
