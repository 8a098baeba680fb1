"""The algorithm frame: trainer specs, the local-SGD loop, datatypes."""
