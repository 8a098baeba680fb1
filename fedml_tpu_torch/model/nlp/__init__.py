"""NLP models: the federated RNNs."""
