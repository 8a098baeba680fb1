"""Small REAL data shards bundled with the port (counterpart of
``fedml_tpu/data/bundled/``)."""
