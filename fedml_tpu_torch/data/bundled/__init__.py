"""Small REAL data shards bundled with the port (counterpart of
``fedml_tpu/data/bundled/``): the public-domain Shakespeare text, written
out as a LEAF split on demand, and ``sklearn_bundled.npz``, the UCI
``digits`` / ``wine`` / ``breast_cancer`` tables as scikit-learn ships them
(``scripts/export_sklearn_bundled.py`` writes it; ``data/acquire.py`` reads
it)."""

from .shakespeare import materialize_mini_shakespeare  # noqa: F401
