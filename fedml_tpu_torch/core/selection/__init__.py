"""Adaptive participant selection & client reputation (copies of
``fedml_tpu/core/selection``; the manager reads its queue back from torch
tensors).

Turns the signals the framework already produces — per-round losses,
observed work fractions and dropouts (chaos ledger), cross-silo upload
latencies, defense exclusion verdicts — into *who trains next round*:

* :class:`ClientStatsStore` — per-client EMA latency/work, Beta-posterior
  dropout estimate, last-K losses, defense-decayed reputation; NumPy
  state that rides :class:`~fedml_tpu_torch.core.checkpoint.RoundCheckpointer`.
* :class:`SparseClientStatsStore` — the million-client backend: the same
  observation/query API over *touched-client* columnar state, selected
  by the ``selection_store`` knob (``auto`` flips at
  ``selection_sparse_threshold``); posteriors bit-identical to dense.
* strategies behind the ``client_selection`` knob: ``uniform`` (default,
  bit-identical schedules), ``power_of_choice``, ``oort``,
  ``reputation`` (low-reputation clients become renormalized in-program
  dropout — the byzantine-aware-dropout closer). Above
  ``selection_pool_threshold`` clients they score a seeded candidate
  pool of ``m ≫ k`` ids with ``np.argpartition`` partial top-k —
  O(m + k log k), never O(N log N).
* :mod:`~fedml_tpu_torch.core.selection.cohort` — the cross-device round's
  front door: handshake eligibility predicates, a streaming chunked
  top-k assembler, and Oort's deadline-driven :class:`DeadlinePacer`.
* :class:`SelectionManager` — the engine/server seam: lazy device-array
  observation queue, adaptive over-sampling from the dropout posterior.

Selection is host-side policy; cohorts ride the jitted round programs
purely as schedule DATA, so the canonical slot width and the compile-once
invariant hold for every strategy.
"""

from .cohort import (DeadlinePacer, StreamingCohortAssembler, eligible_mask,
                     population_chunks, required_eligibility)
from .manager import (STORE_BACKENDS, SelectionManager, make_stats_store,
                      slot_placement)
from .sparse import SparseClientStatsStore
from .stats import ClientStatsStore
from .strategies import (SELECTION_STRATEGIES, OortSelection,
                         PowerOfChoiceSelection, ReputationSelection,
                         SelectionStrategy, UniformSelection, cap_bench,
                         create_strategy, partial_top_k, pool_size)

__all__ = ["ClientStatsStore", "SparseClientStatsStore", "SelectionManager",
           "SelectionStrategy", "UniformSelection",
           "PowerOfChoiceSelection", "OortSelection", "ReputationSelection",
           "SELECTION_STRATEGIES", "STORE_BACKENDS",
           "cap_bench", "create_strategy", "slot_placement",
           "make_stats_store", "partial_top_k", "pool_size",
           "DeadlinePacer", "StreamingCohortAssembler", "eligible_mask",
           "population_chunks", "required_eligibility"]
