"""Continuous-batching LLM serving (counterpart of
``fedml_tpu/serving/batch/``).

Iteration-level scheduling (Orca, Yu et al. OSDI'22) + batched
multi-adapter serving over one resident base model (S-LoRA, Sheng et al.
2023): one decode step over a fixed-shape slot matrix ``[S]`` where slot
occupancy, positions, block tables and adapter indices are all data.

* :class:`~.scheduler.DecodeScheduler` — the synchronous core: paged KV
  cache (``llm/kv_cache.py``), chunked prefill, per-step admit/evict.
* :class:`~.adapter_bank.AdapterBank` — named LoRA adapters stacked into
  a resident ``[A, ...]`` dict; per-slot selection is a batched gather
  inside the step.
* :class:`~.engine.BatchingEngine` — threaded request queue with
  per-request futures and deadline-based eviction, feeding the scheduler.
"""

from .adapter_bank import AdapterBank
from .engine import BatchingEngine
from .scheduler import DecodeScheduler

__all__ = ["AdapterBank", "BatchingEngine", "DecodeScheduler"]
