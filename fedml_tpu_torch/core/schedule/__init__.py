"""Workload-aware scheduling (reference ``core/schedule/``)."""

from .seq_train_scheduler import (RuntimeEstimator, SeqTrainScheduler,
                                  balanced_schedule)

__all__ = ["SeqTrainScheduler", "RuntimeEstimator", "balanced_schedule"]
