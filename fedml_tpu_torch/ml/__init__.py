"""Compat namespace mirroring the reference's ``fedml.ml`` layout
(counterpart of ``fedml_tpu/ml/__init__.py``): the trainer specs of
:mod:`fedml_tpu_torch.core.algframe.client_trainer` and the aggregation
operator under the reference's names."""

from ..core.algframe.client_trainer import (  # noqa: F401
    ClassificationTrainer, MultiLabelTrainer, RegressionTrainer,
    SequenceTrainer, TrainerSpec, make_trainer_spec)
from ..core.collectives import tree_weighted_average  # noqa: F401


class FedMLAggOperator:
    """Reference ``ml/aggregator/agg_operator.py:8`` shape: ``agg(args,
    raw_grad_list)`` with ``(n_k, params)`` pairs -> the weighted average
    of the params (dicts of tensors)."""

    @staticmethod
    def agg(args, raw_grad_list):
        import torch

        params = [p for _, p in raw_grad_list]
        dev = next(iter(params[0].values())).device
        weights = torch.tensor([float(n) for n, _ in raw_grad_list],
                               dtype=torch.float32, device=dev)
        stacked = {k: torch.stack([p[k] for p in params])
                   for k in params[0]}
        return tree_weighted_average(stacked, weights)
