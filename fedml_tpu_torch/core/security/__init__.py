"""Trust and robustness (counterpart of ``fedml_tpu/core/security/``): the
attack zoo and the defense dispatch. The simulators consult
``FedMLAttacker`` / ``FedMLDefender`` where the reference consults them
from the ClientTrainer/ServerAggregator hooks. ``dlg.py`` is the
gradient-inversion attack (DLG / iDLG), which no engine calls."""

from ..collectives import stack_to_matrix
from .attack import ATTACK_TYPES, FedMLAttacker
from .defense import DEFENSE_TYPES, FedMLDefender, robust_agg

__all__ = ["FedMLAttacker", "FedMLDefender", "ATTACK_TYPES",
           "DEFENSE_TYPES", "stack_to_matrix", "robust_agg"]
