"""Contribution assessment (counterpart of ``fedml_tpu/core/contribution``;
reference ``core/contribution/``): GTG-Shapley, leave-one-out, and the
manager the simulators consult after the round's attack
(``ContributionAssessorManager``)."""

from .contribution_assessor import (ContributionAssessorManager,
                                    gtg_shapley, gtg_shapley_values,
                                    leave_one_out, leave_one_out_values,
                                    masked_mean)

__all__ = ["ContributionAssessorManager", "gtg_shapley",
           "gtg_shapley_values", "leave_one_out", "leave_one_out_values",
           "masked_mean"]
