"""Hierarchical cross-silo (counterpart of
``fedml_tpu/cross_silo/hierarchical``): a silo is a group of ranks that
trains data-parallel over ``torch.distributed`` while its rank 0 speaks
the WAN FSM unchanged. See :mod:`.trainer` for the data-parallel step and
:mod:`.process_group` for the silo's process group."""

from .process_group import (close_silo_process_group,  # noqa: F401
                            init_silo_process_group)
from .runner import (HierarchicalCrossSiloRunner,  # noqa: F401
                     run_hierarchical_cross_silo_inproc)
from .trainer import HierarchicalSiloTrainer  # noqa: F401
