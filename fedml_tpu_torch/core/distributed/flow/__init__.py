"""FedMLAlgorithmFlow — declarative DAG of named flows over executors (a
copy of ``fedml_tpu/core/distributed/flow``).

Parity target: reference ``core/distributed/flow/fedml_flow.py:20``
(``add_flow`` :67, ``build`` :78, message-driven step chaining) +
``fedml_executor.py:4``. A *flow* is a named step run by an executor role
(server / client); ``build`` chains them so finishing one flow triggers the
next across the transport. This single-process version runs the chain over
the in-proc broker — same FSM, no cluster.
"""

from .fedml_executor import FedMLExecutor
from .fedml_flow import FedMLAlgorithmFlow

__all__ = ["FedMLExecutor", "FedMLAlgorithmFlow"]
