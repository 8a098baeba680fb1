"""FA simulation runner (reference ``fa/simulation/sp/simulator.py`` +
``fa/fa_runner.py``): rounds of client sampling -> local_analyze ->
aggregate, over per-client raw-data lists."""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Sequence

import numpy as np

from ..simulation.sampling import (client_sampling,
                                   sampling_stream_from_args)

logger = logging.getLogger(__name__)


class FASimulator:
    def __init__(self, args, client_datas: Sequence[Sequence],
                 client_analyzer, server_aggregator):
        self.args = args
        self.client_datas = list(client_datas)
        self.analyzer = client_analyzer
        self.aggregator = server_aggregator
        self.history: List[Any] = []

    def run(self, comm_round=None) -> Dict[str, Any]:
        rounds = int(comm_round if comm_round is not None
                     else getattr(self.args, "comm_round", 1))
        per_round = int(getattr(self.args, "client_num_per_round",
                                len(self.client_datas)))
        for round_idx in range(rounds):
            sampled = client_sampling(
                round_idx, len(self.client_datas), per_round,
                random_seed=int(getattr(self.args, "random_seed", 0) or 0),
                stream=sampling_stream_from_args(self.args))
            init_msg = self.aggregator.get_init_msg()
            submissions = []
            for cid in sampled:
                self.analyzer.set_init_msg(init_msg)
                submissions.append(
                    self.analyzer.local_analyze(self.client_datas[cid],
                                                self.args))
            result = self.aggregator.aggregate(submissions)
            self.history.append(result)
            logger.info("fa round %d: %s", round_idx, _brief(result))
        return {"result": self.aggregator.get_server_data(),
                "history": self.history, "rounds": rounds}


def _brief(x, n=80):
    s = repr(x)
    return s if len(s) <= n else s[:n] + "..."
