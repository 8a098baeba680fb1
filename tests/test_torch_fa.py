"""Federated analytics (``fa/``, a copy of the JAX package's on the port's
comm manager and sampling): the cases of ``tests/test_fa.py`` through the
port — each analyzer/aggregator pair against ground truth computed on the
pooled data, the WAN session, dedup of retried submissions — and the
port's results equal the JAX package's on the same shards."""

import numpy as np
import pytest

from fedml_tpu import fa as jfa
from fedml_tpu_torch import fa

pytestmark = pytest.mark.torch_port


class A:
    comm_round = 1
    client_num_per_round = 4


def client_values(seed=0, k=4, n=200):
    rng = np.random.RandomState(seed)
    return [rng.randn(n) * (i + 1) for i in range(k)]


def test_avg():
    datas = client_values()
    out = fa.run_fa("avg", datas, A())
    pooled = np.concatenate(datas)
    assert abs(out["result"] - pooled.mean()) < 1e-9


def test_frequency():
    datas = [[1, 1, 2], [2, 3], [3, 3, 3]]
    out = fa.run_fa("frequency_estimation", datas, A())
    assert out["result"][1] == 2 and out["result"][3] == 4


def test_intersection_and_union():
    datas = [{1, 2, 3}, {2, 3, 4}, {2, 3, 9}, {0, 2, 3}]
    out = fa.run_fa("intersection", [list(d) for d in datas], A())
    assert out["result"] == {2, 3}
    out = fa.run_fa("union", [list(d) for d in datas], A())
    assert out["result"] == {0, 1, 2, 3, 4, 9}


def test_k_percentile_bisection_converges():
    rng = np.random.RandomState(0)
    datas = [rng.uniform(0, 100, 500) for _ in range(4)]
    args = A()
    args.comm_round = 40
    args.k_percentile = 50
    out = fa.run_fa("k_percentile", datas, args,
                    comm_round=40)
    pooled = np.concatenate(datas)
    assert abs(out["result"] - np.median(pooled)) < 2.0


def test_triehh_finds_heavy_hitters():
    # 7 clients; three hold only "the", three only "cat" (votes are then
    # deterministic), one holds the rare "zebra"
    datas = [["the"]] * 3 + [["cat"]] * 3 + [["zebra"]]
    args = A()
    args.client_num_per_round = 7
    args.triehh_theta = 3
    out = fa.run_fa("heavy_hitter_triehh", datas, args, comm_round=8)
    found = set(out["result"])
    assert "the" in found and "cat" in found
    assert "zebra" not in found


def test_fa_cross_silo_session_matches_sim():
    """FA over the WAN FSM (reference fa/cross_silo/): the session's
    aggregate equals the in-process simulator's on the same shards."""
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.fa.analyzers import AvgAggregator, AvgClientAnalyzer
    from fedml_tpu_torch.fa.cross_silo import run_fa_cross_silo_inproc

    datas = client_values()
    args = Arguments(comm_round=1, client_num_per_round=4,
                     training_type="cross_silo")
    out = run_fa_cross_silo_inproc(args, datas,
                                   analyzer_factory=AvgClientAnalyzer,
                                   aggregator=AvgAggregator())
    pooled = np.concatenate(datas)
    assert abs(out["result"] - pooled.mean()) < 1e-9
    assert out["rounds"] == 1


def test_fa_server_dedups_and_drops_stale_rounds():
    """Duplicate submissions (client retry) count once; submissions tagged
    with a stale round index are dropped (ADVICE r2)."""
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.core.distributed.communication.message import Message
    from fedml_tpu_torch.fa.cross_silo import FAMessage, FAServerManager

    folded = []

    class Agg:
        def get_init_msg(self):
            return None

        def aggregate(self, subs):
            folded.append(list(subs))
            return sum(subs)

        def get_server_data(self):
            return folded

    from fedml_tpu_torch.core.distributed.communication.inproc import InProcBroker

    args = Arguments(comm_round=2, training_type="fa",
                     inproc_broker=InProcBroker())
    srv = FAServerManager(args, Agg(), rank=0, size=3, backend="INPROC")
    srv.send_message = lambda msg: None  # no transport in this unit test
    srv.finish = lambda: None

    def sub(sender, value, round_idx):
        m = Message(FAMessage.C2S_SUBMISSION, sender, 0)
        m.add_params(FAMessage.KEY_SUBMISSION, value)
        m.add_params(FAMessage.KEY_ROUND, round_idx)
        return m

    srv.on_submission(sub(1, 10, 0))
    srv.on_submission(sub(1, 10, 0))     # retry: must not close the round
    assert srv.round_idx == 0 and not folded
    srv.on_submission(sub(2, 99, 5))     # wrong round: dropped
    assert srv.round_idx == 0 and not folded
    srv.on_submission(sub(2, 5, 0))      # second distinct sender closes it
    assert srv.round_idx == 1
    assert folded == [[10, 5]]
    srv.on_submission(sub(1, 1, 0))      # late round-0 dupe: dropped
    assert srv.round_idx == 1 and len(folded) == 1


@pytest.mark.parametrize("kind,datas,extra", [
    ("avg", client_values(), {}),
    ("frequency_estimation", [[1, 1, 2], [2, 3], [3, 3, 3]], {}),
    ("union", [[1, 2, 3], [2, 3, 4], [2, 3, 9], [0, 2, 3]], {}),
    ("k_percentile", [np.random.RandomState(0).uniform(0, 100, 500)
                      for _ in range(4)], {"k_percentile": 50})])
def test_results_equal_reference(kind, datas, extra):
    args = A()
    for k, v in extra.items():
        setattr(args, k, v)
    got = fa.run_fa(kind, datas, args, comm_round=12)["result"]
    want = jfa.run_fa(kind, datas, args, comm_round=12)["result"]
    assert got == want
