"""The durable multi-tenant fleet plane (``core/fleet``, a copy of the JAX
package's on the port's ``core/selection``): the cases of
``tests/test_fleet.py`` through the port — the sqlite device registry's
upsert/claims/fairness semantics, pacer-driven cohort sizing, the
concurrent task plane, and the restart-and-resume story of the port's
device server (a restarted server replays *identical* cohorts from the
persisted registry plus checkpointed stats/pacer posture) — and the
port's task plane and device server schedule the JAX package's cohorts
on the same inputs."""

import copy
import threading

import numpy as np
import pytest

from fedml_tpu_torch import data as data_mod
from fedml_tpu_torch import model as model_mod
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.core.fleet import DeviceRegistry, TaskPlane
from fedml_tpu_torch.core.selection import DeadlinePacer

pytestmark = pytest.mark.torch_port


class TestDeviceRegistry:
    def test_register_upsert_is_idempotent(self, tmp_path):
        """Re-registering under the same id (network flap, app restart)
        refreshes eligibility + last_heard in place — never a duplicate
        row, never a reset of first_seen."""
        reg = DeviceRegistry(str(tmp_path / "fleet.db"))
        reg.register(5, {"os": "android", "charging": True}, now=100.0)
        reg.register(5, {"os": "android", "charging": False}, now=200.0)
        assert reg.device_count() == 1
        d = reg.device(5)
        assert d["registrations"] == 2
        assert d["first_seen"] == 100.0
        assert d["last_heard"] == 200.0
        assert d["charging"] is False  # refreshed, not stale

    def test_claims_grant_one_task_per_round(self, tmp_path):
        reg = DeviceRegistry(str(tmp_path / "fleet.db"))
        for i in range(1, 6):
            reg.register(i, now=0.0)
        g1, b1, c1 = reg.claim("train", [1, 2, 3], 0, now=1.0)
        assert g1 == [1, 2, 3] and b1 == 0 and c1 == 0
        # another task wanting an overlapping set only gets the free one
        g2, b2, c2 = reg.claim("fa", [2, 3, 4], 0, now=1.0)
        assert g2 == [4] and b2 == 2 and c2 == 0
        # a retry by the SAME task is idempotent — no double-claim, no
        # busy denial against itself
        g3, b3, c3 = reg.claim("train", [1, 2, 3], 0, now=1.5)
        assert g3 == [1, 2, 3] and b3 == 0
        # release frees the round's claims and appends participation
        reg.release("train", 0, [1, 2, 3], now=2.0)
        g4, _, _ = reg.claim("fa", [1], 1, now=2.5)
        assert g4 == [1]

    def test_fairness_cap_denies_over_window(self, tmp_path):
        reg = DeviceRegistry(str(tmp_path / "fleet.db"))
        reg.register(1, now=0.0)
        # two served rounds inside the window
        for r in range(2):
            g, _, _ = reg.claim("train", [1], r, cap=2, window_s=100.0,
                                now=10.0 * (r + 1))
            assert g == [1]
            reg.release("train", r, [1], now=10.0 * (r + 1) + 1)
        # at the cap: denied
        g, busy, capped = reg.claim("train", [1], 2, cap=2, window_s=100.0,
                                    now=30.0)
        assert g == [] and busy == 0 and capped == 1
        # outside the window the history no longer counts
        g, _, capped = reg.claim("train", [1], 3, cap=2, window_s=100.0,
                                 now=500.0)
        assert g == [1] and capped == 0

    def test_audit_detects_overlap_and_cap_breach(self, tmp_path):
        reg = DeviceRegistry(str(tmp_path / "fleet.db"))
        reg.register(1, now=0.0)
        assert reg.audit(cap=1, window_s=100.0) == {"overlap": 0,
                                                    "cap_violations": 0}
        # two tasks recording the same (device, round): overlap
        reg.release("train", 0, [1], now=1.0)
        reg.release("fa", 0, [1], now=2.0)
        out = reg.audit(cap=1, window_s=100.0)
        assert out["overlap"] == 1
        assert out["cap_violations"] == 1  # 2 served rounds, cap 1

    def test_iter_id_chunks_pages_ascending(self, tmp_path):
        reg = DeviceRegistry(str(tmp_path / "fleet.db"))
        for i in range(10):
            reg.register(i, now=0.0)
        chunks = list(reg.iter_id_chunks(chunk=4))
        assert [len(c) for c in chunks] == [4, 4, 2]
        np.testing.assert_array_equal(np.concatenate(chunks),
                                      np.arange(10))

    def test_state_blob_roundtrip(self, tmp_path):
        reg = DeviceRegistry(str(tmp_path / "fleet.db"))
        arrays = {"a": np.arange(5, dtype=np.float64),
                  "b": np.int64(7)}
        reg.save_state("fleet:pacer:train", arrays, now=1.0)
        back = reg.load_state("fleet:pacer:train")
        np.testing.assert_array_equal(back["a"], arrays["a"])
        assert int(back["b"]) == 7
        assert reg.load_state("missing") is None
        assert "fleet:pacer:train" in reg.state_keys()


class TestPacerCohortSizing:
    def _args(self, **kw):
        return Arguments(**kw)

    def test_off_is_identity(self):
        pacer = DeadlinePacer.from_args(self._args())
        assert pacer.paced_cohort(17) == 17
        for _ in range(20):
            pacer.observe_utility(1.0)  # no-op when off
        assert pacer.paced_cohort(17) == 17
        assert pacer.cohort_scale == 1.0

    def test_grows_on_saturation_decays_on_improvement(self):
        pacer = DeadlinePacer.from_args(self._args(
            pacer_adapt_cohort=True, pacer_util_window=2))
        # flat utility: the second window shows no improvement -> grow k
        for u in (1.0, 1.0, 1.0, 1.0):
            pacer.observe_utility(u)
        assert pacer.cohort_scale == pytest.approx(1.2)
        assert pacer.paced_cohort(10) > 10
        # strongly improving utility: decay back toward the floor
        for u in (10.0, 10.0):
            pacer.observe_utility(u)
        assert pacer.cohort_scale == pytest.approx(1.2 * 0.9)
        for u in (100.0, 100.0):
            pacer.observe_utility(u)
        assert pacer.cohort_scale == 1.0  # clamped at the floor
        # bounds hold under sustained saturation
        for _ in range(200):
            pacer.observe_utility(1.0)
        assert pacer.cohort_scale <= pacer.max_cohort_scale

    def test_state_roundtrip_and_legacy_load(self):
        args = self._args(pacer_adapt_cohort=True, pacer_util_window=2)
        pacer = DeadlinePacer.from_args(args)
        for u in (1.0, 1.0, 1.0, 1.0, 2.0):
            pacer.observe_utility(u)
        st = pacer.state_dict()
        other = DeadlinePacer.from_args(args)
        other.load_state_dict(st)
        assert other.cohort_scale == pacer.cohort_scale
        assert other._util_hist == pacer._util_hist
        # a snapshot from before the cohort keys still loads
        legacy = {k: v for k, v in st.items()
                  if k not in ("cohort_scale", "util_hist")}
        fresh = DeadlinePacer.from_args(args)
        fresh.load_state_dict(legacy)
        assert fresh.cohort_scale == 1.0


def plane_args(**kw):
    base = dict(random_seed=7, cohort_scan_chunk=64, oort_alpha=0.0,
                pacer_over_sample=1.0)
    base.update(kw)
    return Arguments(**base)


def seeded_plane(tmp_path, name, n=64, **kw):
    reg = DeviceRegistry(str(tmp_path / f"{name}.db"))
    for i in range(n):
        reg.register(i, now=0.0)
    plane = TaskPlane(plane_args(**kw), reg, population=n)
    return reg, plane


class TestTaskPlane:
    def test_three_tasks_share_one_population_fairly(self, tmp_path):
        """3 concurrent tasks (train / FA / LoRA shapes) over one
        registry: per-round cohorts are disjoint, every task gets its
        full k, and the registry audit finds zero fairness violations."""
        reg, plane = seeded_plane(tmp_path, "fleet", n=64,
                                  fleet_max_rounds_per_window=4,
                                  fleet_fairness_window_s=1000.0)
        plane.add_task("train", cohort_k=12)
        plane.add_task("fa", cohort_k=8, kind="analytics")
        plane.add_task("lora", cohort_k=4, kind="llm")
        for r in range(6):
            now = 10.0 * (r + 1)
            cohorts = plane.assign_round(now=now)
            all_ids = [d for c in cohorts.values() for d in c]
            assert len(all_ids) == len(set(all_ids)), "cohorts overlap"
            assert len(cohorts["train"]) == 12
            assert len(cohorts["fa"]) == 8
            assert len(cohorts["lora"]) == 4
            for tid, cohort in cohorts.items():
                plane.observe_round(tid, cohort, wall_s=0.1, now=now + 1)
        assert reg.audit(cap=4, window_s=1000.0) == \
            {"overlap": 0, "cap_violations": 0}
        # the cap actually bit: 6 rounds x 24 slots over 64 devices
        # cannot all go to the same devices
        counts = reg.participation_counts(list(range(64)), 1000.0,
                                          now=100.0)
        assert counts.max() <= 4
        assert plane.task("train").rounds_run == 6

    def test_cap_starves_gracefully(self, tmp_path):
        """When the fairness cap exhausts the eligible population, the
        cohort shrinks instead of violating the cap."""
        reg, plane = seeded_plane(tmp_path, "tiny", n=8,
                                  fleet_max_rounds_per_window=1,
                                  fleet_fairness_window_s=1000.0)
        plane.add_task("train", cohort_k=6)
        sizes = []
        for r in range(3):
            now = 10.0 * (r + 1)
            cohorts = plane.assign_round(now=now)
            sizes.append(len(cohorts["train"]))
            plane.observe_round("train", cohorts["train"], wall_s=0.1,
                                now=now + 1)
        # 8 devices, cap 1: round 0 serves 6, round 1 the remaining 2,
        # round 2 nobody — and the audit stays clean
        assert sizes == [6, 2, 0]
        assert reg.audit(cap=1, window_s=1000.0) == \
            {"overlap": 0, "cap_violations": 0}

    def test_restart_resumes_identical_cohorts(self, tmp_path):
        """The acceptance replay: plane A runs 2 rounds and checkpoints;
        plane B (fresh objects, same registry) loads and runs rounds
        2-3; twin C runs all 4 uninterrupted on its own registry. B's
        resumed rounds must equal C's — the persisted registry +
        stats/pacer snapshot IS the plane's whole state."""
        kw = dict(fleet_max_rounds_per_window=3,
                  fleet_fairness_window_s=1000.0,
                  pacer_adapt_cohort=True, pacer_util_window=2)

        def run(plane, reg, rounds, start=0, log=None):
            for r in range(start, rounds):
                now = 10.0 * (r + 1)
                cohorts = plane.assign_round(now=now)
                for tid, cohort in cohorts.items():
                    plane.observe_round(tid, cohort, wall_s=0.1,
                                        now=now + 1)
                plane.save(now=now + 2)
                if log is not None:
                    log.append((r, cohorts))

        reg_a, plane_a = seeded_plane(tmp_path, "shared", n=48, **kw)
        plane_a.add_task("train", cohort_k=8)
        plane_a.add_task("fa", cohort_k=4, kind="analytics")
        run(plane_a, reg_a, rounds=2)

        # B: brand-new objects over the SAME registry file
        reg_b = DeviceRegistry(str(tmp_path / "shared.db"))
        plane_b = TaskPlane(plane_args(**kw), reg_b, population=48)
        plane_b.add_task("train", cohort_k=8)
        plane_b.add_task("fa", cohort_k=4, kind="analytics")
        assert plane_b.load() is True
        assert plane_b.round_cursor == 2  # resumes where A stopped
        log_b = []
        run(plane_b, reg_b, rounds=4, start=2, log=log_b)

        # C: the uninterrupted twin on its own registry
        reg_c, plane_c = seeded_plane(tmp_path, "twin", n=48, **kw)
        plane_c.add_task("train", cohort_k=8)
        plane_c.add_task("fa", cohort_k=4, kind="analytics")
        log_c = []
        run(plane_c, reg_c, rounds=4, log=log_c)

        assert log_b == log_c[2:], \
            "resumed plane diverged from the uninterrupted twin"
        # a cold plane on a fresh registry has nothing to load
        reg_d, plane_d = seeded_plane(tmp_path, "cold", n=48, **kw)
        assert plane_d.load() is False

    def test_concurrent_claims_from_threads_never_overlap(self, tmp_path):
        """Two task servers hammering the SAME registry file from
        separate threads (the cross-process story, minus the fork), both
        wanting overlapping device sets and HOLDING their claims while
        the other claims: BEGIN IMMEDIATE keeps every round's
        assignments disjoint."""
        reg_path = str(tmp_path / "shared.db")
        reg = DeviceRegistry(reg_path)
        for i in range(40):
            reg.register(i, now=0.0)
        grants = {}
        # both sides hold their claims until the other has claimed too —
        # the simultaneous-tenancy window the claims table must arbitrate
        rendezvous = threading.Barrier(2, timeout=30)
        wanted = {"train": list(range(0, 30)), "fa": list(range(10, 40))}

        def worker(task_id):
            own = DeviceRegistry(reg_path)  # own connection pool
            got = []
            for r in range(5):
                g, _, _ = own.claim(task_id, wanted[task_id], r,
                                    now=float(r + 1))
                rendezvous.wait()  # both tasks now hold claims
                got.append(set(g))
                own.release(task_id, r, sorted(g), now=float(r + 1) + 0.5)
                rendezvous.wait()  # both released; next round
            grants[task_id] = got

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in ("train", "fa")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert set(grants) == {"train", "fa"}
        for r in range(5):
            assert not (grants["train"][r] & grants["fa"][r]), \
                f"round {r}: both tasks held the same device"
            # nothing in the contended middle went unserved
            assert grants["train"][r] | grants["fa"][r] == set(range(40))
        assert reg.audit() == {"overlap": 0, "cap_violations": 0}


# --- e2e: the cross-device session over a durable registry ---------------


def make_args(**kw):
    base = dict(dataset="synthetic_mnist", model="lr",
                client_num_in_total=3, client_num_per_round=3,
                comm_round=2, epochs=1, batch_size=32, learning_rate=0.1,
                random_seed=3, training_type="cross_device",
                cohort_assembly=True, cohort_size=2,
                # determinism for replay assertions: no wall-clock
                # latency term in the oort score, no over-sampled
                # dispatch (the barrier then equals the cohort, so the
                # served set is the cohort — thread timing can't leak
                # into the stats evidence)
                oort_alpha=0.0, pacer_over_sample=1.0)
    base.update(kw)
    return Arguments(**base)


def run_session(tmp_path, cache="cache", **kw):
    """One in-proc cross-device session of the port on the CPU; returns
    the server (result, cohort_log, fleet handle all inspectable)."""
    from fedml_tpu_torch.core.distributed.communication.inproc import InProcBroker
    from fedml_tpu_torch.cross_device import (build_device_client,
                                        build_device_server)

    args = make_args(model_file_cache_dir=str(tmp_path / cache), **kw)
    args.inproc_broker = InProcBroker()
    fed, output_dim = data_mod.load(args)
    bundle = model_mod.create(args, output_dim, fed.input_shape)
    server = build_device_server(args, fed, bundle, backend="INPROC",
                                 device="cpu")
    n = int(args.client_num_per_round)
    devices = [build_device_client(args, fed, copy.deepcopy(bundle),
                                   device_id=i, backend="INPROC",
                                   device="cpu")
               for i in range(1, n + 1)]
    threads = [threading.Thread(target=d.run, daemon=True)
               for d in devices]
    for t in threads:
        t.start()
    done = {}

    def run_server():
        server.run()
        done["ok"] = True

    st = threading.Thread(target=run_server, daemon=True)
    st.start()
    st.join(timeout=120)
    assert done.get("ok"), "server stalled"
    return server


class TestServerRestartResume:
    def test_restarted_server_resumes_and_replays(self, tmp_path):
        """Kill-and-restart across sessions: session A (2 of 4 rounds)
        checkpoints into the registry; session B reopens it and must
        (a) remember A's devices, (b) resume at round 2 with the
        aggregated model, and (c) schedule the SAME rounds 2-3 cohorts
        as an uninterrupted twin running all 4 rounds."""
        db = str(tmp_path / "fleet.db")
        a = run_session(tmp_path, cache="a", comm_round=2,
                        fleet_registry=db)
        assert len(a.result["history"]) == 2
        assert a.fleet.device_count() == 3
        assert a.round_idx == 2  # persisted cursor

        b = run_session(tmp_path, cache="b", comm_round=4,
                        fleet_registry=db)
        # remembered, not re-discovered: same rows, bumped counters
        assert b.fleet.device_count() == 3
        assert b.fleet.device(1)["registrations"] == 2
        # only rounds 2-3 ran in session B
        assert len(b.result["history"]) == 2
        assert b.cohort_log[0][0] == 2

        c = run_session(tmp_path, cache="c", comm_round=4,
                        fleet_registry=str(tmp_path / "twin.db"))
        assert len(c.result["history"]) == 4
        assert b.cohort_log == c.cohort_log[2:], \
            "restarted server diverged from the uninterrupted twin"
        # the resumed model kept learning (restart did not reset it)
        assert b.result["final_test_acc"] >= a.result["final_test_acc"]

    def test_completed_session_restart_is_a_noop(self, tmp_path):
        """Restarting after the final round: the registry remembers the
        session completed — the server finishes immediately instead of
        re-training."""
        db = str(tmp_path / "fleet.db")
        run_session(tmp_path, cache="a", comm_round=2, fleet_registry=db)
        again = run_session(tmp_path, cache="b", comm_round=2,
                            fleet_registry=db)
        assert again.result["history"] == []
        assert again.round_idx == 2

    def test_fleet_off_path_is_unchanged(self, tmp_path):
        """The bit-identity gate: with no fleet_registry the server
        schedules exactly what a fleet-on server over a FRESH registry
        schedules (the registry only adds memory, never perturbs a cold
        cohort) — and no registry file is ever created."""
        off = run_session(tmp_path, cache="off", comm_round=2)
        assert off.fleet is None
        on = run_session(tmp_path, cache="on", comm_round=2,
                         fleet_registry=str(tmp_path / "fresh.db"))
        assert off.cohort_log == on.cohort_log
        assert off.result["final_test_acc"] == \
            on.result["final_test_acc"]
        assert not (tmp_path / "off" / "fleet.db").exists()


class TestFACohortAssembly:
    def _session(self, n=4, eligibility=None, **kw):
        from fedml_tpu_torch.core.distributed.communication.inproc import \
            InProcBroker
        from fedml_tpu_torch.fa.analyzers import AvgAggregator, AvgClientAnalyzer
        from fedml_tpu_torch.fa.cross_silo import (FAClientManager,
                                             FAServerManager)

        rng = np.random.RandomState(0)
        datas = [rng.randn(50) * (i + 1) for i in range(n)]
        args = Arguments(comm_round=3, client_num_per_round=n,
                         training_type="cross_silo", random_seed=5,
                         oort_alpha=0.0, pacer_over_sample=1.0, **kw)
        args.inproc_broker = InProcBroker()
        server = FAServerManager(args, AvgAggregator(), rank=0,
                                 size=n + 1, backend="INPROC")
        eligs = eligibility or {}
        clients = [FAClientManager(args, AvgClientAnalyzer(), datas[i],
                                   rank=i + 1, size=n + 1,
                                   backend="INPROC",
                                   eligibility=eligs.get(i + 1))
                   for i in range(n)]
        threads = [threading.Thread(target=c.run, daemon=True)
                   for c in clients]
        for t in threads:
            t.start()
        done = {}

        def run_server():
            server.run()
            done["ok"] = True

        st = threading.Thread(target=run_server, daemon=True)
        st.start()
        st.join(timeout=120)
        assert done.get("ok"), "fa server stalled"
        return server

    def test_fa_cohort_filters_ineligible_party(self):
        """Analytics rides the same eligibility sieve as training: a
        party reporting not-charging is never scheduled while
        cohort_require_charging is on, and rounds still close on the
        eligible cohort."""
        server = self._session(
            n=4, cohort_assembly=True, cohort_size=2,
            cohort_require_charging=True,
            eligibility={2: {"charging": False}})
        assert server.result is not None
        assert server.result["rounds"] == 3
        assert len(server.cohort_log) == 3
        for _, cohort in server.cohort_log:
            assert len(cohort) == 2
            assert 2 not in cohort, "ineligible party was scheduled"
        sel = server.stats.times_selected_for([1, 2, 3, 4])
        assert sel[1] == 0

    def test_fa_cohort_off_is_broadcast(self):
        """Knob off: every online party analyzes every round — the
        legacy FA session byte-for-byte."""
        server = self._session(n=3)
        assert not server.cohort_enabled
        assert server.stats is None
        assert server.result["rounds"] == 3


# --- the port against the JAX package -------------------------------------


def test_task_plane_cohorts_equal_reference(tmp_path):
    """Three tasks over one registry for 4 rounds: the port's plane
    assigns the JAX plane's cohorts round for round."""
    from fedml_tpu.arguments import Arguments as JArguments
    from fedml_tpu.core.fleet import DeviceRegistry as JRegistry
    from fedml_tpu.core.fleet import TaskPlane as JPlane
    kw = dict(random_seed=7, cohort_scan_chunk=64, oort_alpha=0.0,
              pacer_over_sample=1.0, fleet_max_rounds_per_window=3,
              fleet_fairness_window_s=1000.0, pacer_adapt_cohort=True,
              pacer_util_window=2)
    logs = []
    for name, Reg, Plane, Args in (("j", JRegistry, JPlane, JArguments),
                                   ("t", DeviceRegistry, TaskPlane,
                                    Arguments)):
        reg = Reg(str(tmp_path / f"{name}.db"))
        for i in range(48):
            reg.register(i, now=0.0)
        plane = Plane(Args(**kw), reg, population=48)
        plane.add_task("train", cohort_k=8)
        plane.add_task("fa", cohort_k=4, kind="analytics")
        log = []
        for r in range(4):
            now = 10.0 * (r + 1)
            cohorts = plane.assign_round(now=now)
            for tid, cohort in cohorts.items():
                plane.observe_round(tid, cohort, wall_s=0.1, now=now + 1)
            log.append({k: list(v) for k, v in cohorts.items()})
        logs.append(log)
    assert logs[0] == logs[1]


def test_device_server_cohorts_equal_reference(tmp_path):
    """The cross-device session over a fresh registry: the port's device
    server schedules the JAX server's cohorts."""
    from fedml_tpu import data as jdata
    from fedml_tpu import model as jmodel
    from fedml_tpu.arguments import Arguments as JArguments
    from fedml_tpu.core.distributed.communication.inproc import \
        InProcBroker as JBroker
    from fedml_tpu.cross_device import build_device_client as jclient
    from fedml_tpu.cross_device import build_device_server as jserver
    port = run_session(tmp_path, cache="t", comm_round=3,
                       fleet_registry=str(tmp_path / "t.db"))
    jargs = JArguments(**dict(make_args(comm_round=3).__dict__,
                              model_file_cache_dir=str(tmp_path / "j"),
                              fleet_registry=str(tmp_path / "j.db")))
    jargs.inproc_broker = JBroker()
    fed, od = jdata.load(jargs)
    bundle = jmodel.create(jargs, od)
    server = jserver(jargs, fed, bundle, backend="INPROC")
    devices = [jclient(jargs, fed, bundle, device_id=i, backend="INPROC")
               for i in (1, 2, 3)]
    threads = [threading.Thread(target=d.run, daemon=True)
               for d in devices]
    for t in threads:
        t.start()
    server.run()
    assert port.cohort_log == server.cohort_log
    assert len(port.result["history"]) == 3
