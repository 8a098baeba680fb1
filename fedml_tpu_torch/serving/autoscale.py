"""Serving autoscaler: policies + replica set + scale-out gateway (a copy
of ``fedml_tpu/serving/autoscale.py``: subprocess replicas start
``fedml_tpu_torch.serving.replica_main`` and serve on the card unless the
factory asks for the CPU).

Parity target: reference ``model_scheduler/autoscaler/autoscaler.py``
(policy classes :20,70,135,186 — EWM of QPS, concurrency, traffic
lookback — consulted by the deploy agents to resize endpoint replicas)
and the inference gateway (``device_model_inference.py``). Local-first
redesign: replicas are in-process :class:`FedMLInferenceRunner` instances
(the docker-container analogue without a container runtime); the
:class:`Gateway` fronts them with round-robin dispatch and records the
QPS/latency series the policies consume; :class:`Autoscaler` applies a
policy on a cadence and grows/shrinks the replica set.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import threading
import time
import urllib.request
from collections import deque
from typing import Deque, List, Optional

logger = logging.getLogger(__name__)


# ------------------------------------------------------------- policies ----

@dataclasses.dataclass
class EWMPolicy:
    """Exponentially-weighted moving average of per-replica QPS (reference
    ``EWMPolicy`` :70): scale so that EWM(qps)/replica stays under
    ``target_qps_per_replica``."""
    target_qps_per_replica: float = 10.0
    alpha: float = 0.5
    _ewm: Optional[float] = None

    def desired_replicas(self, qps: float, latency_s: float,
                         current: int) -> int:
        self._ewm = (qps if self._ewm is None
                     else self.alpha * qps + (1 - self.alpha) * self._ewm)
        return max(1, math.ceil(self._ewm / self.target_qps_per_replica))


@dataclasses.dataclass
class ConcurrencyPolicy:
    """Little's-law concurrency policy (reference ``ConcurrentQueryPolicy``
    :135): in-flight = qps x latency; one replica sustains
    ``target_concurrency``. ``latency_signal`` picks which latency the
    autoscaler feeds in — ``"p99"`` makes in-flight a tail estimate, so
    the fleet sizes for the slow requests batching directly shapes, not
    the mean the fast ones dominate."""
    target_concurrency: float = 4.0
    latency_signal: str = "mean"    # mean | p50 | p99

    def desired_replicas(self, qps: float, latency_s: float,
                         current: int) -> int:
        inflight = qps * max(latency_s, 1e-6)
        return max(1, math.ceil(inflight / self.target_concurrency))


@dataclasses.dataclass
class LookbackPolicy:
    """Scale on the max QPS seen in a trailing window (reference
    ``MeetTrafficDemandPolicy`` :186 shape): headroom for bursts.
    ``max_latency_s`` adds a tail-latency guard on ``latency_signal``
    (default p99): while the observed tail exceeds it, demand-based
    sizing is overridden upward by one replica per step."""
    target_qps_per_replica: float = 10.0
    window: int = 10
    max_latency_s: float = 0.0      # 0 = QPS-only (original behavior)
    latency_signal: str = "p99"
    _hist: Deque[float] = dataclasses.field(default_factory=deque)

    def desired_replicas(self, qps: float, latency_s: float,
                         current: int) -> int:
        self._hist.append(qps)
        while len(self._hist) > self.window:
            self._hist.popleft()
        peak = max(self._hist)
        desired = max(1, math.ceil(peak / self.target_qps_per_replica))
        if self.max_latency_s > 0 and latency_s > self.max_latency_s:
            desired = max(desired, current + 1)
        return desired


@dataclasses.dataclass
class FleetSLOView:
    """One autoscaler step's aggregated fleet scrape: worst-replica
    TTFT/ITL p99 from each replica's ``/healthz`` ``slo`` payload (exact
    trailing-window percentiles, not bucketed exposition), summed queue
    depth, the MINIMUM KV admission headroom across replicas (the
    replica that will shed first), and the gateway's own p99."""
    ttft_p99_s: float = 0.0
    itl_p99_s: float = 0.0
    queue_depth: int = 0
    kv_headroom_min: Optional[int] = None    # None = no replica reported
    gateway_p99_s: float = 0.0
    replicas: int = 0


@dataclasses.dataclass
class SLOPolicy:
    """SLO-driven autoscaling: close the loop from the
    serving SLO instruments to replica count. Scale UP one replica while
    any enabled target is breached — p99 TTFT / p99 ITL over target,
    fleet queue depth past ``queue_depth_per_replica * current``, or
    minimum KV admission headroom under ``kv_headroom_min`` (the
    saturation signal: a replica about to shed). Scale DOWN one replica
    only when every enabled tail sits under ``scale_down_idle_factor``
    of its target AND the fleet queue is empty. ``cooldown_s`` gates
    consecutive moves so one burst cannot staircase the fleet. Targets
    of 0 disable that signal."""
    ttft_p99_s: float = 0.0
    itl_p99_s: float = 0.0
    queue_depth_per_replica: float = 4.0
    kv_headroom_min: int = 1
    scale_down_idle_factor: float = 0.3
    cooldown_s: float = 5.0
    latency_signal: str = "p99"
    _last_scale_ts: float = dataclasses.field(default=0.0, repr=False)

    def breaches(self, fleet: FleetSLOView, current: int) -> List[str]:
        """Which enabled scale-up signals are breached right now."""
        out = []
        if self.ttft_p99_s > 0 and fleet.ttft_p99_s > self.ttft_p99_s:
            out.append("ttft_p99")
        if self.itl_p99_s > 0 and fleet.itl_p99_s > self.itl_p99_s:
            out.append("itl_p99")
        if (self.queue_depth_per_replica > 0
                and fleet.queue_depth > self.queue_depth_per_replica
                * max(current, 1)):
            out.append("queue_depth")
        if (self.kv_headroom_min > 0 and fleet.kv_headroom_min is not None
                and fleet.kv_headroom_min < self.kv_headroom_min):
            out.append("kv_headroom")
        return out

    def desired_from_fleet(self, fleet: FleetSLOView, current: int) -> int:
        now = time.time()
        if now - self._last_scale_ts < self.cooldown_s:
            return current
        if self.breaches(fleet, current):
            self._last_scale_ts = now
            return current + 1
        idle = fleet.queue_depth == 0
        if self.ttft_p99_s > 0:
            idle = idle and (fleet.ttft_p99_s
                             < self.scale_down_idle_factor
                             * self.ttft_p99_s)
        if self.itl_p99_s > 0:
            idle = idle and (fleet.itl_p99_s
                             < self.scale_down_idle_factor
                             * self.itl_p99_s)
        if idle and current > 1:
            self._last_scale_ts = now
            return current - 1
        return current

    def desired_replicas(self, qps: float, latency_s: float,
                         current: int) -> int:
        """Legacy-signature fallback (an Autoscaler wired to a plain
        gateway window): the gateway's ``latency_signal`` percentile
        stands in for TTFT — breach scales up, deep idle scales down."""
        fleet = FleetSLOView(ttft_p99_s=latency_s, gateway_p99_s=latency_s,
                             queue_depth=0, replicas=current)
        return self.desired_from_fleet(fleet, current)


# ---------------------------------------------------------- replica set ----

class SubprocessReplica:
    """One replica as a CHILD PROCESS serving HTTP — the process-isolation
    analogue of the reference's per-replica docker container
    (``device_model_deployment.py:61-333``): a crash (up to ``kill -9``)
    kills only this process; the controller's health check replaces it.
    Same surface as FedMLInferenceRunner: ``start()``/``stop()``/``port``.
    """

    def __init__(self, spec_path: str, startup_wait_s: float = 30.0):
        self.spec_path = spec_path
        self.startup_wait_s = float(startup_wait_s)
        self.port: Optional[int] = None
        self.proc = None

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None

    def start(self) -> int:
        import subprocess
        import sys
        import tempfile
        import os
        fd, port_file = tempfile.mkstemp(suffix=".port")
        os.close(fd)
        os.unlink(port_file)
        with open(self.spec_path) as f:
            spec = json.load(f)
        spec["port_file"] = port_file
        child_spec = self.spec_path + f".{os.getpid()}.{id(self)}"
        try:
            with open(child_spec, "w") as f:
                json.dump(spec, f)
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "fedml_tpu_torch.serving.replica_main",
                 child_spec],
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            deadline = time.time() + self.startup_wait_s
            while time.time() < deadline:
                if os.path.exists(port_file):
                    with open(port_file) as f:
                        self.port = int(f.read().strip())
                    return self.port
                if self.proc.poll() is not None:
                    break
                time.sleep(0.05)
            self.stop()
            raise RuntimeError(
                "subprocess replica never published its port")
        finally:
            # a crash-looping replica replaced by the health check every
            # few seconds must not accumulate temp spec/port files
            for p in (port_file, child_spec):
                try:
                    os.unlink(p)
                except OSError:
                    pass

    def stop(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=5.0)
            except Exception:
                self.proc.kill()
                try:  # reap: an ignored SIGTERM must not leave a zombie
                    self.proc.wait(timeout=5.0)
                except Exception:
                    pass


def subprocess_replica_factory(args, params_path: str, output_dim: int,
                               workdir: str, device: str = "cuda",
                               kind: str = "classifier"):
    """Build a ``replica_factory`` for :class:`ReplicaSet`: each call
    yields a fresh un-started :class:`SubprocessReplica` serving the given
    model artifact. ``kind='causal_lm'`` makes every replica an LLM
    template server (chat route mounted) instead of a classifier.
    ``device`` is where each replica serves: the card by default, as
    every entry point of the port; ``"cpu"`` only when the caller asks
    (the JAX package keeps replicas on the CPU so they leave the chip to
    the trainer). A replica asked for the card on a host without one
    fails to start: it never falls back to the CPU."""
    import os
    spec = {"args": {k: v for k, v in vars(args).items()
                     if isinstance(v, (str, int, float, bool, type(None)))},
            "params_path": os.path.abspath(params_path),
            "output_dim": int(output_dim), "device": str(device),
            "kind": kind}
    os.makedirs(workdir, exist_ok=True)
    spec_path = os.path.join(workdir, "replica_spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    return lambda: SubprocessReplica(spec_path)


class ReplicaSet:
    """N live inference replicas over one factory (the container-fleet
    analogue; ``scale_to`` is the rolling update). Replicas are in-process
    runners via ``predictor_factory``, or isolated child processes via
    ``replica_factory`` (see :class:`SubprocessReplica`)."""

    def __init__(self, predictor_factory=None, min_replicas: int = 1,
                 max_replicas: int = 8, replica_factory=None,
                 runner_cls=None, drain_grace_s: float = 0.0):
        from . import FedMLInferenceRunner
        if (predictor_factory is None) == (replica_factory is None):
            raise ValueError("pass exactly one of predictor_factory / "
                             "replica_factory")
        # runner_cls lets templates mount extra routes on every replica
        # (e.g. the LLM template's ChatCompletionRunner)
        self._runner_cls = runner_cls or FedMLInferenceRunner
        self.predictor_factory = predictor_factory
        self.replica_factory = replica_factory
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        # drain-before-kill on scale-down: a shrink victim leaves
        # rotation immediately but gets this long to finish in-flight
        # streams before stop() (0 = legacy immediate stop)
        self.drain_grace_s = float(drain_grace_s)
        self.replicas: List = []
        self._lock = threading.Lock()
        # ports the gateway must route around while their replica
        # finishes in-flight work before a restart (the drain seam)
        self._draining: set = set()
        self.scale_to(self.min_replicas)

    def _new_replica(self):
        if self.replica_factory is not None:
            return self.replica_factory()
        return self._runner_cls(self.predictor_factory())

    def _await_idle(self, port: int, grace_s: float) -> bool:
        """Poll a shrink victim's ``/healthz`` until its in-flight work
        drains (occupancy and queue depth both 0) or the grace expires.
        The victim already left rotation — no new traffic lands on it —
        so this only waits out streams it is mid-way through. A replica
        that stopped answering (or one without the engine fields) reads
        as idle: there is nothing left to wait for."""
        deadline = time.time() + float(grace_s)
        while time.time() < deadline:
            try:
                try:
                    r = urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/healthz", timeout=1.0)
                except urllib.error.HTTPError as e:
                    r = e      # a 503 body still carries the health JSON
                with r:
                    h = json.load(r)
            except Exception:  # noqa: BLE001 — gone/unreadable = idle
                return True
            busy = (int(h.get("occupancy", 0) or 0)
                    + int(h.get("queue_depth", 0) or 0))
            if not busy:
                return True
            time.sleep(0.05)
        return False

    def scale_to(self, n: int, drain_grace_s: Optional[float] = None
                 ) -> int:
        """Grow/shrink to ``n``. Replica start/stop happens OUTSIDE the
        set lock — a subprocess replica takes seconds to come up, and the
        gateway needs the same lock for every request; scaling up under
        load must not stall the traffic it is scaling for.

        ``drain_grace_s`` (None = the set default) > 0 makes shrink
        drain-before-kill: the victim leaves rotation at once, then gets
        up to the grace for in-flight streams to finish before stop."""
        n = min(max(n, self.min_replicas), self.max_replicas)
        grace = (getattr(self, "drain_grace_s", 0.0)
                 if drain_grace_s is None else float(drain_grace_s))
        while True:
            victim = None
            with self._lock:
                cur = len(self.replicas)
                if cur > n:
                    victim = self.replicas.pop()
                    # replicas bind ephemeral ports a successor may be
                    # handed again — a stale drain mark would hide it
                    self._draining.discard(victim.port)
            if victim is not None:
                if grace > 0 and victim.port is not None:
                    if not self._await_idle(victim.port, grace):
                        logger.warning(
                            "replica :%d still busy after %.1fs drain "
                            "grace — stopping anyway", victim.port, grace)
                victim.stop()
                logger.info("replica down (%d left)", len(self))
                continue
            if cur >= n:
                return n
            runner = self._new_replica()
            runner.start()
            with self._lock:
                if len(self.replicas) < n:
                    self.replicas.append(runner)
                    logger.info("replica up on :%d (%d total)", runner.port,
                                len(self.replicas))
                    continue
            runner.stop()  # target shrank underneath us

    def ports(self, include_draining: bool = False) -> List[int]:
        with self._lock:
            if include_draining:
                return [r.port for r in self.replicas]
            return [r.port for r in self.replicas
                    if r.port not in self._draining]

    # --- drain / zero-downtime restart ------------------------------------
    def drain(self, port: int) -> None:
        """Take ``port`` out of gateway rotation WITHOUT stopping it: the
        replica finishes its in-flight requests while new traffic routes
        around it."""
        with self._lock:
            self._draining.add(int(port))

    def undrain(self, port: int) -> None:
        with self._lock:
            self._draining.discard(int(port))

    def draining(self) -> List[int]:
        with self._lock:
            return sorted(self._draining)

    def restart_replica(self, port: int, grace_s: float = 0.5,
                        ready_wait_s: float = 10.0) -> int:
        """Drain -> finish-in-flight -> restart, one replica: the
        zero-downtime reload seam. The victim leaves rotation first, a
        grace period lets requests already routed to it complete, the
        replacement comes up READY before the victim dies, and only then
        is the old process stopped. Returns the fresh replica's port.
        Subprocess replicas re-read their spec/artifact from disk, so
        this is also how an updated on-disk model (or adapter bank) goes
        live with zero dropped requests."""
        with self._lock:
            idx = next((i for i, r in enumerate(self.replicas)
                        if r.port == int(port)), None)
            if idx is None:
                raise ValueError(f"no replica on port {port}")
            victim = self.replicas[idx]
        self.drain(victim.port)
        try:
            if grace_s > 0:
                time.sleep(grace_s)   # in-flight finishes off-rotation
            fresh = self._start_ready(wait_s=ready_wait_s)
        except Exception:
            self.undrain(victim.port)   # failed swap: keep serving
            raise
        with self._lock:
            if idx < len(self.replicas) and self.replicas[idx] is victim:
                self.replicas[idx] = fresh
            else:   # set changed underneath (scale event): keep both
                self.replicas.append(fresh)
        self.undrain(victim.port)
        try:
            victim.stop()
        except Exception:
            logger.exception("drained replica on :%d failed to stop",
                             victim.port)
        logger.info("replica :%d drained and restarted as :%d",
                    victim.port, fresh.port)
        return fresh.port

    def rolling_restart(self, grace_s: float = 0.5) -> None:
        """Drain-restart every replica one at a time from the CURRENT
        factory — the rolling reload the adapter hot-swap flow needs."""
        for port in list(self.ports(include_draining=True)):
            try:
                self.restart_replica(port, grace_s=grace_s)
            except ValueError:
                continue   # scaled away mid-rollout

    # --- health + rolling update (reference
    # ``device_replica_controller.py``: health-based replacement, one-at-a-
    # time rollout) -------------------------------------------------------
    def _probe(self, port: int, timeout: float = 2.0) -> bool:
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/ready", timeout=timeout) as r:
                return r.status == 200
        except Exception:
            return False

    def _start_ready(self, wait_s: float = 10.0):
        """Start a fresh replica and wait until it answers /ready —
        traffic must never be pointed at a cold server."""
        runner = self._new_replica()
        runner.start()
        deadline = time.time() + wait_s
        while time.time() < deadline:
            if self._probe(runner.port, timeout=1.0):
                return runner
            time.sleep(0.05)
        runner.stop()
        raise RuntimeError("replacement replica never became ready")

    def health_check(self) -> int:
        """Probe every replica; replace dead ones with fresh ready servers.
        Returns the number replaced. The autoscaler calls this each step —
        the set HEALS, it does not just resize."""
        with self._lock:
            snapshot = list(enumerate(self.replicas))
        replaced = 0
        for i, runner in snapshot:
            if self._probe(runner.port):
                continue
            logger.warning("replica on :%d failed health check — replacing",
                           runner.port)
            fresh = self._start_ready()
            with self._lock:
                if i < len(self.replicas) and self.replicas[i] is runner:
                    self.replicas[i] = fresh
                    self._draining.discard(runner.port)  # port may recycle
                    replaced += 1
                else:  # set changed underneath (scale event): discard
                    fresh.stop()
                    continue
            try:
                runner.stop()
            except Exception:
                pass
        return replaced

    def rolling_update(self, predictor_factory=None,
                       replica_factory=None) -> None:
        """Replace every replica with one built from the new factory,
        one at a time, new-up-and-ready before old-down — the gateway keeps
        serving throughout (reference rolling-upgrade flow)."""
        if replica_factory is not None:
            self.replica_factory = replica_factory
        elif predictor_factory is not None:
            if self.replica_factory is not None:
                # subprocess mode: a bare positional factory is a replica
                # factory
                self.replica_factory = predictor_factory
            else:
                self.predictor_factory = predictor_factory
        # both None: respawn from the CURRENT factory (subprocess mode
        # re-reads the spec/artifact from disk on every start, so a bare
        # rolling_update() rolls an updated on-disk model out)
        with self._lock:
            n = len(self.replicas)
        for i in range(n):
            fresh = self._start_ready()
            with self._lock:
                if i >= len(self.replicas):  # shrunk mid-rollout
                    fresh.stop()
                    return
                old = self.replicas[i]
                self.replicas[i] = fresh
            # drain: a request the gateway routed to `old` JUST before the
            # swap is still in flight — stopping immediately resets it.
            time.sleep(0.25)
            old.stop()

    def stop(self) -> None:
        with self._lock:
            for r in self.replicas:
                r.stop()
            self.replicas.clear()
            self._draining.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self.replicas)


# -------------------------------------------------------------- gateway ----

@dataclasses.dataclass
class GatewayMetrics:
    """Trailing-window request metrics. Iterates as the legacy
    ``(qps, mean_latency)`` pair so existing unpacking call sites keep
    working; ``p50``/``p99`` carry the tail the autoscaler policies can
    target."""
    qps: float
    latency_s: float     # mean
    p50: float
    p99: float
    count: int

    def __iter__(self):
        return iter((self.qps, self.latency_s))

    def signal(self, name: str) -> float:
        return {"mean": self.latency_s, "p50": self.p50,
                "p99": self.p99}[str(name)]


class Gateway:
    """Health-aware round-robin HTTP front over a ReplicaSet that records
    the QPS/latency series policies consume (reference inference
    gateway).

    Windowed tail stats live in ONE place: the ``core/obs``
    :class:`~fedml_tpu_torch.core.obs.metrics.LatencyWindow` (exact
    nearest-rank percentiles over the trailing window — the autoscaler's
    signal is never bucket-quantized). Every request's latency also
    lands in the registry histogram (``serving_gateway_latency_seconds``)
    for the ``/metrics`` exposition and JSONL snapshots. An active span
    on the calling thread is forwarded to the replica as a W3C
    ``traceparent`` header, so the replica-side request trace joins the
    caller's.

    Failover: routing consults replica health — a port that
    failed a connect or answered ``/healthz`` non-200 is quarantined for
    ``unhealthy_ttl_s`` and routed around; a retry never re-picks the
    port that just failed while an untried port remains (only once EVERY
    live port has failed this request does it fall back to re-picking —
    on a small fleet a transient flake beats refusing outright);
    draining replicas are excluded by ``ReplicaSet.ports()``. Retries
    pace themselves on the shared ``communication/backoff`` policy, and
    a replica 503 (load shed / parked-unhealthy engine) is routed around
    too — the request never reached a predictor, so re-routing is safe.
    Read timeouts and other HTTP errors DID reach a replica and surface
    unchanged."""

    def __init__(self, replica_set: ReplicaSet, window_s: float = 5.0,
                 unhealthy_ttl_s: float = 2.0, max_failovers: int = 3,
                 backoff_seed: Optional[int] = None, chaos=None,
                 cache_aware: bool = False, digest_chars: int = 128,
                 scrape_ttl_s: float = 1.0, spill_headroom: int = 1,
                 heal_probe: bool = False):
        from ..core.obs import metrics as obs_metrics
        self.replica_set = replica_set
        self.window_s = float(window_s)
        self.unhealthy_ttl_s = float(unhealthy_ttl_s)
        self.max_failovers = int(max_failovers)
        self.backoff_seed = backoff_seed
        self._chaos = chaos      # optional ServingChaosInjector
        # cache-aware routing (OFF = byte-identical routing):
        # a digest of the request's leading prompt bytes maps to the
        # replica whose prefix cache is warm for it; the warm pick is
        # admission-checked against the replica's KV headroom (a cheap
        # ttl-cached /healthz scrape) and spills to round-robin — without
        # rehoming — when the warm replica is saturated
        self.cache_aware = bool(cache_aware)
        self.digest_chars = int(digest_chars)
        self.scrape_ttl_s = float(scrape_ttl_s)
        self.spill_headroom = int(spill_headroom)
        # quarantine heal: OFF = legacy TTL-only rejoin;
        # ON = a quarantined port stays out past its TTL until heal()
        # probes it healthy (a sick replica can't flap back on a timer)
        self.heal_probe = bool(heal_probe)
        self._i = 0
        self._lock = threading.Lock()
        self._window = obs_metrics.LatencyWindow(window_s=self.window_s)
        self._unhealthy: dict = {}   # port -> quarantine expiry ts
        from collections import OrderedDict
        self._warm: "OrderedDict[str, int]" = OrderedDict()
        self._warm_cap = 4096
        self._slo_cache: dict = {}   # port -> (scrape_ts, headroom|None)
        # routing-decision tally (mirrors the obs counters; first-class
        # so benches/tests can read the split without registry scrapes)
        self.route_counts = {"warm_hit": 0, "warm_spill": 0, "cold": 0}

    # --- health cache ------------------------------------------------------
    def _mark_unhealthy(self, port: int, reason: str) -> None:
        from ..core.obs import metrics as obs_metrics
        with self._lock:
            self._unhealthy[int(port)] = time.time() + self.unhealthy_ttl_s
        obs_metrics.record_gateway_failover(reason)
        logger.warning("gateway: replica :%d quarantined (%s)", port,
                       reason)

    def _is_quarantined(self, port: int) -> bool:
        with self._lock:
            exp = self._unhealthy.get(int(port))
            if exp is None:
                return False
            if time.time() < exp:
                return True
            if not self.heal_probe:
                del self._unhealthy[int(port)]
                return False
        # TTL expired under heal_probe: the port is eligible — probe it
        # NOW (heal-on-demand). Routing must not depend on an external
        # heal() loop running: without this, one conn-drop quarantines
        # a warm home until the next autoscaler step, spilling every
        # request homed there. Self-rate-limited — a failing probe
        # re-arms the TTL, so a sick port costs at most one probe per
        # TTL window.
        return not self._heal_port(int(port))

    def heal(self) -> int:
        """Probe quarantined replicas whose TTL expired: a passing
        ``/healthz`` rejoins the port to rotation; a failing one re-arms
        the quarantine for another TTL. No-op with ``heal_probe`` off
        (legacy timer-only rejoin). Returns the number healed. The
        autoscaler calls this each step."""
        if not self.heal_probe:
            return 0
        now = time.time()
        with self._lock:
            expired = [p for p, exp in self._unhealthy.items()
                       if now >= exp]
        return sum(1 for port in expired if self._heal_port(port))

    def _heal_port(self, port: int) -> bool:
        """Probe ONE quarantine-expired port: a passing ``/healthz``
        rejoins it to rotation (True); a failing one re-arms the
        quarantine for another TTL (False). Called from ``heal()`` and
        inline from ``_is_quarantined`` (heal-on-demand at pick time)."""
        from ..core.obs import metrics as obs_metrics
        ok = False
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz",
                    timeout=1.0) as r:
                ok = r.status == 200
        except Exception:  # noqa: BLE001 — any failure = still sick
            ok = False
        with self._lock:
            if port not in self._unhealthy:
                return True   # raced with a concurrent heal/mark
            if ok:
                del self._unhealthy[port]
            else:
                self._unhealthy[port] = (time.time()
                                         + self.unhealthy_ttl_s)
        if ok:
            obs_metrics.record_gateway_heal(port)
            logger.info("gateway: replica :%d healed — rejoining "
                        "rotation", port)
        return ok

    def probe_health(self, port: int, timeout: float = 1.0) -> bool:
        """GET the replica's ``/healthz``; non-200 (a tripped watchdog,
        a parked engine) or no answer quarantines the port."""
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz",
                    timeout=timeout) as r:
                if r.status == 200:
                    return True
        except Exception:  # noqa: BLE001 — any failure = unhealthy
            pass
        self._mark_unhealthy(port, "healthz")
        return False

    # --- cache-aware routing ----------------------------------------------
    def _routing_digest(self, request: dict) -> Optional[str]:
        """Digest of the request's leading prompt bytes. Under the byte
        tokenizer one char is one token, so the first ``digest_chars``
        characters ARE the leading token blocks — same-system-prompt
        (and same-conversation-head) traffic shares a digest and sticks
        to the replica whose prefix cache already holds those blocks."""
        try:
            msgs = request.get("messages")
            if msgs:
                text = "\n".join(str(m.get("content", ""))
                                 for m in msgs if isinstance(m, dict))
            else:
                text = str(request.get("prompt")
                           or request.get("inputs") or "")
        except Exception:  # noqa: BLE001 — routing must never raise
            return None
        if not text:
            return None
        import hashlib
        return hashlib.sha1(
            text[:self.digest_chars].encode("utf-8", "replace")
        ).hexdigest()[:16]

    def _remember_warm(self, digest: str, port: int) -> None:
        with self._lock:
            self._warm[digest] = int(port)
            self._warm.move_to_end(digest)
            while len(self._warm) > self._warm_cap:
                self._warm.popitem(last=False)

    def _replica_headroom(self, port: int) -> Optional[int]:
        """KV admission headroom from a ttl-cached ``/healthz`` scrape —
        the warm pick's saturation check. None = unknown (no engine slo
        payload, or the replica did not answer); unknown never blocks
        routing."""
        now = time.time()
        with self._lock:
            ent = self._slo_cache.get(int(port))
            if ent is not None and now - ent[0] < self.scrape_ttl_s:
                return ent[1]
        headroom: Optional[int] = None
        try:
            try:
                r = urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=0.5)
            except urllib.error.HTTPError as e:
                r = e          # 503 still carries the health JSON body
            with r:
                h = json.load(r)
            hr = (h.get("slo") or {}).get("kv_headroom_requests")
            if hr is not None and int(hr) >= 0:
                headroom = int(hr)
        except Exception:  # noqa: BLE001
            headroom = None
        with self._lock:
            self._slo_cache[int(port)] = (now, headroom)
        return headroom

    def _pick_port(self, tried: set, verify_health: bool,
                   digest: Optional[str] = None) -> Optional[int]:
        """Next routable port: round-robin over live, non-draining,
        non-quarantined ports the request has not tried yet. With
        ``verify_health`` (retry attempts), the candidate's ``/healthz``
        is consulted before traffic lands on it. Falls back to
        quarantined-but-untried ports rather than refusing — a wrong
        quarantine must not 503 the fleet.

        With cache-aware routing and a ``digest``, the digest's warm
        replica wins while it is routable and has KV admission headroom;
        a saturated warm replica spills this request to round-robin
        WITHOUT rehoming the digest (its cache stays warm where it is);
        a digest whose home left the fleet — or one never seen — records
        the round-robin pick as its new home."""
        ports = self.replica_set.ports()
        route_outcome: Optional[str] = None
        if self.cache_aware and digest is not None and ports:
            from ..core.obs import metrics as obs_metrics
            with self._lock:
                warm = self._warm.get(digest)
            if warm is not None and warm in ports:
                if warm not in tried and not self._is_quarantined(warm):
                    headroom = self._replica_headroom(warm)
                    if headroom is None \
                            or headroom >= self.spill_headroom:
                        with self._lock:
                            self.route_counts["warm_hit"] += 1
                        obs_metrics.record_gateway_route("warm_hit")
                        return warm
                # saturated / tried / quarantined: spill, keep the home
                route_outcome = "warm_spill"
            else:
                route_outcome = "cold"   # new digest or home scaled away
        candidates = [p for p in ports
                      if p not in tried and not self._is_quarantined(p)]
        if not candidates:
            candidates = [p for p in ports if p not in tried]
        if not candidates:
            # every live port already failed this request once: a
            # last-resort re-pick (transient connect flake on a small
            # fleet) beats refusing while retry budget remains
            candidates = list(ports)
        while candidates:
            with self._lock:
                port = candidates[self._i % len(candidates)]
                self._i += 1
            if verify_health and len(candidates) > 1 \
                    and not self.probe_health(port):
                candidates.remove(port)
                continue
            if route_outcome is not None:
                from ..core.obs import metrics as obs_metrics
                if route_outcome == "cold":
                    self._remember_warm(digest, port)
                with self._lock:
                    self.route_counts[route_outcome] += 1
                obs_metrics.record_gateway_route(route_outcome)
            return port
        return None

    def _connect(self, request: dict, timeout: float, path: str):
        """The ONE failover loop (predict and stream share it): pick a
        routable port, ride out chaos connection drops, quarantine 503
        sheds (honoring the replica's Retry-After) and connection-phase
        failures, and return an OPEN ``HTTPResponse`` from the first
        replica that starts answering. Raises the last failure (or
        RuntimeError) once every attempt is spent."""
        from ..core.distributed.communication.backoff import backoff_delays
        from ..core.obs import trace as obs_trace
        body = json.dumps(request).encode()
        headers = {"Content-Type": "application/json"}
        cur = obs_trace.current_span()
        if cur is not None and cur.traceparent():
            headers["traceparent"] = cur.traceparent()
        delays = backoff_delays(base_s=0.05, factor=2.0, max_s=0.5,
                                seed=self.backoff_seed)
        digest = (self._routing_digest(request)
                  if self.cache_aware else None)
        tried: set = set()
        last_exc: Optional[Exception] = None
        for attempt in range(self.max_failovers + 1):
            port = self._pick_port(tried, verify_health=attempt > 0,
                                   digest=digest)
            if port is None:
                break   # every live port tried (or none live)
            tried.add(port)
            if self._chaos is not None and self._chaos.connection_drop():
                # injected gateway->replica connection drop: the fault
                # the failover path exists for, at its exact seam
                last_exc = ConnectionError(
                    f"chaos: injected connection drop to :{port}")
                self._mark_unhealthy(port, "conn_drop")
                time.sleep(next(delays))
                continue
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}{path}", data=body,
                headers=headers)
            try:
                return urllib.request.urlopen(req, timeout=timeout)
            except urllib.error.HTTPError as e:
                if e.code == 503:
                    # shed or parked-unhealthy replica: the request was
                    # refused before any predictor ran — routing around
                    # is safe, and the replica asked us to back off
                    self._mark_unhealthy(port, "http_503")
                    last_exc = e
                    retry_after = e.headers.get("Retry-After")
                    e.close()
                    delay = next(delays)
                    if retry_after:
                        try:
                            delay = min(float(retry_after), 2.0)
                        except ValueError:
                            pass
                    time.sleep(delay)
                    continue
                raise  # the replica answered; its answer stands
            except (urllib.error.URLError, OSError) as e:
                reason = getattr(e, "reason", e)
                if not isinstance(reason, ConnectionError):
                    raise   # read timeout etc: reached a replica
                # connection-phase failure: never re-pick this port for
                # THIS request, quarantine it for others
                self._mark_unhealthy(port, "connect")
                last_exc = e
                time.sleep(next(delays))
                continue
        if last_exc is not None:
            raise last_exc
        raise RuntimeError("no live replicas")

    def _observe_latency(self, t0: float) -> None:
        from ..core.obs import metrics as obs_metrics
        dt = time.perf_counter() - t0
        obs_metrics.record_gateway_latency(dt)
        self._window.observe(dt)

    def predict(self, request: dict, timeout: float = 30.0,
                path: str = "/predict") -> dict:
        """Route one request to a replica; ``path`` selects the replica
        route (e.g. ``/v1/chat/completions`` on LLM replicas)."""
        t0 = time.perf_counter()
        with self._connect(request, timeout, path) as r:
            out = json.load(r)
        self._observe_latency(t0)
        return out

    def stream(self, request: dict, timeout: float = 30.0,
               path: str = "/v1/chat/completions"):
        """Streaming pass-through: route one SSE request to a replica
        and yield each ``data:`` payload string as it arrives (the
        ``[DONE]`` terminator is consumed, not yielded). Failover (dead
        connect, 503 shed) applies only until the response starts —
        once frames are flowing the stream belongs to that replica and
        an error surfaces to the caller. A replica answering plain JSON
        (its ``llm_stream`` knob off) degrades gracefully: the whole
        body is yielded as the single event."""
        t0 = time.perf_counter()
        resp = self._connect(request, timeout, path)
        try:
            ctype = resp.headers.get("Content-Type", "")
            if "text/event-stream" not in ctype:
                yield resp.read().decode("utf-8", "replace")
            else:
                for raw in resp:
                    line = raw.decode("utf-8", "replace").strip()
                    if not line.startswith("data: "):
                        continue
                    data = line[len("data: "):]
                    if data == "[DONE]":
                        break
                    yield data
        finally:
            resp.close()
        self._observe_latency(t0)

    def metrics(self) -> GatewayMetrics:
        """Trailing-window :class:`GatewayMetrics` from the shared
        :class:`~fedml_tpu_torch.core.obs.metrics.LatencyWindow`. Unpacks as
        the legacy ``(qps, mean)`` pair."""
        qps, mean, p50, p99, n = self._window.stats()
        return GatewayMetrics(qps=qps, latency_s=mean,
                              p50=p50, p99=p99, count=n)


# ------------------------------------------------------------ autoscaler ----

class Autoscaler:
    """Applies a policy on a cadence (reference autoscaler daemon loop)."""

    def __init__(self, gateway: Gateway, policy, interval_s: float = 1.0):
        self.gateway = gateway
        self.policy = policy
        self.interval_s = float(interval_s)
        self.scale_events = 0            # replica-count changes applied
        self.last_fleet: Optional[FleetSLOView] = None
        self._running = False
        self._thread: Optional[threading.Thread] = None

    def _fleet_slo(self) -> FleetSLOView:
        """Scrape every replica's ``/healthz`` ``slo`` payload into one
        :class:`FleetSLOView` (worst-replica tails, summed queue, min
        headroom). Draining replicas are included — their in-flight tail
        is still the user's latency."""
        ports = self.gateway.replica_set.ports(include_draining=True)
        ttft: List[float] = []
        itl: List[float] = []
        queue = 0
        headrooms: List[int] = []
        for port in ports:
            try:
                try:
                    r = urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/healthz", timeout=1.0)
                except urllib.error.HTTPError as e:
                    r = e      # a 503 body still carries the health JSON
                with r:
                    h = json.load(r)
            except Exception:  # noqa: BLE001 — a dead replica scores 0
                continue
            queue += int(h.get("queue_depth", 0) or 0)
            slo = h.get("slo") or {}
            if int(slo.get("ttft_n", 0) or 0) > 0:
                ttft.append(float(slo.get("ttft_p99_s", 0.0)))
            if int(slo.get("itl_n", 0) or 0) > 0:
                itl.append(float(slo.get("itl_p99_s", 0.0)))
            hr = slo.get("kv_headroom_requests")
            if hr is not None and int(hr) >= 0:
                headrooms.append(int(hr))
        m = self.gateway.metrics()
        return FleetSLOView(
            ttft_p99_s=max(ttft) if ttft else 0.0,
            itl_p99_s=max(itl) if itl else 0.0,
            queue_depth=queue,
            kv_headroom_min=min(headrooms) if headrooms else None,
            gateway_p99_s=m.p99, replicas=len(ports))

    def step(self) -> int:
        """One evaluation: heal -> metrics -> desired -> scale. Returns the
        new replica count (also usable directly, without the daemon
        thread). Policies declaring a ``latency_signal`` ("mean" | "p50" |
        "p99") are fed that percentile from the gateway window — tail-
        latency-targeting autoscaling. A policy with a
        ``desired_from_fleet`` method (:class:`SLOPolicy`) is instead fed
        the aggregated per-replica SLO scrape."""
        from ..core.obs import metrics as obs_metrics
        self.gateway.replica_set.health_check()
        heal = getattr(self.gateway, "heal", None)
        if callable(heal):
            heal()
        current = len(self.gateway.replica_set)
        if hasattr(self.policy, "desired_from_fleet"):
            self.last_fleet = self._fleet_slo()
            desired = self.policy.desired_from_fleet(
                self.last_fleet, current)
        else:
            m = self.gateway.metrics()
            lat = m.signal(getattr(self.policy, "latency_signal", "mean"))
            desired = self.policy.desired_replicas(m.qps, lat, current)
        got = self.gateway.replica_set.scale_to(desired)
        after = len(self.gateway.replica_set)
        if after != current:
            self.scale_events += 1
            obs_metrics.record_fleet_scale(
                "up" if after > current else "down", after)
            logger.info("autoscaler: scaled %d -> %d replicas",
                        current, after)
        return got

    def start(self) -> None:
        self._running = True

        def loop():
            while self._running:
                try:
                    self.step()
                except Exception:  # noqa: BLE001 — daemon must survive
                    logger.exception("autoscaler step failed")
                time.sleep(self.interval_s)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
