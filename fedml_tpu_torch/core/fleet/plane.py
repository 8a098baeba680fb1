"""Multi-tenant task plane: N concurrent FL tasks over one registry.

Bonawitz et al. (MLSys'19, §4) run many FL *tasks* — training jobs,
federated analytics, on-device personalization — against one shared
device population, with per-task eligibility and pace steering arbitrated
by the coordinator. :class:`TaskPlane` is that coordinator for this
repo's control plane:

* every task gets its own :class:`StreamingCohortAssembler` (own jitter
  stream — concurrent tasks spread over the population instead of all
  chasing the same top-utility devices) and its own
  :class:`DeadlinePacer` (per-task deadline / over-sample / cohort-scale
  posture);
* all tasks share ONE :class:`ClientStatsStore` — availability, latency,
  and reputation evidence observed by any task benefits every task (the
  reputation store, fleet-wide);
* fairness is the registry's job: a device serves at most one task per
  round (the ``claims`` primary key) and at most
  ``fleet_max_rounds_per_window`` rounds in the trailing
  ``fleet_fairness_window_s`` (participation history), both enforced
  atomically in :meth:`DeviceRegistry.claim`.

The plane is deterministic under a logical clock: every method takes an
optional ``now``, and the assembler/pacer trajectories are pure
functions of the observation history — which is what makes
restart-and-resume replay *identical* cohorts, assertable in tests.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..obs import metrics as obs_metrics
from ..selection import (DeadlinePacer, StreamingCohortAssembler,
                         make_stats_store, required_eligibility)
from ..selection.cohort import eligible_mask
from .registry import DeviceRegistry

logger = logging.getLogger(__name__)


class _TaskArgs:
    """Args proxy with a per-task ``random_seed`` — each task's assembler
    gets its own jitter stream (splitmix of the base seed and the task
    name) while every other knob passes through untouched."""

    def __init__(self, args, task_id: str):
        self._args = args
        base = int(getattr(args, "random_seed", 0) or 0)
        h = 0
        for ch in str(task_id):
            h = (h * 131 + ord(ch)) & 0x7FFFFFFF
        self.random_seed = (base * 1_000_003 + h) & 0x7FFFFFFF

    def __getattr__(self, name):
        return getattr(self._args, name)


class FleetTask:
    """One tenant: a named federated job with its own pacing posture."""

    def __init__(self, plane: "TaskPlane", task_id: str, cohort_k: int,
                 kind: str = "training",
                 require: Optional[Tuple[str, ...]] = None):
        self.task_id = str(task_id)
        self.kind = str(kind)
        self.cohort_k = int(cohort_k)
        self.require = (tuple(require) if require is not None
                        else required_eligibility(plane.args))
        targs = _TaskArgs(plane.args, self.task_id)
        self.assembler = StreamingCohortAssembler(targs, plane.stats,
                                                  plane.population)
        self.pacer = DeadlinePacer.from_args(plane.args)
        self.last_cohort: List[int] = []
        self.last_utility = 0.0
        self.rounds_run = 0

    def state_key(self) -> str:
        return f"pacer:{self.task_id}"


class TaskPlane:
    """N concurrent federated tasks over one :class:`DeviceRegistry`."""

    def __init__(self, args, registry: DeviceRegistry, population: int):
        self.args = args
        self.registry = registry
        self.population = int(population)
        # ONE stats store for the whole fleet — reputation/availability
        # evidence is shared across tenants (sparse backend at scale via
        # the selection_store knob, as everywhere else)
        self.stats = make_stats_store(args, self.population)
        self.cap = int(getattr(args, "fleet_max_rounds_per_window", 0)
                       or 0)
        self.window_s = float(getattr(args, "fleet_fairness_window_s",
                                      3600.0) or 3600.0)
        self.tasks: List[FleetTask] = []
        self.round_cursor = 0
        self.denied_busy = 0
        self.denied_cap = 0

    def add_task(self, task_id: str, cohort_k: int, kind: str = "training",
                 require: Optional[Tuple[str, ...]] = None) -> FleetTask:
        if any(t.task_id == str(task_id) for t in self.tasks):
            raise ValueError(f"fleet task {task_id!r} already exists")
        task = FleetTask(self, task_id, cohort_k, kind=kind,
                         require=require)
        self.tasks.append(task)
        return task

    def task(self, task_id: str) -> FleetTask:
        for t in self.tasks:
            if t.task_id == str(task_id):
                return t
        raise KeyError(task_id)

    # --- the per-round assignment -------------------------------------------
    def _eligible_fn(self, task: FleetTask, taken: set,
                     now: Optional[float]):
        """Chunk predicate: handshake eligibility ∧ not assigned to
        another task this round ∧ under the participation cap. The
        registry's atomic claim re-checks busy/cap — this pre-filter
        keeps the assembler from wasting its top-k on devices the claim
        would bounce."""
        held = self.registry.active_claims()

        def elig(ids: np.ndarray) -> np.ndarray:
            mask = np.asarray(
                [d not in taken
                 and held.get(d, task.task_id) == task.task_id
                 for d in ids.tolist()], bool)
            if task.require and mask.any():
                metas = self.registry.eligibility_for(ids[mask])
                sub = eligible_mask(metas, task.require)
                mask[np.flatnonzero(mask)] = sub
            if self.cap and mask.any():
                counts = self.registry.participation_counts(
                    ids[mask], self.window_s, now=now)
                keep = counts < self.cap
                mask[np.flatnonzero(mask)] = keep
            return mask

        return elig

    def assign_round(self, round_idx: Optional[int] = None,
                     now: Optional[float] = None) -> Dict[str, List[int]]:
        """One fleet round: each task assembles its cohort over the
        registry population (fairness pre-filtered), then claims it
        atomically. Returns ``{task_id: cohort}`` — disjoint by
        construction AND by the claims table."""
        if round_idx is None:
            round_idx = self.round_cursor
        round_idx = int(round_idx)
        taken: set = set()
        out: Dict[str, List[int]] = {}
        for task in self.tasks:
            k = task.pacer.paced_cohort(task.cohort_k)
            target = task.pacer.target_cohort(k)
            res = task.assembler.assemble(
                round_idx, target,
                self.registry.iter_id_chunks(task.assembler.chunk),
                eligible_fn=self._eligible_fn(task, taken, now),
                deadline_s=task.pacer.deadline_s,
                over_sample=task.pacer.over_sample)
            granted, busy, capped = self.registry.claim(
                task.task_id, res.cohort, round_idx, cap=self.cap,
                window_s=self.window_s, now=now)
            self.denied_busy += busy
            self.denied_cap += capped
            task.last_cohort = list(granted)
            # aggregate statistical utility of the picked cohort — the
            # pacer's saturation signal (Oort: grow k when this plateaus)
            if res.scores is not None and len(granted):
                pos = {int(c): i for i, c in enumerate(res.cohort)}
                task.last_utility = float(sum(
                    res.scores[pos[d]] for d in granted if d in pos))
            else:
                task.last_utility = 0.0
            self.stats.record_selected(round_idx, granted)
            out[task.task_id] = list(granted)
            taken.update(granted)
            obs_metrics.record_fleet_round(task.task_id, len(granted),
                                           busy, capped)
        self.round_cursor = round_idx + 1
        return out

    def observe_round(self, task_id: str, reported: Sequence[int],
                      round_idx: Optional[int] = None, wall_s: float = 0.0,
                      now: Optional[float] = None) -> None:
        """Close one task's round: availability evidence for its cohort,
        the pacer's deadline/over-sample step + utility-saturation step,
        and the registry release (claims dropped, participation
        recorded for the devices that actually served)."""
        task = self.task(task_id)
        if round_idx is None:
            round_idx = self.round_cursor - 1
        reported = [int(d) for d in reported]
        rep = set(reported)
        for d in task.last_cohort:
            self.stats.record_availability(d, participated=d in rep)
        k = task.pacer.paced_cohort(task.cohort_k)
        task.pacer.observe_round(
            completed=len(rep & set(task.last_cohort)),
            expected=min(k, max(len(task.last_cohort), 1)),
            wall_s=float(wall_s))
        task.pacer.observe_utility(task.last_utility)
        self.registry.release(task.task_id, int(round_idx), reported,
                              now=now)
        task.rounds_run += 1

    # --- persistence --------------------------------------------------------
    _STATS_KEY = "fleet:stats"
    _PLANE_KEY = "fleet:plane"

    def save(self, now: Optional[float] = None) -> None:
        """Checkpoint the control plane into the registry: the shared
        stats store, every task's pacer posture, and the round cursor.
        A restarted plane resumes the learned posture — replaying
        identical cohorts, not re-learning the fleet."""
        self.registry.save_state(self._STATS_KEY, self.stats.state_dict(),
                                 now=now)
        for task in self.tasks:
            self.registry.save_state(f"fleet:{task.state_key()}",
                                     task.pacer.state_dict(), now=now)
        self.registry.save_state(
            self._PLANE_KEY,
            {"round_cursor": np.int64(self.round_cursor)}, now=now)

    def load(self) -> bool:
        """Restore a :meth:`save` snapshot; False = nothing persisted
        (fresh registry — start cold). Tasks must be added first, with
        the same ids as at save time."""
        st = self.registry.load_state(self._STATS_KEY)
        if st is None:
            return False
        self.stats.load_state_dict(st)
        for task in self.tasks:
            pst = self.registry.load_state(f"fleet:{task.state_key()}")
            if pst is not None:
                task.pacer.load_state_dict(pst)
        plane = self.registry.load_state(self._PLANE_KEY)
        if plane is not None:
            self.round_cursor = int(plane["round_cursor"])
        return True
