"""Workflow: a DAG of jobs with dependencies, executed locally (a copy of
``fedml_tpu/workflow``; a launch job goes through the port's api).

Parity target: reference ``workflow/workflow.py:42-111`` + ``jobs.py`` (a
``Workflow`` of ``Job`` nodes with dependency edges; each job is a platform
launch). Local-first redesign: a job is either a python callable or a job
yaml launched through :mod:`fedml_tpu_torch.api`; ``run()`` executes in
dependency (topological) order, independent ready jobs run concurrently on
a thread pool, failures cancel dependents, and each job's output is made
available to its dependents via ``workflow.outputs``.
"""

from __future__ import annotations

import enum
import logging
from abc import ABC, abstractmethod
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger(__name__)


class JobStatus(enum.Enum):
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    FINISHED = "FINISHED"
    FAILED = "FAILED"
    CANCELLED = "CANCELLED"


class Job(ABC):
    """One node of the workflow DAG (reference ``jobs.py`` Job ABC)."""

    def __init__(self, name: str):
        self.name = name
        self.status = JobStatus.PENDING
        self.output: Any = None
        self.error: Optional[BaseException] = None
        self.dependencies: List["Job"] = []

    @abstractmethod
    def run(self, inputs: Dict[str, Any]) -> Any:
        """Execute; ``inputs`` maps dependency name → its output."""

    def kill(self) -> None:
        """Best-effort cancellation hook (launch jobs stop their run)."""


class CallableJob(Job):
    """Wrap a python callable. The callable may accept zero args or one
    (the inputs dict)."""

    def __init__(self, name: str, fn: Callable[..., Any]):
        super().__init__(name)
        self.fn = fn

    def run(self, inputs: Dict[str, Any]) -> Any:
        try:
            return self.fn(inputs)
        except TypeError:
            # zero-arg callables are common; detect by signature, not by
            # swallowing errors from the body (advisor finding on flow)
            import inspect
            if len(inspect.signature(self.fn).parameters) == 0:
                return self.fn()
            raise


class LaunchJob(Job):
    """Launch a job yaml via the local platform and wait for completion."""

    def __init__(self, name: str, yaml_file: str,
                 poll_interval_s: float = 0.5):
        super().__init__(name)
        self.yaml_file = yaml_file
        self.poll_interval_s = poll_interval_s
        self.run_id: Optional[str] = None

    def run(self, inputs: Dict[str, Any]) -> Any:
        import time

        from .. import api
        res = api.launch_job(self.yaml_file)
        if res.result_code != 0:
            raise RuntimeError(f"launch failed: {res.result_message}")
        self.run_id = res.run_id
        while True:
            status = api.run_status(self.run_id)
            if status == api.STATUS_FINISHED:
                return {"run_id": self.run_id,
                        "logs": api.run_logs(self.run_id, tail=20)}
            if status in (api.STATUS_FAILED, api.STATUS_KILLED, None):
                raise RuntimeError(
                    f"job {self.name} ({self.run_id}) ended {status}; last "
                    f"log lines: "
                    f"{api.run_logs(self.run_id, tail=5) if self.run_id else []}")
            time.sleep(self.poll_interval_s)

    def kill(self) -> None:
        from .. import api
        if self.run_id:
            api.run_stop(self.run_id)


class Workflow:
    """DAG of jobs (reference ``workflow.py:42``: ``add_job(job,
    dependencies)``, ``run()``)."""

    def __init__(self, name: str = "workflow", max_workers: int = 4):
        self.name = name
        self.jobs: Dict[str, Job] = {}
        self.max_workers = max_workers
        self.outputs: Dict[str, Any] = {}

    def add_job(self, job: Job,
                dependencies: Optional[List[Job]] = None) -> Job:
        if job.name in self.jobs:
            raise ValueError(f"job {job.name!r} already in workflow")
        for dep in dependencies or []:
            if dep.name not in self.jobs:
                raise ValueError(
                    f"dependency {dep.name!r} must be added before "
                    f"{job.name!r}")
        job.dependencies = list(dependencies or [])
        self.jobs[job.name] = job
        return job

    def _check_acyclic(self) -> None:
        seen: Dict[str, int] = {}  # 0=visiting 1=done

        def visit(j: Job) -> None:
            state = seen.get(j.name)
            if state == 0:
                raise ValueError(f"cyclic dependency through {j.name!r}")
            if state == 1:
                return
            seen[j.name] = 0
            for d in j.dependencies:
                visit(d)
            seen[j.name] = 1

        for j in self.jobs.values():
            visit(j)

    def run(self) -> Dict[str, Any]:
        """Execute the DAG; returns ``{job_name: output}``. Raises after all
        runnable jobs finish if any job failed."""
        self._check_acyclic()
        pending = dict(self.jobs)
        futures: Dict[Future, Job] = {}

        def ready(j: Job) -> bool:
            return all(d.status == JobStatus.FINISHED
                       for d in j.dependencies)

        def blocked_forever(j: Job) -> bool:
            return any(d.status in (JobStatus.FAILED, JobStatus.CANCELLED)
                       for d in j.dependencies)

        def launch(j: Job, pool: ThreadPoolExecutor) -> None:
            j.status = JobStatus.RUNNING
            inputs = {d.name: d.output for d in j.dependencies}

            def body() -> Any:
                logger.info("workflow %s: job %s starting", self.name, j.name)
                return j.run(inputs)

            futures[pool.submit(body)] = j

        with ThreadPoolExecutor(max_workers=self.max_workers) as pool:
            while pending or futures:
                for name in [n for n, j in pending.items() if ready(j)]:
                    launch(pending.pop(name), pool)
                for name in [n for n, j in pending.items()
                             if blocked_forever(j)]:
                    pending[name].status = JobStatus.CANCELLED
                    del pending[name]
                if not futures:
                    if pending:  # nothing running, nothing ready: stuck
                        for j in pending.values():
                            j.status = JobStatus.CANCELLED
                        pending.clear()
                    continue
                done, _ = wait(list(futures), return_when=FIRST_COMPLETED)
                for fut in done:
                    j = futures.pop(fut)
                    try:
                        j.output = fut.result()
                        j.status = JobStatus.FINISHED
                        self.outputs[j.name] = j.output
                        logger.info("workflow %s: job %s finished",
                                    self.name, j.name)
                    except BaseException as e:  # noqa: BLE001
                        j.error = e
                        j.status = JobStatus.FAILED
                        logger.error("workflow %s: job %s FAILED: %s",
                                     self.name, j.name, e)
        failed = [j for j in self.jobs.values()
                  if j.status == JobStatus.FAILED]
        if failed:
            raise RuntimeError(
                f"workflow {self.name}: {len(failed)} job(s) failed: "
                + ", ".join(f"{j.name} ({j.error})" for j in failed))
        return dict(self.outputs)

    def status(self) -> Dict[str, str]:
        return {n: j.status.value for n, j in self.jobs.items()}
