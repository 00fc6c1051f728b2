"""Host-side DAG scheduler: the jobTree replacement.

The reference orchestrates everything as retryable jobTree targets over
batch systems with the filesystem as the only channel
(reference nanopore/pipeline.py:207, SURVEY.md L1).  A copy of the JAX package's ``runtime/scheduler.py``.  Device-side
parallelism lives inside the CUDA kernels, so the host scheduler's
remit shrinks to: dependency ordering, bounded concurrency, retries,
skip-if-done resume, and per-task wall/CPU stats (the jobTree --stats
analogue, pipeline.sh:9).
"""

from __future__ import annotations

import json
import logging
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Optional

logger = logging.getLogger("nanopore_tpu_torch")


@dataclass
class Task:
    name: str
    fn: Callable[[], None]
    deps: list[str] = field(default_factory=list)
    retries: int = 1
    skip_if: Optional[Callable[[], bool]] = None


@dataclass
class TaskResult:
    name: str
    status: str  # "done" | "skipped" | "failed"
    wall_seconds: float = 0.0
    cpu_seconds: float = 0.0
    attempts: int = 0
    error: str = ""


class SchedulerError(RuntimeError):
    def __init__(self, failed: list[TaskResult]):
        self.failed = failed
        super().__init__(
            "Got failed jobs: %s" % ", ".join(r.name for r in failed)
        )


class Scheduler:
    """Topological execution with a bounded thread pool."""

    def __init__(self, max_workers: int = 4):
        self.max_workers = max_workers
        self._tasks: dict[str, Task] = {}

    def add(self, task: Task) -> None:
        assert task.name not in self._tasks, "duplicate task %s" % task.name
        self._tasks[task.name] = task

    def add_task(
        self, name: str, fn: Callable[[], None], deps: list[str] = (),
        retries: int = 1, skip_if=None,
    ) -> None:
        self.add(Task(name, fn, list(deps), retries, skip_if))

    # ------------------------------------------------------------------ #
    def run(self, stats_path: str | None = None) -> dict[str, TaskResult]:
        for task in self._tasks.values():
            for dep in task.deps:
                assert dep in self._tasks, (
                    "task %s depends on unknown %s" % (task.name, dep)
                )

        results: dict[str, TaskResult] = {}
        remaining_deps = {
            name: set(t.deps) for name, t in self._tasks.items()
        }
        dependents: dict[str, list[str]] = {n: [] for n in self._tasks}
        for name, task in self._tasks.items():
            for dep in task.deps:
                dependents[dep].append(name)

        lock = threading.Lock()
        cond = threading.Condition(lock)
        ready = [n for n, deps in remaining_deps.items() if not deps]
        in_flight: set[str] = set()
        failed_subtree: set[str] = set()

        def worker(name: str) -> None:
            task = self._tasks[name]
            result = TaskResult(name=name, status="failed")
            t0 = time.time()
            c0 = time.process_time()
            try:
                if task.skip_if is not None and task.skip_if():
                    result.status = "skipped"
                else:
                    last_exc = None
                    for attempt in range(max(task.retries, 1)):
                        result.attempts = attempt + 1
                        try:
                            task.fn()
                            last_exc = None
                            break
                        except Exception as exc:  # retryable
                            last_exc = exc
                            logger.warning(
                                "task %s attempt %d failed: %s",
                                name, attempt + 1, exc,
                            )
                    if last_exc is not None:
                        raise last_exc
                    result.status = "done"
            except Exception:
                result.status = "failed"
                result.error = traceback.format_exc(limit=20)
            result.wall_seconds = time.time() - t0
            result.cpu_seconds = time.process_time() - c0
            with cond:
                results[name] = result
                in_flight.discard(name)
                if result.status == "failed":
                    stack = list(dependents[name])
                    while stack:
                        child = stack.pop()
                        if child not in failed_subtree:
                            failed_subtree.add(child)
                            stack.extend(dependents[child])
                else:
                    for child in dependents[name]:
                        remaining_deps[child].discard(name)
                        if not remaining_deps[child]:
                            ready.append(child)
                cond.notify_all()

        with ThreadPoolExecutor(max_workers=self.max_workers) as pool:
            with cond:
                while len(results) < len(self._tasks):
                    # resolve tasks whose upstream failed
                    for name in list(failed_subtree):
                        if name not in results and name not in in_flight:
                            results[name] = TaskResult(
                                name=name, status="failed",
                                error="upstream dependency failed",
                            )
                    while ready:
                        name = ready.pop()
                        if name in results or name in in_flight:
                            continue
                        if name in failed_subtree:
                            results[name] = TaskResult(
                                name=name, status="failed",
                                error="upstream dependency failed",
                            )
                            continue
                        in_flight.add(name)
                        pool.submit(worker, name)
                    if len(results) >= len(self._tasks):
                        break
                    if not in_flight and not ready:
                        # every remaining task is unreachable (cycle or
                        # failed upstream) — resolve as failed
                        for name, task in self._tasks.items():
                            if name not in results:
                                results[name] = TaskResult(
                                    name=name, status="failed",
                                    error="unreachable (dependency cycle "
                                          "or failed upstream)",
                                )
                        break
                    cond.wait(timeout=1.0)

        if stats_path:
            with open(stats_path, "w") as fh:
                json.dump(
                    {
                        name: {
                            "status": r.status,
                            "wall_seconds": round(r.wall_seconds, 3),
                            "cpu_seconds": round(r.cpu_seconds, 3),
                            "attempts": r.attempts,
                            "error": r.error,
                        }
                        for name, r in results.items()
                    },
                    fh,
                    indent=2,
                )

        failed = [r for r in results.values() if r.status == "failed"]
        if failed:
            for r in failed:
                if r.error and "upstream" not in r.error:
                    logger.error("task %s failed:\n%s", r.name, r.error)
            raise SchedulerError(failed)
        return results
