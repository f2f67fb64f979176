"""Host-side task runtime: thread pool + staged pipeline.

Copy of ``partitionedhashjoin_tpu/utils/pipeline.py`` (importing that module
would import jax), the counterpart of the reference's L2 task runtime
(src/Common/IThreadPool.hpp:25-49, src/Common/ThreadPool.*).  On the device
side the runtime is the CUDA stream — kernels queued in order are the staged
pipeline — but the host side still needs one for ingest/IO orchestration
(feeding device transfers while the card computes, writing results, driving
sweeps).  The heavy lifting for generation itself lives in the native C++
pool (native/phj_host.cpp, bound by ``data/host_loader.py``); this Python
layer provides the reference's *API shape* for arbitrary host tasks:

- ``TasksErrorHolder``       <- IThreadPool.hpp:9-21 (stores real exceptions,
  fixing the reference's slicing bug, SURVEY.md appendix 5)
- ``ThreadPool.push(task | [tasks] | Pipeline) -> Future`` <- IThreadPool.hpp:36-49
- ``Pipeline.add([tasks])``  <- IThreadPool.hpp:25-34 — stage k+1 starts only
  after stage k drains; a failure short-circuits later stages but lets
  in-flight tasks finish (ThreadPool.cpp:99-146 semantics)
"""

from __future__ import annotations

import concurrent.futures
import os
import threading
from typing import Callable, List, Optional, Sequence, Union

Task = Callable[[], None]


class TasksErrorHolder(Exception):
    """Aggregated task failures (IThreadPool.hpp:9-21)."""

    def __init__(self) -> None:
        super().__init__("one or more pipeline tasks failed")
        self._errors: List[BaseException] = []
        self._lock = threading.Lock()

    def add(self, error: BaseException) -> None:
        with self._lock:
            self._errors.append(error)

    @property
    def errors(self) -> List[BaseException]:
        return list(self._errors)

    def empty(self) -> bool:
        return not self._errors

    def pop(self) -> BaseException:
        """First stored error (IThreadPool.cpp:16-27 analogue)."""
        return self._errors[0]


class Pipeline:
    """Staged batches of tasks; stages run in order, tasks within a stage in
    parallel (IThreadPool.hpp:25-34)."""

    def __init__(self) -> None:
        self._stages: List[List[Task]] = []

    def add(self, tasks: Sequence[Task]) -> "Pipeline":
        self._stages.append(list(tasks))
        return self

    @property
    def stages(self) -> List[List[Task]]:
        return self._stages


class ThreadPool:
    """Fixed-size worker pool with batch futures and pipeline execution.

    Worker count defaults to ``cpu_count - 1`` (src/main.cpp:235-241).
    """

    def __init__(self, workers: Optional[int] = None) -> None:
        if workers is None:
            workers = max(1, (os.cpu_count() or 2) - 1)
        self._workers = workers
        self._executor = concurrent.futures.ThreadPoolExecutor(workers)
        # batch/pipeline coordinators block on worker futures, so they run on
        # their own threads — coordinating from a worker thread would
        # deadlock a single-worker pool
        self._coordinator = concurrent.futures.ThreadPoolExecutor()

    def get_number_of_workers(self) -> int:
        return self._workers

    def push(
        self, work: Union[Task, Sequence[Task], Pipeline]
    ) -> concurrent.futures.Future:
        """Submit one task, a batch, or a pipeline; resolves to a
        TasksErrorHolder (empty on success), like IThreadPool::Push."""
        if isinstance(work, Pipeline):
            return self._coordinator.submit(self._run_pipeline, work.stages)
        if callable(work):
            work = [work]
        return self._coordinator.submit(self._run_stage, list(work))

    def _run_stage(self, tasks: List[Task]) -> TasksErrorHolder:
        holder = TasksErrorHolder()
        futures = [self._executor.submit(t) for t in tasks]
        for f in futures:
            try:
                f.result()
            except BaseException as e:  # noqa: BLE001 - aggregate everything
                holder.add(e)
        return holder

    def _run_pipeline(self, stages: List[List[Task]]) -> TasksErrorHolder:
        holder = TasksErrorHolder()
        for stage in stages:
            stage_holder = self._run_stage(stage)
            for e in stage_holder.errors:
                holder.add(e)
            if not stage_holder.empty():
                # failure short-circuits later stages (ThreadPool.cpp:109-133)
                break
        return holder

    def stop(self) -> None:
        """Drain and join workers (IThreadPool::Stop, ThreadPool.cpp:29-34)."""
        self._coordinator.shutdown(wait=True)
        self._executor.shutdown(wait=True)
