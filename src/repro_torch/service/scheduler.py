"""Slot-limited scheduling front-end: admission-time cost estimates for
the executor's ready-queue walk.

The execution engine itself lives in ``Executor.execute`` (DESIGN.md
§11): the plan's job DAG is walked online, launching any job whose
predecessors have completed as soon as one of the W cluster slots frees
(event-driven list scheduling), or — behind
``ExecutorConfig.execution_mode="waves"`` — as the legacy barrier waves.
What remains here is the *admission-time* side of the old static LPT
plan:

* per-job modeled costs (`planner.job_cost` over the catalog statistics)
  are derived once per plan — over the executor's configured job-DAG edge
  mode (relation-granular by default, DESIGN.md §12) — and handed to the
  executor, which uses them to order its ready queue longest-first (LPT
  list scheduling, the classic 4/3-approximation) and to scale the
  speculative re-dispatch deadlines (`costmodel.speculation_deadline`);
* the W bound is forwarded and the executor's dispatch log
  (:class:`~repro_torch.core.executor.ScheduledJob` entries with the event
  timeline and the estimate that ordered each dispatch, speculative
  clones included) is retained on ``self.schedule`` for introspection.

Jobs still *execute* serially on this container (SimComm serializes
shard work onto the host — DESIGN.md §8), so the slot/start/end timeline
is an accounting and admission-order concern, exactly like the round
structure before it.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.core.costmodel import CostConstants, HADOOP, Stats
from repro_torch.core.executor import Executor, Report, ScheduledJob  # re-export
from repro_torch.core.planner import Plan, estimate_job_costs, job_dag

__all__ = ["ScheduledJob", "SlotScheduler"]


class SlotScheduler:
    """Drives an :class:`Executor` under a W-slot budget with LPT cost
    estimates from catalog statistics."""

    def __init__(
        self,
        executor: Executor,
        *,
        slots: int | None = None,
        stats: Stats | None = None,
        consts: CostConstants = HADOOP,
        model: str = "gumbo",
    ):
        if slots is not None and slots < 1:
            raise ValueError(f"slots must be >= 1 or None (unbounded), got {slots}")
        self.executor = executor
        self.slots = slots
        self.stats = stats
        self.consts = consts
        self.model = model
        self.schedule: list[ScheduledJob] = []

    def _estimate(self, nodes) -> dict[int, float]:
        """Modeled per-job cost for LPT ordering (0.0 without statistics)."""
        if self.stats is None:
            return {n.idx: 0.0 for n in nodes}
        return estimate_job_costs(nodes, self.stats, self.consts, model=self.model)

    def execute(
        self,
        plan: Plan,
        *,
        on_job: Callable | None = None,
        max_restarts: int = 0,
        wall_scale: Callable | None = None,
    ) -> tuple[dict, Report]:
        # must mirror the executor's own node set exactly — under overlap
        # (and the skew defense) the DAG holds sub-nodes whose costs the
        # model prices separately (msj_transfer_cost / msj_compute_cost /
        # msj_profile_cost)
        est = self._estimate(job_dag(
            plan,
            edges=self.executor.config.dag_edges,
            overlap=self.executor.config.overlap,
            skew=self.executor.config.skew_defense,
        ))
        env, report = self.executor.execute(
            plan, slots=self.slots, est=est, on_job=on_job,
            max_restarts=max_restarts, wall_scale=wall_scale,
        )
        self.schedule = list(self.executor.schedule)
        return env, report

    @property
    def n_slots_used(self) -> int:
        return len({s.slot for s in self.schedule})
