"""Fault injection + fault-tolerance policy for the ready-queue executor.

Since DESIGN.md §12 the supervisor no longer runs its own barrier round
loop — execution, overflow retries, failure rerouting, and speculative
straggler re-dispatch all live in ``Executor.execute``'s ready-queue walk
(first-completion-wins, event-timeline accounting included).  What
remains here is *policy and injection*:

* **fault injection** — ``fault_rate`` makes job attempts raise
  :class:`SimulatedFault` (a stand-in for preempted / failed workers)
  through the executor's ``on_job`` hook; the executor reroutes the job
  up to ``max_restarts`` times (the ``TransientFault`` retry path,
  sharing one :class:`~repro_torch.core.executor.RetryState` with overflow
  recovery).
* **policy config** — ``speculative``/``straggler_factor`` map onto the
  executor's ``speculate``/``spec_factor`` (the cost-model-scaled
  deadline of ``costmodel.speculation_deadline``; whole-job re-dispatch
  replaces Hadoop's per-task speculation since tasks are short on the card).
* **capacity faults** — exact shuffle-overflow detection; the executor's
  capacity ladder retries with cleared slack / doubled capacity
  (Hadoop's "task retry with more memory" analogue), surfaced here as
  ``FTStats.capacity_retries``.

The same module supervises the training loop via :func:`run_train_loop`:
checkpoint every N steps, crash injection, resume-from-latest.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from repro_torch.core.executor import (  # noqa: F401  (fault taxonomy re-exported)
    CapacityFault,
    Executor,
    PermanentFault,
    Report,
    ShardLoss,
    TransientFault,
)
from repro_torch.obs.metrics import MetricRegistry, counter_attr


class SimulatedFault(TransientFault):
    """An injected worker failure; retryable by the executor's ready-queue
    walk (it subclasses :class:`~repro_torch.core.executor.TransientFault`)."""


@dataclass
class FTConfig:
    fault_rate: float = 0.0
    straggler_factor: float = 3.0
    speculative: bool = True
    max_restarts: int = 5
    seed: int = 0
    #: probability, per job attempt, that one shard of one base relation
    #: the job reads is lost (the injector damages ``executor.env`` via
    #: ``ft/elastic.lose_shard`` *then* raises ShardLoss, so the
    #: executor's lineage-recovery path is genuinely exercised).
    shard_loss_rate: float = 0.0


class FTStats:
    """Fault-tolerance counters, registry-backed (DESIGN.md §14).

    The attribute API of the old dataclass is preserved as properties
    over ``ft.*`` counters in a :class:`~repro_torch.obs.MetricRegistry`, so a
    supervisor can share one registry with the service/executor metrics
    while every existing ``stats.retries`` read keeps working.
    """

    def __init__(self, metrics=None):
        self.metrics = metrics if metrics is not None else MetricRegistry()

    faults_injected = counter_attr("ft.fault.injected")
    retries = counter_attr("ft.fault.reroutes")
    speculative_redispatches = counter_attr("ft.speculative.redispatches")
    capacity_retries = counter_attr("ft.capacity.retries")
    shard_losses = counter_attr("ft.shard.losses")
    shard_recoveries = counter_attr("ft.shard.recoveries")

    _FIELDS = ("faults_injected", "retries", "speculative_redispatches",
               "capacity_retries", "shard_losses", "shard_recoveries")

    def as_dict(self) -> dict:
        return {name: getattr(self, name) for name in self._FIELDS}

    def __repr__(self) -> str:
        body = ", ".join(f"{k}={v}" for k, v in self.as_dict().items())
        return f"FTStats({body})"


class Supervisor:
    """Applies the FT policy to an executor and injects faults.

    For the duration of :meth:`execute` the executor's config is
    policy-extended (``speculate``/``spec_factor`` from the FT config —
    restored afterwards, the caller's ExecutorConfig is never retained)
    and the ready-queue walk is driven with the injection hook; records
    carry the full event timeline, and speculative attempts appear as
    duplicate :class:`~repro_torch.core.executor.JobRecord`\\ s with
    ``attempt``/``speculative`` set (DESIGN.md §12).  Speculation
    deadlines need modeled job costs: an executor constructed with
    ``stats=...`` gets them derived here (mirroring the slot scheduler's
    admission-time estimate); without statistics the deadline is
    unpriceable and re-dispatch stays off.
    """

    def __init__(self, executor: Executor, config: FTConfig | None = None,
                 *, metrics=None):
        self.ex = executor
        self.cfg = config or FTConfig()
        self.rng = np.random.default_rng(self.cfg.seed)
        # share the executor's registry by default so ft.* counters land
        # next to its msj.* metrics (DESIGN.md §14)
        self.stats = FTStats(metrics if metrics is not None else executor.metrics)

    def _inject(self, job, attempt: int) -> None:
        """The executor's ``on_job`` hook: one biased coin per attempt."""
        if attempt > 1:
            self.stats.retries += 1
        if self.rng.random() < self.cfg.shard_loss_rate:
            self._lose_shard(job)
        if self.rng.random() < self.cfg.fault_rate:
            self.stats.faults_injected += 1
            raise SimulatedFault(f"injected fault on {job}")

    def _lose_shard(self, job) -> None:
        """Damage one recoverable input partition *in the executor's live
        environment*, then raise :class:`ShardLoss` — losses that only
        raise without damaging would let a broken recovery path pass."""
        from repro_torch.core.planner import job_reads
        from repro_torch.ft.elastic import lose_shard

        candidates = sorted(job_reads(job) & self.ex.lineage.keys())
        candidates = [r for r in candidates if r in self.ex.env]
        if not candidates:
            return  # job reads no recoverable base relation; nothing to lose
        rel_name = candidates[int(self.rng.integers(len(candidates)))]
        rel = self.ex.env[rel_name]
        shard = int(self.rng.integers(rel.P))
        self.ex.env[rel_name] = lose_shard(rel, shard)
        self.stats.shard_losses += 1
        raise ShardLoss(rel_name, shard)

    def _estimate(self, plan) -> dict[int, float] | None:
        """Modeled per-job costs for LPT ordering and speculation
        deadlines, when the executor carries catalog statistics (the same
        derivation the slot scheduler uses at admission time)."""
        if self.ex.stats is None:
            return None
        from repro_torch.core.planner import estimate_job_costs, job_dag

        return estimate_job_costs(
            job_dag(plan, edges=self.ex.config.dag_edges), self.ex.stats
        )

    def execute(self, plan, *, wall_scale=None) -> tuple[dict, Report]:
        base = self.ex.config
        self.ex.config = replace(
            base,
            speculate=self.cfg.speculative,
            spec_factor=self.cfg.straggler_factor,
        )
        try:
            env, report = self.ex.execute(
                plan,
                est=self._estimate(plan),
                on_job=self._inject,
                max_restarts=self.cfg.max_restarts,
                wall_scale=wall_scale,
            )
        finally:
            self.ex.config = base
            # accumulate counters even when execute raises (exhausted
            # restarts under fail_policy="abort", a CapacityFault past the
            # ladder): the retries that led up to the failure happened and
            # must be accounted
            self.stats.capacity_retries += self.ex.ft_counters["overflow_retries"]
            self.stats.speculative_redispatches += self.ex.ft_counters["speculative"]
            self.stats.shard_recoveries += self.ex.ft_counters["shard_recoveries"]
        return env, report



def run_train_loop(
    state,
    train_step,
    batches,
    *,
    steps: int,
    ckpt_dir: str,
    ckpt_every: int = 50,
    crash_at: int | None = None,
    log_every: int = 10,
):
    """Checkpointed training loop with optional crash injection + resume.

    Returns (state, history).  If a checkpoint exists in ``ckpt_dir`` the
    loop resumes after its step — calling this twice around a simulated
    crash exercises the restart path end to end.  The checkpoint loads onto
    the device of the given state's parameters; the reference's ``mesh``
    (reshard-on-load) waits for the multi-card port.
    """
    from repro_torch.ckpt import checkpoint

    start = 0
    last = checkpoint.latest_step(ckpt_dir)
    if last is not None:
        state = checkpoint.load(ckpt_dir, last, state, device=state["params"].device)
        start = last
    history = []
    for step in range(start, steps):
        batch = batches(step)
        state, metrics = train_step(state, batch)
        if crash_at is not None and step + 1 == crash_at:
            raise SimulatedFault(f"injected crash at step {crash_at}")
        if (step + 1) % ckpt_every == 0 or step + 1 == steps:
            checkpoint.save(ckpt_dir, step + 1, state)
        if (step + 1) % log_every == 0:
            history.append((step + 1, float(metrics["loss"])))
    return state, history
