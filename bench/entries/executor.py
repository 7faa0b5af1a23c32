"""One client in a closed loop over the executor: each request plans the
configuration's queries (``"plan"`` of the traffic file: ``one_round``, or
``greedy`` with the statistics of the database taken per request, as a user
pays them), runs the plan with ``Executor.execute`` on ``SimComm(P)`` under
the default ``ExecutorConfig`` and waits for the device."""
from __future__ import annotations

from bench import program
from bench.reference import datagen
from repro_torch.core.costmodel import HADOOP, stats_of_db
from repro_torch.core.executor import Executor, ExecutorConfig
from repro_torch.core.planner import plan_greedy, plan_one_round
from repro_torch.engine.comm import SimComm

PLANS = {
    "one_round": lambda queries, db: plan_one_round(queries),
    "greedy": lambda queries, db: plan_greedy(queries, stats_of_db(db), HADOOP),
}


class Session:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.P = config["P"]
        self.device = device
        rows = datagen.config_rows(config, seed, device=device)
        self.db = {name: program.shard(name, r, self.P) for name, r in rows.items()}
        del rows
        self.descs = config["queries"]
        self.queries = [program.bsgf_of(q) for q in self.descs]
        self.plan = PLANS[traffic["plan"]]

    def warm(self):
        """One request of the window's own shapes."""
        self.step(None, None)

    def step(self, tracer, spans):
        with program.span(spans, "plan"):
            plan = self.plan(self.queries, self.db)
        with program.span(spans, "execute"):
            ex = Executor(dict(self.db), SimComm(self.P), ExecutorConfig(), tracer=tracer)
            env, report = ex.execute(plan)
            program.sync(self.device)
        answers = [({"query": d, "versions": {}}, program.answer_rows(env[q.name]))
                   for d, q in zip(self.descs, self.queries)]
        return len(self.queries), [report], answers

    def close(self):
        self.db = None

