"""The port's probe-backend choice (``costmodel.choose_backend``).

The ``"kernel"`` backend is the CUDA hash join: priced linear in the rows
of both sides, with one weight fitted to card times of the kernel and the
torch sort-merge probe at a 2**14-row shard and at the main path's
15,120,032-row shard (``chip_smoke.py`` ``costmodel`` line; PERF.md §6).
No card is needed: the choice is arithmetic on row counts."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import costmodel, executor, planner, queries  # noqa: E402
from repro_torch.core.executor import Executor  # noqa: E402
from repro_torch.core.relation import db_from_dict  # noqa: E402
from repro_torch.engine.comm import SimComm  # noqa: E402

#: (rows a side, KW, kernel ms, sort-merge ms): the card times the weight
#: was fitted to (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6)
CARD = {"small": (2**14, 1, 0.07276319861412048, 0.59650559425354),
        "main": (15_120_032, 1, 1.049942398071289, 9.817708587646484)}


def test_the_weight_is_the_fit_of_the_card_times():
    weights = [costmodel.cost_sorted(n, n, kw) * tk / ts / ((kw + 1) * 2 * n)
               for n, kw, tk, ts in CARD.values()]
    assert costmodel.KERNEL_ROW_WEIGHT == pytest.approx(math.sqrt(weights[0] * weights[1]),
                                                        rel=1e-3)
    for n, kw, tk, ts in CARD.values():
        # one weight for both sizes: each modeled ratio within 25 % of the card's
        ratio = costmodel.cost_kernel(n, n, kw) / costmodel.cost_sorted(n, n, kw)
        assert 0.75 < ratio / (tk / ts) < 1.25


@pytest.mark.parametrize("size", list(CARD))
def test_choice_at_the_fitted_sizes_is_the_faster_on_the_card(size):
    n, kw, tk, ts = CARD[size]
    costs = {"kernel": costmodel.cost_kernel(n, n, kw), "sorted": costmodel.cost_sorted(n, n, kw)}
    assert n > costmodel.DENSE_MAX_SIDE  # dense is gated off at both sizes
    assert costmodel.choose_backend(n, n, kw, on_cuda=True) == min(costs, key=costs.get)
    assert min(costs, key=costs.get) == ("kernel" if tk < ts else "sorted")
    assert costmodel.choose_backend(n, n, kw, on_cuda=False) == "sorted"


@pytest.mark.parametrize("log2_rows,what", [
    (25, "1-ROUND"), (24, "GREEDY and one_round_bloom"), (21, "the service catalog"),
])
def test_main_path_shard_sizes_choose_the_kernel(log2_rows, what):
    """``chip_smoke.py``'s paths, as ``Executor._probe_backend_for`` sizes
    them: A3's four semi-joins, rows / P per shard on each side."""
    b = p = 4 * 2**log2_rows / 16
    assert costmodel.choose_backend(b, p, 1, on_cuda=True) == "kernel", what
    assert costmodel.choose_backend(b, p, 1, on_cuda=False) == "sorted", what


def test_kernel_is_linear_and_dense_stays_gated():
    c = costmodel.cost_kernel
    assert c(2e6, 4e6, 2) == pytest.approx(2 * c(1e6, 2e6, 2))
    assert c(1e6, 1e6, 3) == pytest.approx(2 * c(1e6, 1e6, 1))
    assert costmodel.choose_backend(8, 8, 1, on_cuda=True) == "dense"
    assert costmodel.choose_backend(8, 8, 1, on_cuda=False) == "dense"
    # cheaper modeled, but past the gate: never dense
    assert costmodel.choose_backend(costmodel.DENSE_MAX_SIDE + 1, 1, 1) == "sorted"
    assert costmodel.choose_backend(None, None, on_cuda=True) == "kernel"
    assert costmodel.choose_backend(None, None) == "sorted"


def test_executor_prices_per_shard_rows(monkeypatch):
    """``_probe_backend_for`` hands the cost model each side's rows per
    shard, the key width and where the relations live."""
    P, n = 4, 64
    qs = queries.make_queries("A3")
    db = db_from_dict(queries.gen_db(qs, n_guard=n, n_cond=n, seed=1), P=P, device="cpu")
    seen = []

    def spy(b, p, kw=1, *, on_cuda=None):
        seen.append((b, p, kw, on_cuda))
        return "sorted"

    monkeypatch.setattr(executor, "choose_backend", spy)
    ex = Executor(db, SimComm(P), stats=costmodel.stats_of_db(db))
    plan = planner.plan_one_round(qs)
    jobs = [j for r in plan.rounds for j in r.jobs if isinstance(j, planner.MSJJob)]
    assert [ex._probe_backend_for(j) for j in jobs] == ["sorted"] * len(jobs)
    rows = {k: float(np.asarray(r.valid).sum()) for k, r in db.items()}
    build = sum(rows[c] for c in ("S", "T", "U", "V")) / P
    assert seen == [(build, 4 * rows["R"] / P, 1, False)] * len(jobs)
