"""Each cell's whole run at 2^10 rows on the CPU against the reference, the
same runs with the timed path broken underneath (``correct`` must come
out false), the control at a small size, the device trace's reduction,
and, on the card, each cell at 2^16 rows.

The runs skip ``bench/run.py``'s look for a card and call
``harness.run_cell`` with the device.
"""
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

torch = pytest.importorskip("torch")

from bench import control, harness, trace  # noqa: E402

CELLS = [w["name"] for w in harness.load_manifest(ROOT)["workloads"]]
SMALL = {"rows": 1024}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(cell, trace_on=False, seed=2**33 + 5, seconds=0.3, device="cpu", config=SMALL):
    return harness.run_cell(cell, seed, seconds, trace_on, device, root=ROOT,
                            config_override=config, log=lambda *a: None)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_cpu(cell):
    parts = harness.cell_parts(harness.load_manifest(ROOT), cell, ROOT)
    out = run(cell)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "check" and out["check"]["answers_checked"]["value"] >= 1
    assert set(out["metrics"]) == {m["name"] for m in parts["end_to_end"]} - {"peak_mem_gb"}
    assert out["device"] == {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    traced = run(cell, trace_on=True)
    assert traced["correct"]
    on_card = ("launches_per_query", "probe_roofline", "idle_share")  # read on the card alone
    on_cpu = {m["name"] for m in parts["per_layer"] if m["name"].split(".")[0] not in on_card}
    assert set(traced["metrics"]) == on_cpu
    assert all(m["value"] > 0 for m in traced["metrics"].values())


# --------------------------------------------------------------------------
# faults planted in the program: each must turn ``correct`` false
# --------------------------------------------------------------------------


def alter_an_answer(mp):
    """An answer altered where it is produced: the first valid row of every
    relation a plan wrote is dropped."""
    from repro_torch.core import executor
    from repro_torch.core.planner import job_writes

    execute = executor.Executor.execute

    def altered(self, plan, **kw):
        env, report = execute(self, plan, **kw)
        for name in {n for rnd in plan.rounds for j in rnd.jobs for n in job_writes(j)}:
            rel = env.get(name)
            if isinstance(rel, executor.Relation) and bool(rel.valid.any()):
                valid = rel.valid.clone().reshape(-1)
                valid[int(valid.nonzero()[0])] = False
                env[name] = rel.with_mask(valid.reshape(rel.valid.shape))
        return env, report

    mp.setattr(executor.Executor, "execute", altered)


def drop_half_the_shards(mp):
    """Half of the batch left out: the executor sees the relations' first
    P/2 shards alone."""
    from repro_torch.core import executor

    init = executor.Executor.__init__

    def half(self, db, comm, *a, **kw):
        cut = {}
        for name, rel in db.items():
            if isinstance(rel, executor.Relation) and rel.valid.ndim == 2:
                valid = rel.valid.clone()
                valid[valid.shape[0] // 2:] = False
                rel = rel.with_mask(valid)
            cut[name] = rel
        init(self, cut, comm, *a, **kw)

    mp.setattr(executor.Executor, "__init__", half)


def skip_the_exchange(mp):
    """The exchange between shards left out: every shard keeps what it
    would have sent."""
    from repro_torch.engine import comm

    mp.setattr(comm.SimComm, "exchange", lambda self, sends: torch.stack(sends))


FAULTS = {"alter_an_answer": alter_an_answer, "drop_half_the_shards": drop_half_the_shards,
          "skip_the_exchange": skip_the_exchange}


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_path_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = run(cell)
    assert not out["correct"], out["check"]
    assert out["check"]["answers_wrong"]["value"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    parts = harness.cell_parts(harness.load_manifest(ROOT), cell, ROOT)
    config = dict(parts["config"], rows=4096)
    for seed in (11, 12, 13):
        steps = control.control_steps(config, seed, "cpu")
        numbers = harness.check(config, seed, steps, "cpu")
        assert not harness.passes(numbers) and numbers["rows_extra"]["value"] > 0
        assert numbers["rows_missing"]["value"] == 0  # a bloom filter only adds


# --------------------------------------------------------------------------
# the device trace's reduction, on a hand-made trace
# --------------------------------------------------------------------------


def test_reduce_profile_busy_ops_and_gaps():
    from torch.autograd import DeviceType

    def ev(name, start, end, device=DeviceType.CUDA, corr=0):
        return SimpleNamespace(start_ns=lambda: start, duration_ns=lambda: end - start,
                               name=lambda: name, device_type=lambda: device,
                               correlation_id=lambda: corr)

    events = [ev("k1", 100, 200, corr=7), ev("k2", 150, 300, corr=8), ev("k1", 600, 700, corr=9),
              ev("early", 0, 50), ev("cudaLaunchKernel", 70, 75, DeviceType.CPU, 7),
              ev("cudaLaunchKernel", 90, 95, DeviceType.CPU, 8),
              ev("cudaLaunchKernel", 420, 425, DeviceType.CPU, 9),
              ev("cudaStreamSynchronize", 320, 580, DeviceType.CPU)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    spans = [(60, 400, "execute"), (400, 650, "answer")]
    # stages: the device runs k1 and k2 after "a" has closed; they are its own
    stages = [(65, 80, "a"), (85, 98, "b"), (60, 120, "outer"), (410, 430, "a")]
    out = trace.reduce_profile(prof, (60, 1060), spans, stages)
    assert out["stage_s"] == {"a": 200e-9, "b": 150e-9} and out["stage_ops"] == {"a": 2, "b": 1}
    assert out["stage_top"] == {"a": [["k1", 200e-9]], "b": [["k2", 150e-9]]}
    assert out["window_s"] == 1000e-9 and out["busy_s"] == 300e-9
    assert out["device_ops"] == 3 and out["misaligned"] == 1
    assert out["device_op_s"] == [["k1", 200e-9], ["k2", 150e-9]]
    assert out["idle_gaps"] == [["between steps / host code", 360e-9],
                                ["answer / cudaStreamSynchronize", 300e-9],
                                ["execute / host code", 40e-9]]


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell, card):
    t0 = time.perf_counter()
    out = run(cell, seconds=1.0, device=card, config={"rows": 2**16})
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert out["metrics"]["peak_mem_gb"]["value"] > 0
    traced = run(cell, trace_on=True, seconds=2.0, device=card, config={"rows": 2**16})
    assert traced["correct"] and traced["device"]["busy_s"] > 0
    parts = harness.cell_parts(harness.load_manifest(ROOT), cell, ROOT)
    assert set(traced["metrics"]) == {m["name"] for m in parts["per_layer"]}
    shares = {k.split(".")[0]: v["value"] for k, v in traced["metrics"].items()}
    assert 0 < shares["idle_share"] < 100 and 0 < shares["probe_roofline"] <= 100
    assert time.perf_counter() - t0 < 300
