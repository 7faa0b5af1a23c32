"""The attribution of a device trace's idle gaps and copies to the
program's spans (``bench/attribution.py``), on synthetic events, and its
command rehearsed on the CPU."""
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

torch = pytest.importorskip("torch")

from bench import attribution, trace  # noqa: E402

D2H = "Memcpy DtoH (Device -> Pageable)"
WINDOW = (0, 1000)
BENCH = [(0, 100, "plan"), (100, 900, "execute"), (900, 1000, "answer")]
# the program's log: (ns0, ns1, name, cat, parent)
LOG = [(110, 880, "exec.execute", "host", None), (120, 600, "exec.dispatch", "host", 0),
       (130, 400, "msj.probe", "phase", 1), (140, 300, "sim.shards", "host", 2),
       (610, 700, "exec.publish", "host", 0)]
HOST = [(150, 160, "cudaLaunchKernel", 1), (285, 295, "cudaLaunchKernel", 5),
        (320, 325, "cudaLaunchKernel", 4), (620, 630, "cudaMemcpyAsync", 2),
        (950, 960, "cudaMemcpyAsync", 3)]
DEV = [(0, 60, "k0", 0), (120, 140, "ka", 0), (170, 250, "k1", 1), (330, 500, "k2", 4),
       (640, 650, D2H, 2), (700, 870, "k3", 0), (900, 1000, "k4", 0), (965, 975, D2H, 3)]


def test_innermost_takes_the_nested_span_and_the_shorter_of_a_tie():
    spans = [(0, 10, "outer"), (0, 8, "inner"), (2, 4, "leaf"), (20, 30, "other")]
    assert attribution.innermost([1, 3, 9, 10, 15, 25], spans) == \
        ["inner", "leaf", "outer", "outer", None, "other"]


def test_gaps_and_copies_go_to_the_innermost_program_span():
    out = attribution.attribute(HOST, DEV, WINDOW, BENCH, LOG)
    assert out["idle_gaps"] == {
        "execute / exec.dispatch / host code": 140e-9,
        "execute / sim.shards / cudaLaunchKernel": 110e-9,
        "plan / host code": 60e-9,
        "execute / exec.publish / host code": 50e-9,
        "execute / host code": 30e-9,
    }
    assert out["idle_s"] == 390e-9
    assert out["exec_idle_s"] == 190e-9 and out["stage_idle_s"] == 110e-9
    assert out["execute_idle_s"] == 330e-9 and out["execute_covered_s"] == 300e-9
    # the copy of the answer is under no program span, and in "answer"
    assert out["host_reads"] == 1 and out["reads_by_span"] == {"exec.publish": 1}


def test_without_a_log_the_gaps_keep_the_benchmarks_names():
    from torch.autograd import DeviceType

    def ev(e, device):
        a, b, name, corr = e
        return SimpleNamespace(start_ns=lambda: a, duration_ns=lambda: b - a, name=lambda: name,
                               device_type=lambda: device, correlation_id=lambda: corr)

    events = [ev(e, DeviceType.CPU) for e in HOST] + [ev(e, DeviceType.CUDA) for e in DEV]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    before = trace.reduce_profile(prof, WINDOW, BENCH)
    out = attribution.attribute(HOST, DEV, WINDOW, BENCH, None)
    assert out["idle_gaps"] == dict(before["idle_gaps"])
    assert out["idle_s"] == pytest.approx(before["window_s"] - before["busy_s"], abs=1e-15)
    for key in ("exec_idle_s", "stage_idle_s", "execute_idle_s", "execute_covered_s",
                "host_reads", "reads_by_span"):
        assert out[key] is None


def test_the_command_on_the_cpu(capsys):
    torch.set_num_threads(1)
    assert attribution.main(["--workload", "a3_2p27.one_round", "--seed", str(2**33 + 7),
                             "--seconds", "0.01", "--device", "cpu", "--rows", "1024"]) == 0
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert out["queries"] == [1, 1, 1] and out["profile"] is None
    assert all(v > 0 for v in out["query_s"].values())
    # one root, an attempt, five stages, their runner spans, rows, publish
    assert 10 <= out["spans_per_query"] < 200 and out["shard_loop_s"] > 0
