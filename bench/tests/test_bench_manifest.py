"""``BENCHMARK.json`` against the rules the benchmark is held to, the
harness finding a new configuration, traffic mix and metric by their files
alone, and the imports no run may make."""
import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

pytest.importorskip("torch")

from bench import harness  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}

MANIFEST = harness.load_manifest(ROOT)


def test_manifest_shape_and_characters():
    m = MANIFEST
    assert set(m) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(m["command"]) <= 32 and all(LINE.match(w) for w in m["command"])
    assert m["paths"] == ["bench"] and all(not p.startswith("/") and ".." not in p for p in m["paths"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    names = [c["name"] for c in m["configs"]]
    cells = [w["name"] for w in m["workloads"]]
    metrics = [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for c in m["configs"]:
        assert set(c) == CONFIG_KEYS and LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert c["name"] in {w["config"] for w in m["workloads"]}
    assert len({c["file"] for c in m["configs"]}) == len(m["configs"])
    assert len({c["source"] for c in m["configs"]}) == len(m["configs"])
    for w in m["workloads"]:
        assert set(w) == CELL_KEYS and w["config"] in names and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
    assert len({(w["config"], w["traffic"]) for w in m["workloads"]}) == len(cells)
    assert sum(w["chips"] == 4 for w in m["workloads"]) <= max(1, len(cells) // 4)
    for x in m["end_to_end"]:
        assert set(x) - {"workloads"} == E2E_KEYS and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher") and set(x.get("workloads", cells)) <= set(cells)
        assert x["source"] in ("host_clock", "device_trace") and 0.01 <= x["bound"] <= 0.25
    assert "setup_s" in {x["name"] for x in m["end_to_end"]}
    e2e = {x["name"] for x in m["end_to_end"]}
    for x in m["per_layer"]:
        assert set(x) - {"workloads"} == LAYER_KEYS and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher") and LINE.match(x["layer"])
        assert x["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert x["moves"] in e2e and set(x.get("workloads", cells)) <= set(cells)
        if x["name"].endswith("_roofline"):
            assert x["unit"] == "%"
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    for w in cells:
        parts = harness.cell_parts(m, w, ROOT)
        reported = {x["name"] for x in parts["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2 and parts["per_layer"]
        assert {x["moves"] for x in parts["per_layer"]} <= reported


def test_every_name_has_its_file():
    for w in MANIFEST["workloads"]:
        parts = harness.cell_parts(MANIFEST, w["name"], ROOT)
        assert harness.session_class(parts["traffic"]["entry"], ROOT)
        config = parts["config"]
        assert config["reduced"] == next(c["reduced"] for c in MANIFEST["configs"]
                                         if c["name"] == w["config"])
        for q in config["queries"]:
            assert q["guard"][0] in config["relations"]
    for x in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert callable(harness.reader(x["name"], ROOT))


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


def test_no_file_imports_jax_or_the_jax_package():
    for path in (ROOT / "bench").rglob("*.py"):
        found = _imports(path) & {"jax", "jaxlib", "flax", "repro", "benchmarks"}
        assert not found, f"{path} imports {found}"
        if "tests" not in path.parts:
            text = path.read_text()
            assert "BENCH_msj" not in text and "BENCH_serve" not in text
    for path in (ROOT / "bench" / "reference").rglob("*.py"):
        assert not _imports(path) & {"repro_torch"}, f"{path} imports the program"


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.core", "reprox", "jaxtyping"]) == []
    assert harness.forbidden_modules(["repro", "repro.core.msj", "jax.numpy", "flax"]) == [
        "flax", "jax.numpy", "repro", "repro.core.msj"]


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    return env


def test_run_without_a_card_prints_nothing_and_fails():
    proc = subprocess.run([sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
                           "a3.greedy", "--seed", str(2**33), "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, env=_env(), timeout=120)
    assert proc.returncode == 2 and proc.stdout == ""
    assert "CUDA" in proc.stderr


RUN_SMALL = """
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
torch.set_num_threads(1)
from bench import harness
out = harness.run_cell(sys.argv[3], 2**35 + 1, 0.2, sys.argv[4] == "1", "cpu",
                       root=__import__("pathlib").Path(sys.argv[1]),
                       config_override={"rows": 1024})
print(json.dumps({"result": out, "forbidden": harness.forbidden_modules(),
                  "bench": sys.modules["bench"].__file__}))
"""


def _run_small(root: Path, cell: str, trace: bool) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN_SMALL, str(root), str(ROOT / "src"), cell,
                           "1" if trace else "0"], capture_output=True, text=True, env=_env(),
                          timeout=300, cwd=root)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_a_run_loads_nothing_of_jax():
    out = _run_small(ROOT, "a3.greedy", False)
    assert out["forbidden"] == [] and out["result"]["correct"]


def test_new_config_traffic_and_metric_are_found_from_their_files(tmp_path):
    """A later change adds a cell with files and manifest entries alone."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((ROOT / "bench" / "configs" / "a3.json").read_text())
    config["queries"] = [dict(config["queries"][0], where={"or": [["S", "x"], ["T", "y"]]})]
    (root / "bench" / "configs" / "a3_or.json").write_text(json.dumps(config))
    traffic = json.loads((ROOT / "bench" / "traffic" / "one_round.json").read_text())
    (root / "bench" / "traffic" / "one_round_all.json").write_text(
        json.dumps(dict(traffic, checked_steps="all")))
    (root / "bench" / "metrics" / "answers_per_step.py").write_text(
        "def read(record):\n"
        "    steps = record['steps']\n"
        "    return sum(s['served'] for s in steps) / len(steps)\n")
    manifest["configs"].append({"name": "a3_or", "source": "a disjunction over the A3 data",
                                "file": "bench/configs/a3_or.json", "reduced": ["rows"],
                                "why": "a new configuration"})
    manifest["workloads"].append({"name": "a3_or.all", "config": "a3_or",
                                  "traffic": "one_round_all", "chips": 1, "why": "a new cell"})
    manifest["per_layer"].append({"name": "answers_per_step", "unit": "queries", "better": "higher",
                                  "source": "program_counter", "layer": "executor",
                                  "moves": "query_s", "workloads": ["a3_or.all"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    out = _run_small(root, "a3_or.all", True)
    assert out["bench"].startswith(str(root))
    result = out["result"]
    assert result["correct"] and result["metrics"]["answers_per_step"]["value"] == 1.0
    assert result["check"]["answers_checked"]["value"] == result["attempted"]
    assert "plan_s" not in result["metrics"]  # the old cells' metric stays theirs
