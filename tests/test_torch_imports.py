"""The port stands alone: importing every ``repro_torch`` module pulls in
neither JAX nor the reference package, and nothing is built or launched
at import time."""
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"


def _modules():
    import repro_torch

    return sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert {"repro_torch.kernels.msj_probe.ops", "repro_torch.kernels.bloom.ops",
            "repro_torch.core.executor", "repro_torch.obs.metrics",
            "repro_torch.obs.perfetto", "repro_torch.analysis.verifier",
            "repro_torch.analysis.sanitizer", "repro_torch.analysis.__main__",
            "repro_torch.ft.elastic", "repro_torch.ft.supervisor",
            "repro_torch.service.catalog", "repro_torch.service.plan_cache",
            "repro_torch.service.result_cache", "repro_torch.service.scheduler",
            "repro_torch.service.batcher", "repro_torch.configs", "repro_torch.configs.base",
            "repro_torch.configs.qwen3_0_6b", "repro_torch.models.layers",
            "repro_torch.models.flash", "repro_torch.models.kvcache",
            "repro_torch.models.transformer", "repro_torch.models.model",
            "repro_torch.serve.serve_step", "repro_torch.serve.batcher",
            "repro_torch.launch.serve", "repro_torch.models.encdec",
            "repro_torch.train.optimizer", "repro_torch.train.grad_compress",
            "repro_torch.train.train_step", "repro_torch.data.synthetic",
            "repro_torch.data.pipeline", "repro_torch.ckpt.checkpoint",
            "repro_torch.launch.train", "repro_torch.launch.mesh",
            "repro_torch.launch.dryrun", "repro_torch.launch.opcost",
            "repro_torch.launch.roofline", "repro_torch.launch.report"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'repro' or k.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "import repro_torch.kernels.msj_probe.ops as ops\n"
        "import repro_torch.kernels.bloom.ops as bloom\n"
        "assert ops.probe_bucketed.launches == ops.probe.launches == 0\n"
        "assert bloom.build.launches == bloom.pack.launches == 0\n"
        "assert bloom.probe_packed.launches == bloom.probe.launches == 0\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], env={"PYTHONPATH": str(SRC), "PATH": ""},
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_sources_ship_with_the_package():
    from repro_torch.kernels import build

    srcs = build.sources()
    assert [s.name for s in srcs] == ["bloom.cu", "probe_hash.cu"]
    assert all(build.lib_path(s).parent == build.BUILD_DIR for s in srcs)
