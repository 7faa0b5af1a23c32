"""Port differential: checkpoints and the checkpointed training loop
(``repro_torch.ckpt``, ``repro_torch.ft.supervisor.run_train_loop``,
``repro_torch.launch.train``) on the CPU.

A save and load round trip is exact; a torn ``.tmp`` write is never the
latest step; a checkpoint written by either package loads into the other
(the reference's on-disk layout: one ``.npy`` per stacked pytree leaf);
a crash at step 5 and a resume give parameters bit-identical to an
uninterrupted run (the reference's own check, ``tests/test_executor_ft.py``);
the launcher runs as a module, with and without ``--ckpt-dir``."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.ckpt import checkpoint as rcheckpoint  # noqa: E402
from repro.train import optimizer as roptimizer  # noqa: E402
from repro.train import train_step as rts  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.ckpt import checkpoint  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.ft import supervisor  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.train import optimizer, train_step as ts  # noqa: E402
from test_torch_models import one_thread  # noqa: E402, F401

SRC = Path(__file__).resolve().parents[1] / "src"


def _state(arch="qwen3-0.6b", compress_frac=0.1, seed=0):
    cfg = configs.get_config(arch, smoke=True)
    return cfg, ts.init_state(cfg, seed, optimizer.OptConfig(), compress_frac=compress_frac,
                              device="cpu")


def _numpy_state(state) -> dict:
    out = {"params": model.params_to_numpy(state["params"]),
           "opt": {"mu": model.params_to_numpy(state["opt"]["mu"]),
                   "nu": model.params_to_numpy(state["opt"]["nu"]),
                   "step": np.asarray(state["opt"]["step"])}}
    if "err" in state:
        out["err"] = model.params_to_numpy(state["err"])
    return out


def _assert_trees_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    jax.tree.map(lambda x, y: np.testing.assert_array_equal(np.asarray(x), np.asarray(y)), a, b)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "zamba2-7b", "seamless-m4t-medium"])
def test_save_load_round_trip(tmp_path, arch):
    cfg, state = _state(arch)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for m in (state["opt"]["mu"], state["opt"]["nu"], state["err"]):
            for p in m.parameters():
                p.copy_(torch.as_tensor(rng.standard_normal(p.shape), dtype=torch.float32))
        state["opt"]["step"].fill_(7)
    path = checkpoint.save(str(tmp_path), 7, state)
    assert path.endswith("step_00000007") and checkpoint.latest_step(str(tmp_path)) == 7
    _, like = _state(arch, seed=1)
    back = checkpoint.load(str(tmp_path), 7, like, device="cpu")
    _assert_trees_equal(_numpy_state(state), _numpy_state(back))
    assert back["opt"]["step"].dtype == torch.int32 and int(back["opt"]["step"]) == 7
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in back["params"].parameters())
    assert not any(p.requires_grad for p in back["opt"]["mu"].parameters())


def test_checkpoint_atomicity(tmp_path):
    """A crash mid-write must not corrupt the latest complete checkpoint
    (the reference's ``test_checkpoint_atomicity``)."""
    tree = {"a": torch.ones(4), "b": {"c": torch.zeros((2, 2))}}
    checkpoint.save(str(tmp_path), 1, tree)
    os.makedirs(tmp_path / "step_00000002.tmp", exist_ok=True)
    (tmp_path / "step_00000002.tmp" / "a.npy").write_bytes(b"garbage")
    assert checkpoint.latest_step(str(tmp_path)) == 1
    loaded = checkpoint.load(str(tmp_path), 1, tree, device="cpu")
    np.testing.assert_array_equal(loaded["a"].numpy(), np.ones(4))
    assert checkpoint.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.load(str(tmp_path), 2, tree, device="cpu")
    with pytest.raises(ValueError, match="checkpoint shape"):
        checkpoint.load(str(tmp_path), 1, {"a": torch.ones(5), "b": tree["b"]}, device="cpu")


def test_reference_checkpoint_loads_into_the_port(tmp_path):
    cfg_r = rconfigs.get_config("qwen3-0.6b", smoke=True)
    opt_cfg = roptimizer.OptConfig()
    r_state = rts.init_state(cfg_r, jax.random.PRNGKey(3), opt_cfg, compress_frac=0.1)
    r_state["opt"]["mu"] = jax.tree.map(lambda a: a + 0.5, r_state["opt"]["mu"])
    r_state["opt"]["step"] = jnp.int32(11)
    rcheckpoint.save(str(tmp_path), 11, r_state)
    assert checkpoint.latest_step(str(tmp_path)) == 11
    _, like = _state()
    got = checkpoint.load(str(tmp_path), 11, like, device="cpu")
    _assert_trees_equal(jax.tree.map(np.asarray, r_state), _numpy_state(got))


def test_port_checkpoint_loads_into_the_reference(tmp_path):
    _, state = _state("zamba2-7b", seed=4)
    with torch.no_grad():
        state["opt"]["step"].fill_(3)
        for p in state["opt"]["nu"].parameters():
            p.fill_(0.25)
    checkpoint.save(str(tmp_path), 3, state)
    cfg_r = rconfigs.get_config("zamba2-7b", smoke=True)
    like = rts.init_state(cfg_r, jax.random.PRNGKey(0), roptimizer.OptConfig(),
                          compress_frac=0.1)
    assert rcheckpoint.latest_step(str(tmp_path)) == 3
    got = rcheckpoint.load(str(tmp_path), 3, like)
    _assert_trees_equal(_numpy_state(state), jax.tree.map(np.asarray, got))


def test_train_crash_restart_bitexact(tmp_path):
    """``run_train_loop`` crashed at step 5 (checkpoints every 2 steps),
    resumed from step 4, against 8 uninterrupted steps: the parameters
    and moments bit-identical (on the CPU)."""
    cfg = configs.get_config("qwen3-0.6b", smoke=True)
    opt_cfg = optimizer.OptConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    step_fn = ts.make_train_step(cfg, opt_cfg)
    bf = synthetic.make_batch_fn(cfg, 2, 32, device="cpu")
    d = str(tmp_path)
    st = ts.init_state(cfg, 0, opt_cfg, device="cpu")
    with pytest.raises(supervisor.SimulatedFault):
        supervisor.run_train_loop(st, step_fn, bf, steps=8, ckpt_dir=d, ckpt_every=2,
                                  crash_at=5)
    assert checkpoint.latest_step(d) == 4
    st2, hist = supervisor.run_train_loop(ts.init_state(cfg, 0, opt_cfg, device="cpu"),
                                          step_fn, bf, steps=8, ckpt_dir=d, ckpt_every=2,
                                          log_every=2)
    assert [s for s, _ in hist] == [6, 8] and checkpoint.latest_step(d) == 8
    st3 = ts.init_state(cfg, 0, opt_cfg, device="cpu")
    for i in range(8):
        st3, _ = step_fn(st3, bf(i))
    _assert_trees_equal(_numpy_state(st3), _numpy_state(st2))


@pytest.mark.parametrize("with_ckpt", [False, True])
def test_launcher_as_a_module(tmp_path, with_ckpt):
    args = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen3-0.6b", "--smoke",
            "--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "32"]
    if with_ckpt:
        args += ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    out = subprocess.run(args, env={"PYTHONPATH": str(SRC), "PATH": "", "OMP_NUM_THREADS": "1"},
                         capture_output=True, text=True, timeout=120)  # as one_thread
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith(
        "arch=qwen3-0.6b-smoke params=0.4M mesh={'data': 1, 'model': 1} batch=2 seq=32")
    assert lines[-1] == "done"
    if with_ckpt:
        assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000003"]
    else:
        assert lines[1].startswith("step     1 loss ")


def test_launcher_and_load_need_a_card(monkeypatch, tmp_path):
    checkpoint.save(str(tmp_path), 1, {"a": torch.ones(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        checkpoint.load(str(tmp_path), 1, {"a": torch.ones(2)})
