"""Port differential: the serving path (``repro_torch.serve``,
``repro_torch.launch.serve``).

Greedy generation and the continuous batcher against ``repro``'s on the
CPU, float32, with the reference's parameters carried across by
``params_from_numpy``: tokens must be exactly equal, for the dense
decoder and for the MoE, SSM and hybrid families.  The batcher's cases are
the reference's own (``tests/test_serving.py``); the launcher runs with
``--smoke --device cpu``."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models import model as rmodel  # noqa: E402
from repro.serve import batcher as rbatcher  # noqa: E402
from repro.serve.serve_step import greedy_generate as r_greedy  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.serve import batcher  # noqa: E402
from repro_torch.serve.serve_step import greedy_generate, make_decode, make_prefill  # noqa: E402
from test_torch_models import one_thread  # noqa: E402, F401

SRC = Path(__file__).resolve().parents[1] / "src"
FAMILIES = ["olmoe-1b-7b", "falcon-mamba-7b", "zamba2-7b"]  # MoE, SSM, hybrid


@pytest.fixture(scope="module")
def qwen3():
    """qwen3-0.6b SMOKE in float32, the reference's params from PRNGKey(0)
    (the reference test's), on both sides."""
    cfg_r = rconfigs.get_config("qwen3-0.6b", smoke=True, dtype="float32")
    cfg_t = configs.get_config("qwen3-0.6b", smoke=True, dtype="float32")
    rp = rmodel.init_params(cfg_r, jax.random.PRNGKey(0))
    tp = model.params_from_numpy(cfg_t, jax.tree.map(np.asarray, rp), device="cpu")
    return cfg_r, cfg_t, rp, tp


def test_greedy_generate_matches_reference(qwen3):
    cfg_r, cfg_t, rp, tp = qwen3
    tokens = np.random.default_rng(1).integers(0, cfg_r.vocab, (2, 13)).astype(np.int32)
    want = r_greedy(cfg_r, rp, {"tokens": jnp.asarray(tokens)}, steps=6, max_len=64)
    got = greedy_generate(cfg_t, tp, {"tokens": torch.as_tensor(tokens)}, steps=6, max_len=64)
    assert got.dtype == torch.int64 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_batcher_matches_reference_batcher(qwen3):
    """``tests/test_serving.py``'s case: 3 requests through 2 slots, each
    request's tokens equal to the reference batcher's and to unbatched
    generation."""
    cfg_r, cfg_t, rp, tp = qwen3
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg_r.vocab, (n,)).astype(np.int32) for n in (7, 13, 9)]
    ref = rbatcher.Batcher(cfg_r, rp, max_batch=2, max_len=64)
    mine = batcher.Batcher(cfg_t, tp, max_batch=2, max_len=64)
    reqs_r = [rbatcher.Request(i, p, 5) for i, p in enumerate(prompts)]
    reqs_t = [batcher.Request(i, p, 5) for i, p in enumerate(prompts)]
    for b, reqs in ((ref, reqs_r), (mine, reqs_t)):
        for r in reqs:
            b.submit(r)
        b.run()
    for rr, rt in zip(reqs_r, reqs_t):
        assert rt.done and len(rt.out) == 5
        assert rt.out == [int(x) for x in rr.out]
        batch = {"tokens": torch.as_tensor(rt.prompt[None, :])}
        assert greedy_generate(cfg_t, tp, batch, steps=5, max_len=64)[0].tolist() == rt.out


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_batcher_matches_reference_batcher(arch):
    """3 requests through 2 slots for each family at SMOKE size: the port's
    batcher gives the reference batcher's tokens and its own unbatched
    generation's.  zamba2's 70-token prompt passes its 64-slot window."""
    cfg_r = rconfigs.get_config(arch, smoke=True, dtype="float32")
    cfg_t = configs.get_config(arch, smoke=True, dtype="float32")
    rp = rmodel.init_params(cfg_r, jax.random.PRNGKey(1))
    tp = model.params_from_numpy(cfg_t, jax.tree.map(np.asarray, rp), device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg_r.vocab, (n,)).astype(np.int32) for n in (5, 70, 8)]
    ref = rbatcher.Batcher(cfg_r, rp, max_batch=2, max_len=96)
    mine = batcher.Batcher(cfg_t, tp, max_batch=2, max_len=96)
    reqs_r = [rbatcher.Request(i, p, 4) for i, p in enumerate(prompts)]
    reqs_t = [batcher.Request(i, p, 4) for i, p in enumerate(prompts)]
    for b, reqs in ((ref, reqs_r), (mine, reqs_t)):
        for r in reqs:
            b.submit(r)
        b.run()
    for rr, rt in zip(reqs_r, reqs_t):
        assert rt.done and rt.out == [int(x) for x in rr.out]
        batch = {"tokens": torch.as_tensor(rt.prompt[None, :])}
        assert greedy_generate(cfg_t, tp, batch, steps=4, max_len=96)[0].tolist() == rt.out


def test_batcher_more_requests_than_slots_with_bias_and_eos():
    """qwen2 SMOKE (QKV bias), 5 requests of ragged lengths through 3 slots:
    slots refill while others decode, each slot on its own clock; an eos
    token ends its request early, as in the reference."""
    cfg = configs.get_config("qwen2-72b", smoke=True, dtype="float32")
    params = model.init_params(cfg, 3, device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32) for n in (5, 17, 2, 11, 8)]
    want = [greedy_generate(cfg, params, {"tokens": torch.as_tensor(p[None, :])}, steps=7,
                            max_len=32)[0].tolist() for p in prompts]
    b = batcher.Batcher(cfg, params, max_batch=3, max_len=32)
    reqs = [batcher.Request(i, p, 7) for i, p in enumerate(prompts)]
    for r in reqs:
        b.submit(r)
    assert b.step() == 3 and b.queue == reqs[3:]
    b.run()
    assert [r.out for r in reqs] == want
    eos = want[1][2]
    b = batcher.Batcher(cfg, params, max_batch=3, max_len=32, eos=eos)
    reqs = [batcher.Request(i, p, 7) for i, p in enumerate(prompts)]
    for r in reqs:
        b.submit(r)
    b.run()
    for r, w in zip(reqs, want):
        stop = next((i for i, x in enumerate(w) if i > 0 and x == eos), len(w) - 1)
        assert r.done and r.out == w[:stop + 1]


def test_copy_slot_matches_reference():
    cfg_r = rconfigs.get_config("qwen3-0.6b", smoke=True, dtype="float32")
    cfg_t = configs.get_config("qwen3-0.6b", smoke=True, dtype="float32")
    rng = np.random.default_rng(4)
    big = {k: rng.standard_normal((2, 3, 8, 2, 4)).astype(np.float32) for k in ("k", "v")}
    small = {k: rng.standard_normal((2, 1, 8, 2, 4)).astype(np.float32) for k in ("k", "v")}
    big["len"], small["len"] = np.array([3, 5, 7], np.int32), np.array([6], np.int32)
    want = rbatcher._copy_slot({k: jnp.asarray(v) for k, v in big.items()},
                               {k: jnp.asarray(v) for k, v in small.items()}, 1)
    got = batcher._copy_slot({k: torch.as_tensor(v) for k, v in big.items()},
                             {k: torch.as_tensor(v) for k, v in small.items()}, 1)
    for k in ("k", "v", "len"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert cfg_r.n_layers == cfg_t.n_layers == 2


def test_copy_slot_matches_reference_on_hybrid_leaves():
    """zamba2's cache: the grouped ``conv``/``ssm`` leaves have their batch
    on dim 2, the KV and tail leaves on dim 1."""
    from repro.models import hybrid as rhybrid

    cfg = rconfigs.get_config("zamba2-7b", smoke=True, dtype="float32")
    rng = np.random.default_rng(5)

    def draw(batch):
        shapes = jax.tree.map(np.shape, rhybrid.init_cache(cfg, batch, 16))
        out = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        out["len"] = rng.integers(0, 9, shapes["len"]).astype(np.int32)
        return out

    big, small = draw(3), draw(1)
    assert big["conv"].ndim == 5 and big["ssm"].ndim == 6 and big["ssm_tail"].ndim == 5
    want = rbatcher._copy_slot({k: jnp.asarray(v) for k, v in big.items()},
                               {k: jnp.asarray(v) for k, v in small.items()}, 2)
    got = batcher._copy_slot({k: torch.as_tensor(v) for k, v in big.items()},
                             {k: torch.as_tensor(v) for k, v in small.items()}, 2)
    for k in big:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_serve_steps_run_in_inference_mode(qwen3):
    _, cfg, _, tp = qwen3
    cache, logits = make_prefill(cfg, 16)(tp, {"tokens": torch.zeros((1, 4), dtype=torch.int64)})
    assert logits.is_inference() and cache["k"].is_inference()
    cache, logits = make_decode(cfg)(tp, cache, torch.zeros((1, 1), dtype=torch.int64))
    assert cache["len"].tolist() == [5] and logits.shape == (1, cfg.vocab)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", *FAMILIES])
def test_launcher_smoke_on_the_cpu(capsys, arch):
    launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
                       "--max-batch", "2", "--max-len", "32", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "served 3 requests / 12 tokens" in out and "on cpu" in out


def test_launcher_module_and_card_default(monkeypatch):
    """``python -m repro_torch.launch.serve`` runs as a module; without
    ``--device`` it wants the card."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "deepseek-67b", "--smoke",
         "--device", "cpu", "--requests", "2", "--max-len", "24", "--max-new", "3"],
        env={"PYTHONPATH": str(SRC), "PATH": "", "OMP_NUM_THREADS": "1"},  # as one_thread
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "served 2 requests / 6 tokens" in out.stdout
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "qwen3-0.6b", "--smoke"])
    for arch in ("phi-3-vision-4.2b", "seamless-m4t-medium"):  # as the reference refuses
        with pytest.raises(SystemExit, match="serving needs frontend embeds"):
            launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
