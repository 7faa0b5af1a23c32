"""Port differential: the data layer (``repro_torch.data``) against
``repro.data`` on the CPU.

``token_batch`` makes the reference's numpy draws for every family's
split (tokens, the VLM's patch and the enc-dec's frame embeddings in the
config's dtype): exactly equal.  ``corpus_relations`` is a copy: exactly
equal.  ``filter_corpus`` runs the Keep query (three negated semi-joins
and one positive) through the port's planner and executor at the
examples' size (4096 documents, P=8): the kept ids, the number of jobs
and the bytes shuffled equal the reference's, and the ids equal a numpy
oracle.  The reference's runs are module-scoped: the port's
``examples/data_pipeline.py`` (1-ROUND and GREEDY) and
``examples/train_lm.py``'s stage 1 (``repro_torch.examples``) are held to
them too, and ``data_pipeline``'s ``main`` at its own size (16,384
documents) prints the reference script's numbers."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.data import pipeline as rpipeline  # noqa: E402
from repro.data import synthetic as rsynthetic  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data import pipeline, synthetic  # noqa: E402
from repro_torch.examples import data_pipeline, train_lm  # noqa: E402
from test_torch_models import one_thread  # noqa: E402, F401
from test_torch_msj import jit_stages  # noqa: E402, F401

pytestmark = pytest.mark.usefixtures("jit_stages")

#: one arch per family: the plain split (dense, MoE, SSM, hybrid) and the
#: two frontend splits
SPLITS = ["qwen3-0.6b", "olmoe-1b-7b", "falcon-mamba-7b", "zamba2-7b", "phi-3-vision-4.2b",
          "seamless-m4t-medium"]


def oracle(rels) -> np.ndarray:
    docs = rels["Docs"]
    dup, blocked, quality = (rels[k][:, 0] for k in ("Dup", "Blocked", "Quality"))
    keep = (~np.isin(docs[:, 2], dup) & ~np.isin(docs[:, 3], dup)
            & ~np.isin(docs[:, 1], blocked) & np.isin(docs[:, 0], quality))
    return np.sort(docs[keep, 0]).astype(np.int64)


@pytest.mark.parametrize("arch", SPLITS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_token_batch_matches_reference(arch, dtype):
    cfg_r = rconfigs.get_config(arch, smoke=True, dtype=dtype)
    cfg_t = configs.get_config(arch, smoke=True, dtype=dtype)
    for step in (0, 3):
        want = rsynthetic.token_batch(cfg_r, "train", 3, 48, step, seed=5)
        got = synthetic.make_batch_fn(cfg_t, 3, 48, seed=5, device="cpu")(step)
        assert set(got) == set(want)
        assert got["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
        if "embeds" in want:
            assert got["embeds"].dtype == getattr(torch, dtype)
            np.testing.assert_array_equal(got["embeds"].float().numpy(),
                                          np.asarray(want["embeds"].astype(jnp.float32)))


@pytest.mark.parametrize("n_docs,seed", [(4096, 1), (1000, 7)])
def test_corpus_relations_match_reference(n_docs, seed):
    want = rsynthetic.corpus_relations(n_docs, seed=seed)
    got = synthetic.corpus_relations(n_docs, seed=seed)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


STRATEGIES = ["one_round", "greedy"]


@pytest.fixture(scope="module")
def reference_kept():
    """The reference's Keep query over 4096 documents (``seed=1``, P=8),
    by strategy: (kept ids, summary)."""
    rels = synthetic.corpus_relations(4096, seed=1)
    return {s: rpipeline.filter_corpus(rels, P=8, strategy=s) for s in STRATEGIES}


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_filter_corpus_matches_reference(reference_kept, strategy):
    rels = synthetic.corpus_relations(4096, seed=1)
    want, r_summary = reference_kept[strategy]
    got, summary = pipeline.filter_corpus(rels, P=8, strategy=strategy, device="cpu")
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), oracle(rels))
    assert summary["jobs"] == r_summary["jobs"]
    assert summary["bytes_shuffled"] == r_summary["bytes_shuffled"]


def test_data_pipeline_example_matches_reference(reference_kept):
    """``examples/data_pipeline.py``'s strategies over the reference's
    inputs: kept ids, jobs and bytes equal (its own check: the strategies
    agree)."""
    rels = synthetic.corpus_relations(4096, seed=1)
    runs = data_pipeline.filter_all(rels, P=8, strategies=STRATEGIES, device="cpu")
    assert [r["strategy"] for r in runs] == STRATEGIES
    for r in runs:
        want, r_summary = reference_kept[r["strategy"]]
        assert r["kept"].dtype == torch.int64 and r["kept"].device.type == "cpu"
        np.testing.assert_array_equal(r["kept"].numpy(), want)
        assert (r["summary"]["jobs"], r["summary"]["bytes_shuffled"]) == \
            (r_summary["jobs"], r_summary["bytes_shuffled"])


def test_train_lm_stage1_matches_reference(reference_kept):
    """``examples/train_lm.py``'s stage 1 is the 1-ROUND Keep query over
    4096 documents (``seed=1``): kept 1,934, 1 job, 248,948 bytes, as the
    reference."""
    kept, summary = train_lm.curate(4096, seed=1, P=8, device="cpu")
    want, r_summary = reference_kept["one_round"]
    np.testing.assert_array_equal(kept.numpy(), want)
    assert (summary["jobs"], summary["bytes_shuffled"]) == \
        (r_summary["jobs"], r_summary["bytes_shuffled"]) == (1, 248948)
    assert len(kept) == 1934


def test_data_pipeline_example_main_at_its_size(capsys):
    """``main(["--device", "cpu"])``: the reference script's numbers at its
    16,384 documents (``dup_frac=0.25``, ``blocked_frac=0.15``, ``seed=3``)."""
    out = data_pipeline.main(["--device", "cpu"])
    assert (out["docs"], out["dup_hashes"], out["blocked_domains"]) == (16384, 7698, 9)
    assert {s: (v["kept"], v["jobs"], v["bytes_shuffled"])
            for s, v in out["strategies"].items()} == {
        "par": (6672, 5, 2038284), "greedy": (6672, 2, 1945140),
        "one_round": (6672, 1, 1003884)}
    assert "all strategies agree" in capsys.readouterr().out


def test_entry_points_need_a_card(monkeypatch):
    cfg = configs.get_config("qwen3-0.6b", smoke=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic.token_batch(cfg, "train", 2, 8, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.filter_corpus(synthetic.corpus_relations(64), P=2)
