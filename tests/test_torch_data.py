"""Port differential: the data layer (``repro_torch.data``) against
``repro.data`` on the CPU.

``token_batch`` makes the reference's numpy draws for every family's
split (tokens, the VLM's patch and the enc-dec's frame embeddings in the
config's dtype): exactly equal.  ``corpus_relations`` is a copy: exactly
equal.  ``filter_corpus`` runs the Keep query (three negated semi-joins
and one positive) through the port's planner and executor at the
examples' size (4096 documents, P=8): the kept ids, the number of jobs
and the bytes shuffled equal the reference's, and the ids equal a numpy
oracle."""
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


@pytest.mark.parametrize("strategy", ["one_round", "greedy"])
def test_filter_corpus_matches_reference(strategy):
    rels = synthetic.corpus_relations(4096, seed=1)
    want, r_summary = rpipeline.filter_corpus(rels, P=8, strategy=strategy)
    got, summary = pipeline.filter_corpus(rels, P=8, strategy=strategy, device="cpu")
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), oracle(rels))
    assert summary["jobs"] == r_summary["jobs"]
    assert summary["bytes_shuffled"] == r_summary["bytes_shuffled"]


def test_entry_points_need_a_card(monkeypatch):
    cfg = configs.get_config("qwen3-0.6b", smoke=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic.token_batch(cfg, "train", 2, 8, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.filter_corpus(synthetic.corpus_relations(64), P=2)
