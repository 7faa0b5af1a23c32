"""Port differential: ``Relation`` placement (block and hash partition,
``compacted``), ``shuffle.partition`` with exact overflow, and the top-k
heavy-hitter sketch, held against the JAX reference on the same numpy
inputs.  Exact equality: every value is an int32 or a bool."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core.relation import Relation as JRel  # noqa: E402
from repro.engine import shuffle as jshuffle  # noqa: E402
from repro_torch.core.relation import (  # noqa: E402
    Relation,
    db_from_dict,
    db_from_reference,
    resolve_device,
)
from repro_torch.engine import shuffle  # noqa: E402
from test_torch_models import one_thread  # noqa: E402, F401


def _same(a_jax, b_torch):
    np.testing.assert_array_equal(np.asarray(a_jax), b_torch.cpu().numpy())


@pytest.mark.parametrize("partition", ["block", "hash"])
@pytest.mark.parametrize("n,P,arity", [(0, 2, 1), (1, 3, 2), (97, 4, 3), (256, 5, 4)])
def test_from_numpy_placement(partition, n, P, arity):
    rows = np.random.default_rng(n).integers(-50, 50, (n, arity)).astype(np.int32)
    ref = JRel.from_numpy("R", rows, P=P, partition=partition)
    got = Relation.from_numpy("R", rows, P=P, partition=partition, device="cpu")
    _same(ref.data, got.data)
    _same(ref.valid, got.valid)
    assert got.data.dtype == torch.int32 and got.valid.dtype == torch.bool
    assert got.to_set() == ref.to_set()


def test_capacity_overflow_raises():
    rows = np.zeros((9, 1), np.int32)
    with pytest.raises(ValueError):
        Relation.from_numpy("R", rows, P=2, cap=4, device="cpu")


@pytest.mark.parametrize("cap", [None, 16])
def test_compacted_matches_reference(cap):
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 40, (120, 3)).astype(np.int32)
    ref = JRel.from_numpy("R", rows, P=4)
    mask = rng.random((4, ref.cap)) < 0.35
    ref = ref.with_mask(jnp.asarray(mask))
    port = db_from_reference(
        {"R": (np.asarray(ref.data), np.asarray(ref.valid))}, device="cpu"
    )["R"]
    want, got = ref.compacted(cap), port.compacted(cap)
    _same(want.data, got.data)
    _same(want.valid, got.valid)


@pytest.mark.parametrize("cap", [1, 5, 64])
def test_partition_overflow_and_counts(cap):
    rng = np.random.default_rng(cap)
    N, W, P = 200, 3, 4
    msgs = rng.integers(-(2**31), 2**31, (N, W), dtype=np.int64).astype(np.int32)
    valid = rng.random(N) < 0.8
    dest = rng.integers(0, P, N).astype(np.int32)
    want = jshuffle.partition(jnp.asarray(msgs), jnp.asarray(valid),
                              jnp.asarray(dest), P, cap)
    got = shuffle.partition(torch.from_numpy(msgs), torch.from_numpy(valid),
                            torch.from_numpy(dest), P, cap)
    for a, b in zip(want, got):
        _same(a, b)
    assert (int(got[2]) > 0) == (cap < int(got[3].max()))


@pytest.mark.parametrize("k", [1, 4, 50])
def test_topk_sketch_and_merge(k):
    rng = np.random.default_rng(k)
    P, n = 3, 64
    vals = rng.choice(np.array([-1, 0, 5, 7, 2**31 - 1, -(2**31)], np.int32), (P, n))
    valid = rng.random((P, n)) < 0.7
    jv, jc = zip(*(jshuffle.topk_fp_counts(jnp.asarray(vals[p]), jnp.asarray(valid[p]), k)
                   for p in range(P)))
    tv, tc = zip(*(shuffle.topk_fp_counts(torch.from_numpy(vals[p]),
                                          torch.from_numpy(valid[p]), k)
                   for p in range(P)))
    for a, b in zip(jv + jc, tv + tc):
        _same(a, b)
    assert shuffle.merge_topk(torch.stack(tv), torch.stack(tc), k) == jshuffle.merge_topk(
        jnp.stack(jv), jnp.stack(jc), k
    )


def test_flatten_recv_shapes():
    buf = torch.arange(2 * 3 * 4, dtype=torch.int32).reshape(2, 3, 4)
    flat, ok = shuffle.flatten_recv(buf, torch.ones((2, 3), dtype=torch.bool))
    assert flat.shape == (6, 4) and ok.shape == (6,)


def test_default_device_is_cuda_and_raises_without_it():
    """Entry points run on the card unless the caller asks for the CPU:
    with no CUDA device the default raises instead of falling back."""
    rows = {"R": np.zeros((4, 2), np.int32)}
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        assert db_from_dict(rows, P=2)["R"].data.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="CUDA"):
            db_from_dict(rows, P=2)
        with pytest.raises(RuntimeError, match="CUDA"):
            Relation.empty("E", 2)
    assert db_from_dict(rows, P=2, device="cpu")["R"].data.device.type == "cpu"


def test_simcomm_exchange_is_all_to_all():
    """``exchange`` (the runner's all_to_all over per-source buffers) is
    the transpose of their stack."""
    from repro_torch.engine.comm import SimComm

    comm = SimComm(3)
    sends = [torch.arange(p * 100, p * 100 + 3 * 2 * 4, dtype=torch.int32).reshape(3, 2, 4)
             for p in range(3)]
    want = comm.all_to_all(torch.stack(sends))
    assert torch.equal(comm.exchange(list(sends)), want)
    assert torch.equal(want[1, 2], sends[2][1])
