"""Card tests of the port: each hand-written CUDA kernel (the hash join
behind the bucketed and the all-pairs probe, bloom build and bloom probe)
against its plain torch version and its oracle, and MSJ runs on the card
(default, with the bloom prefilter, with the all-pairs probe) against the
same runs on the CPU.  They need a CUDA device and skip without one; on a
machine with a card run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Exact equality: hits and outputs are booleans and int32 values."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import queries  # noqa: E402
from repro_torch.core.algebra import semijoins_of  # noqa: E402
from repro_torch.core.msj import run_msj  # noqa: E402
from repro_torch.core.relation import db_from_dict  # noqa: E402
from repro_torch.engine.comm import SimComm  # noqa: E402
from repro_torch.kernels.bloom import ops as bloom  # noqa: E402
from repro_torch.kernels.bloom import ref as bloom_ref  # noqa: E402
from repro_torch.kernels.msj_probe import ops, ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _case(seed, nb, np_, kw, key_range, device):
    rng = np.random.default_rng(seed)
    arrs = (
        rng.integers(0, 3, nb).astype(np.int32),
        rng.integers(-key_range, key_range + 1, (nb, kw)).astype(np.int32),
        rng.random(nb) < 0.7,
        rng.integers(0, 3, np_).astype(np.int32),
        rng.integers(-key_range, key_range + 1, (np_, kw)).astype(np.int32),
        rng.random(np_) < 0.7,
    )
    return [torch.from_numpy(a).to(device) for a in arrs]


@pytest.mark.parametrize("nb,np_,kw,key_range", [
    (0, 40, 1, 5), (40, 0, 1, 5), (1, 1, 1, 1), (64, 100, 1, 0),
    (1000, 1000, 2, 3), (3000, 2000, 3, 10_000), (1280, 2560, 2, 2**30),
    (500, 300, 126, 0),
])
def test_kernel_matches_plain_and_oracle(cuda, nb, np_, kw, key_range):
    args = _case(nb + np_, nb, np_, kw, key_range, cuda)
    before = ops.probe_bucketed.launches
    got = ops.probe_bucketed(*args)
    want = ops.probe_bucketed_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, ref.probe(*args))
    # two kernels per hash join: table build, table probe
    assert ops.probe_bucketed.launches == before + (2 if nb and np_ else 0)


@pytest.mark.parametrize("collide", ["zero", "mod4"])
def test_kernel_exact_under_forced_collisions(cuda, collide):
    args = _case(7, 3000, 2500, 2, 20, cuda)
    if collide == "zero":
        fps = (torch.zeros_like(args[1][:, 0]), torch.zeros_like(args[4][:, 0]))
    else:
        fps = (torch.remainder(args[1][:, 0], 4), torch.remainder(args[4][:, 0], 4))
    got = ops.probe_bucketed(*args, build_fp=fps[0], probe_fp=fps[1])
    assert torch.equal(got, ops.probe_bucketed_plain(*args, build_fp=fps[0], probe_fp=fps[1]))
    assert torch.equal(got, ref.probe(*args))


def _distinct_case(nb, np_, kw, device, seed=11):
    """Every build row valid and distinct, so the table holds nb rows; about
    half the probe rows are build rows."""
    rng = np.random.default_rng(seed)
    b_keys = rng.permutation(4 * nb)[:nb].astype(np.int32)[:, None] - 2 * nb
    b_keys = np.repeat(b_keys, kw, 1)
    p_keys = rng.integers(-2 * nb, 2 * nb, (np_, 1)).astype(np.int32).repeat(kw, 1)
    arrs = (np.zeros(nb, np.int32), b_keys, np.ones(nb, bool),
            np.zeros(np_, np.int32), p_keys, rng.random(np_) < 0.9)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrs]


@pytest.mark.parametrize("wrapper,plain", [
    (ops.probe_bucketed, ops.probe_bucketed_plain), (ops.probe, ops.probe_blocked_plain),
])
@pytest.mark.parametrize("nb", [2**16, 2**16 + 1])
def test_kernel_near_full_table(cuda, wrapper, plain, nb):
    """2**16 distinct build rows fill 2**17 slots to the load limit of 0.5;
    one more row doubles the table."""
    args = _distinct_case(nb, 50_000, 2, cuda)
    assert ops.table_slots(nb) == (2**17 if nb == 2**16 else 2**18)
    got = wrapper(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, plain(*args))
    assert 0 < int(got.sum()) < int(args[5].sum())


def test_blocked_kernel_ignores_colliding_fingerprints(cuda):
    """fp = 0 on every row: the all-pairs wrapper ignores fingerprints and
    stays exact."""
    args = _case(8, 3000, 2500, 2, 20, cuda)
    fps = (torch.zeros_like(args[1][:, 0]), torch.zeros_like(args[4][:, 0]))
    got = ops.probe(*args, build_fp=fps[0], probe_fp=fps[1])
    assert torch.equal(got, ops.probe_blocked_plain(*args))
    assert torch.equal(got, ref.probe(*args))


@pytest.mark.parametrize("fingerprints", [False, True])
def test_hash_join_reads_strided_views(cuda, fingerprints):
    """As in run_msj: both sides are column views of one received buffer
    (row stride 4 words), read in place without a copy."""
    rng = np.random.default_rng(9)
    n = 5000
    flat = torch.from_numpy(rng.integers(-40, 40, (n, 4)).astype(np.int32)).to(cuda)
    flat[:, 0] = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)).to(cuda)
    kind = torch.from_numpy(rng.random(n) < 0.5).to(cuda)
    ok = torch.from_numpy(rng.random(n) < 0.9).to(cuda)
    sig, keys, fp = flat[:, 0], flat[:, 1:3], flat[:, 3]
    assert keys.stride() == (4, 1) and not sig.is_contiguous()
    kw = {"build_fp": fp, "probe_fp": fp} if fingerprints else {}
    if fingerprints:  # a fingerprint must be a function of (sig, key)
        fp.copy_(keys[:, 0] % 7)
    args = (sig, keys, ok & kind, sig, keys, ok & ~kind)
    got = ops.probe_bucketed(*args, **kw)
    copies = [a.contiguous() for a in args]
    assert torch.equal(got, ops.probe_bucketed_plain(*copies))
    assert torch.equal(got, ref.probe(*copies))


def _counts():
    return (ops.probe_bucketed.launches, ops.probe.launches, bloom.build.launches,
            bloom.probe.launches)


@pytest.mark.parametrize("probe_fn,bloom_bits,launched", [
    (ops.probe_bucketed, 0, (8, 0, 0, 0)),      # a table build and a table probe per shard
    # + a bloom build per shard, a bloom probe per semi-join and shard
    (ops.probe_bucketed, 2**14, (8, 0, 4, 16)),
    (ops.probe, 0, (0, 8, 0, 0)),
])
def test_msj_on_card_equals_cpu(cuda, probe_fn, bloom_bits, launched):
    qs = queries.make_queries("A3")
    db_np = queries.gen_db(qs, n_guard=4096, n_cond=4096, seed=2)
    sjs = [sj for q in qs for sj in semijoins_of(q)]
    out_c, st_c = run_msj(db_from_dict(db_np, P=4, device="cpu"), sjs, SimComm(4),
                          probe_fn=probe_fn, bloom_bits=bloom_bits)
    before = _counts()
    out_g, st_g = run_msj(db_from_dict(db_np, P=4), sjs, SimComm(4),
                          probe_fn=probe_fn, bloom_bits=bloom_bits)
    assert tuple(a - b for a, b in zip(_counts(), before)) == launched
    for k in out_c:
        assert torch.equal(out_c[k].data, out_g[k].data.cpu())
        assert torch.equal(out_c[k].valid, out_g[k].valid.cpu())
    assert {k: int(v) for k, v in st_c.items()} == {k: int(v) for k, v in st_g.items()}


@pytest.mark.parametrize("nb,np_,kw,key_range", [
    (0, 40, 1, 5), (40, 0, 1, 5), (1, 1, 1, 1), (64, 100, 1, 0),
    (1000, 1000, 2, 3), (3000, 2000, 3, 10_000), (1280, 2560, 2, 2**30),
    (500, 300, 126, 0), (129, 385, 4, 2),
])
def test_blocked_kernel_matches_plain_and_oracle(cuda, nb, np_, kw, key_range):
    args = _case(nb + np_ + 1, nb, np_, kw, key_range, cuda)
    before = ops.probe.launches
    got = ops.probe(*args)
    want = ops.probe_blocked_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, ref.probe(*args))
    assert ops.probe.launches == before + (2 if nb and np_ else 0)


@pytest.mark.parametrize("bits", [128, 1000, 2**16, 2**24])
@pytest.mark.parametrize("n", [0, 1, 1000, 70_001])
def test_bloom_kernels_match_plain(cuda, bits, n):
    rng = np.random.default_rng(bits + n)
    keys = torch.from_numpy(rng.integers(-(2**31), 2**31, (n, 1), dtype=np.int64)
                            .astype(np.int32)).to(cuda)
    sigs = torch.from_numpy(rng.integers(0, 4, n).astype(np.int32)).to(cuda)
    mask = torch.from_numpy(rng.random(n) < 0.6).to(cuda)
    nw = bloom.n_words(bits)
    for fp in (None, keys[:, 0]):
        pos = bloom.positions(keys, sigs, bits, fp=fp)
        before = (bloom.build.launches, bloom.probe.launches)
        filt = bloom.build_cuda(pos, mask, nw)
        found = bloom.probe_cuda(pos, filt)
        torch.cuda.synchronize()
        assert torch.equal(filt, bloom.build_plain(pos, mask, nw))
        assert torch.equal(found, bloom.probe_plain(pos, filt))
        assert bool(found[mask].all())
        assert (bloom.build.launches, bloom.probe.launches) == tuple(
            b + (1 if n else 0) for b in before)
    if n <= 1000:
        want = bloom_ref.build(keys, sigs, mask, bits)
        assert np.array_equal(bloom.build(keys, sigs, mask, bits).cpu().numpy(), want)
        assert np.array_equal(bloom.probe(filt, keys, sigs, bits).cpu().numpy(),
                              bloom_ref.probe(filt, keys, sigs, bits))


@pytest.mark.parametrize("case", ["inactive", "one_bit", "last_bit"])
def test_bloom_kernels_edge_positions(cuda, case):
    n, bits = 5000, 2**12
    nw = bloom.n_words(bits)
    pos = torch.randint(0, bits, (n, 2), dtype=torch.int32, device=cuda)
    mask = torch.ones(n, dtype=torch.bool, device=cuda)
    if case == "inactive":
        mask[:] = False
    elif case == "one_bit":
        pos[:] = 77
    else:
        pos[::3] = bits - 1
    filt = bloom.build_cuda(pos, mask, nw)
    assert torch.equal(filt, bloom.build_plain(pos, mask, nw))
    assert torch.equal(bloom.probe_cuda(pos, filt), bloom.probe_plain(pos, filt))
