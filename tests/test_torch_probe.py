"""Port differential: the MSJ probes.

``repro_torch``'s ``probe_bucketed`` (on CPU tensors: the plain band
compare the CUDA hash join is held against on the card) and
``probe_bucketed_plain`` against the reference's Pallas ``probe_bucketed``
run in interpret mode, its pure oracle ``ref.probe`` and the port's own
oracles, on the reference's fingerprint corpus: empty sides, duplicate
keys, dense collisions, wide keys, huge magnitudes, forced fingerprint
collisions and ragged tile edges.  The unbucketed all-pairs ``probe`` and
``probe_blocked_plain`` against the reference's Pallas ``probe`` (interpret
mode) on a shape grid; the routing of CUDA tensors to the hash join and
its table size.  Exact equality: hits are booleans."""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.msj_probe import ops as jops  # noqa: E402
from repro.kernels.msj_probe import ref as jref  # noqa: E402
from repro_torch.core.msj import probe_dense, probe_sorted  # noqa: E402
from repro_torch.kernels.msj_probe import ops, ref  # noqa: E402


def _case(rng, nb, np_, kw, key_range):
    return (
        rng.integers(0, 3, nb).astype(np.int32),
        rng.integers(-key_range, key_range + 1, (nb, kw)).astype(np.int32),
        rng.random(nb) < 0.7,
        rng.integers(0, 3, np_).astype(np.int32),
        rng.integers(-key_range, key_range + 1, (np_, kw)).astype(np.int32),
        rng.random(np_) < 0.7,
    )


def _port(case, fps=None, fn=ops.probe_bucketed):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in case]
    kw = {}
    if fps is not None:
        kw = {"build_fp": torch.from_numpy(fps[0]), "probe_fp": torch.from_numpy(fps[1])}
    out = fn(*t, **kw)
    assert out.dtype == torch.bool and out.shape == (case[3].shape[0],)
    return out.numpy()


def _check(case, fps=None, *, pallas=False, tiles=(256, 256)):
    j = [jnp.asarray(a) for a in case]
    want = np.asarray(jref.probe(*j))
    for fn in (ops.probe_bucketed, ops.probe_bucketed_plain, probe_sorted, probe_dense,
               ref.probe):
        np.testing.assert_array_equal(_port(case, fps, fn), want, err_msg=fn.__name__)
    if pallas:
        kw = {} if fps is None else {"build_fp": jnp.asarray(fps[0]),
                                     "probe_fp": jnp.asarray(fps[1])}
        got = np.asarray(jops.probe_bucketed(*j, interpret=True, tp=tiles[0], tb=tiles[1],
                                             **kw))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(_port(case, fps), got)


@pytest.mark.parametrize("nb,np_,kw,key_range", [
    (0, 40, 1, 5),       # empty build side
    (40, 0, 1, 5),       # empty probe side
    (1, 1, 1, 1),
    (64, 100, 1, 0),     # all-duplicate keys (one key group)
    (100, 100, 2, 3),    # dense collisions
    (300, 200, 3, 10_000),  # sparse, wide keys
    (128, 256, 2, 2**30),   # huge magnitudes incl. negatives
])
def test_probe_bucketed_matches_reference_grid(nb, np_, kw, key_range):
    _check(_case(np.random.default_rng(0), nb, np_, kw, key_range), pallas=nb == 100)


@pytest.mark.parametrize("collide", ["all-equal", "two-buckets", "mod4"])
def test_probe_bucketed_forced_collisions(collide):
    """Colliding fingerprints co-bucket distinct keys; the compare inside
    a band is exact, so results must not change."""
    case = _case(np.random.default_rng(1), 200, 150, 2, 4)
    bk, pk = case[1], case[4]
    if collide == "all-equal":
        fps = (np.zeros(200, np.int32), np.zeros(150, np.int32))
    elif collide == "two-buckets":
        fps = (bk[:, 0] % 2, pk[:, 0] % 2)
    else:
        fps = ((bk[:, 0] % 4).astype(np.int32), (pk[:, 0] % 4).astype(np.int32))
    _check(case, fps, pallas=collide == "all-equal")


@pytest.mark.parametrize("n", [ops.TILE - 1, ops.TILE, ops.TILE + 1, 3 * ops.TILE + 7])
def test_probe_bucketed_ragged_tiles(n):
    """Side lengths around the tile size: a partial last tile, bands that
    start inside a tile of invalid rows, and the int32 extremes."""
    rng = np.random.default_rng(n)
    case = list(_case(rng, n + 5, n, 1, 40))
    case[1][:3, 0] = [-(2**31), 2**31 - 1, -1]
    case[4][:3, 0] = [-(2**31), 2**31 - 1, -1]
    # the reference's own tile sizes vary too: its result must not move
    _check(tuple(case), pallas=n == ops.TILE + 1, tiles=(128, 8))


def test_probe_bucketed_wide_key_rows():
    """Many key columns: the card's hash join compares every word of each
    candidate, the plain version's arithmetic does not change."""
    _check(_case(np.random.default_rng(5), 150, 130, 30, 1))


@pytest.mark.parametrize("seed", range(4))
def test_probe_bucketed_randomized(seed):
    rng = np.random.default_rng(100 + seed)
    nb, np_ = (int(v) for v in rng.integers(0, 400, 2))
    _check(_case(rng, nb, np_, int(rng.integers(1, 5)), int(rng.integers(1, 50))))


@pytest.fixture
def fake_card(monkeypatch):
    """Stands in for the card at the ctypes entry points of the hash join:
    each records its kernel's name and returns the next code of ``rcs``
    (0 = launched, the default).  A test makes its CPU tensors claim to be
    on CUDA itself."""
    calls, rcs = [], []

    def entry(name):
        return lambda *args: calls.append(name) or (rcs.pop(0) if rcs else 0)

    monkeypatch.setattr(ops, "_launchers", lambda: (entry("table_build"), entry("table_probe")))
    monkeypatch.setattr(ops, "_stream", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    return calls, rcs


def _on_card(monkeypatch):
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))


def _launch_counts(wrapper):
    return (wrapper.launches, ops.table_build_cuda.launches, ops.table_probe_cuda.launches)


def test_cuda_tensor_never_takes_the_plain_path(monkeypatch, fake_card):
    """The wrapper picks the plain band version only for CPU tensors: a
    CUDA input reaches the hash join's two kernel entry points (stubbed
    here), never the plain version, and is not sorted; each launch counts
    once for the wrapper and once for its kernel."""
    calls, _ = fake_card
    seen = []
    monkeypatch.setattr(ops, "band_probe_plain", lambda *a: seen.append("plain") or a[2])
    sorted_side = ops._sorted_side
    monkeypatch.setattr(ops, "_sorted_side", lambda *a: seen.append("sort") or sorted_side(*a))
    case = [torch.from_numpy(a) for a in _case(np.random.default_rng(2), 8, 8, 1, 3)]
    fps = {"build_fp": case[1][:, 0], "probe_fp": case[4][:, 0]}
    before = _launch_counts(ops.probe_bucketed)
    ops.probe_bucketed(*case, **fps)
    assert seen == ["sort", "sort", "plain"] and calls == []
    assert _launch_counts(ops.probe_bucketed) == before
    _on_card(monkeypatch)
    ops.probe_bucketed(*case, **fps)
    assert seen == ["sort", "sort", "plain"] and calls == ["table_build", "table_probe"]
    assert _launch_counts(ops.probe_bucketed) == tuple(b + d for b, d in zip(before, (2, 1, 1)))


@pytest.mark.parametrize("rcs,counted", [
    ([0, 0], (2, 1, 1)),    # both kernels launched
    ([0, 700], (1, 1, 0)),  # the table probe failed to launch
    ([700], (0, 0, 0)),     # the table build failed: the probe is not tried
])
def test_launch_counted_only_where_a_kernel_launched(monkeypatch, fake_card, rcs, counted):
    calls, codes = fake_card
    codes.extend(rcs)
    case = [torch.from_numpy(a) for a in _case(np.random.default_rng(3), 8, 8, 1, 3)]
    _on_card(monkeypatch)
    before = _launch_counts(ops.probe)
    if rcs[-1]:
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            ops.probe(*case)
    else:
        ops.probe(*case)
    assert calls == ["table_build", "table_probe"][: len(rcs)]
    assert _launch_counts(ops.probe) == tuple(b + d for b, d in zip(before, counted))


def test_hash_join_checks_its_inputs_once(monkeypatch, fake_card):
    """One validator for both sides: strided views pass (the kernels take
    element strides), a wrong dtype or key width raises before any launch."""
    calls, _ = fake_card
    _on_card(monkeypatch)
    flat = torch.zeros((10, 4), dtype=torch.int32)
    ok = torch.ones(10, dtype=torch.bool)
    ops.hash_probe_cuda(flat[:, 0], flat[:, 1:3], ok, flat[:, 0], flat[:, 1:3], ok)
    assert calls == ["table_build", "table_probe"]
    with pytest.raises(ValueError, match="int32"):
        ops.hash_probe_cuda(flat[:, 0], flat[:, 1:3].long(), ok, flat[:, 0], flat[:, 1:3], ok)
    with pytest.raises(ValueError, match="probe side"):
        ops.hash_probe_cuda(flat[:, 0], flat[:, 1:3], ok, flat[:, 0], flat[:, 1:2], ok)
    assert calls == ["table_build", "table_probe"]


def test_launch_counter_untouched_on_cpu():
    before = ops.probe_bucketed.launches
    _port(_case(np.random.default_rng(3), 50, 50, 1, 5))
    assert ops.probe_bucketed.launches == before


def _check_blocked(case, fps=None, **tiles):
    j = [jnp.asarray(a) for a in case]
    want = np.asarray(jref.probe(*j))
    kw = {} if fps is None else {"build_fp": jnp.asarray(fps[0]), "probe_fp": jnp.asarray(fps[1])}
    np.testing.assert_array_equal(np.asarray(jops.probe(*j, interpret=True, **tiles, **kw)), want)
    for fn in (ops.probe, ops.probe_blocked_plain):
        np.testing.assert_array_equal(_port(case, fps, fn), want, err_msg=fn.__name__)


@pytest.mark.parametrize("nb,np_,kw,key_range", [
    (0, 40, 1, 5),       # empty build side
    (40, 0, 1, 5),       # empty probe side
    (1, 1, 1, 1),
    (64, 100, 1, 0),     # all-duplicate keys
    (100, 100, 2, 3),    # dense collisions
    (300, 200, 3, 10_000),  # sparse, wide keys
    (128, 256, 2, 2**30),   # huge magnitudes incl. negatives
    (257, 129, 6, 2),    # ragged against the reference's 256-row tiles
])
def test_probe_blocked_matches_reference_grid(nb, np_, kw, key_range):
    _check_blocked(_case(np.random.default_rng(nb + np_), nb, np_, kw, key_range))


def test_probe_blocked_ignores_fingerprints_and_tiles():
    """Fingerprints are accepted and unused (colliding ones change
    nothing); the reference's tile sizes do not move its result."""
    case = list(_case(np.random.default_rng(6), 150, 170, 2, 4))
    case[1][:2, 0] = [-(2**31), 2**31 - 1]
    case[4][:2, 0] = [-(2**31), 2**31 - 1]
    zeros = (np.zeros(150, np.int32), np.zeros(170, np.int32))
    _check_blocked(tuple(case), zeros, tp=16, tb=64)


def test_probe_blocked_plain_chunks(monkeypatch):
    """The plain version's chunking (probe rows and build rows cut into
    ragged steps) does not change its result."""
    case = _case(np.random.default_rng(8), 333, 211, 2, 6)
    want = _port(case, fn=ref.probe)
    monkeypatch.setattr(ops, "_PLAIN_SEG", 7)
    monkeypatch.setattr(ops, "_PLAIN_PAIRS", 50)
    np.testing.assert_array_equal(_port(case, fn=ops.probe_blocked_plain), want)


def test_probe_blocked_cuda_tensor_never_takes_the_plain_path(monkeypatch, fake_card):
    calls, _ = fake_card
    seen = []
    monkeypatch.setattr(ops, "allpairs_plain", lambda *a: seen.append("plain") or a[1])
    case = [torch.from_numpy(a) for a in _case(np.random.default_rng(2), 8, 8, 1, 3)]
    before = _launch_counts(ops.probe)
    ops.probe(*case)
    assert seen == ["plain"] and calls == [] and _launch_counts(ops.probe) == before
    _on_card(monkeypatch)
    ops.probe(*case, build_fp=case[1][:, 0], probe_fp=case[4][:, 0])
    assert seen == ["plain"] and calls == ["table_build", "table_probe"]
    assert _launch_counts(ops.probe) == tuple(b + d for b, d in zip(before, (2, 1, 1)))


@pytest.mark.parametrize("nb,slots", [
    (0, 1), (1, 2), (2, 4), (3, 8), (2**16, 2**17), (2**16 + 1, 2**18),
    (15_120_032, 2**25),  # shard 0 of the main path at 2**25 rows
    (2**31 - 1, 2**32),
])
def test_table_slots(nb, slots):
    """The hash table's size: the next power of two >= 2 * NB, from the
    row count alone (no read of the valid count), so the load is <= 0.5."""
    assert ops.table_slots(nb) == slots
    assert slots >= 2 * nb and (slots == 1 or slots < 4 * nb)


def test_table_slots_rejects_rows_beyond_int32():
    with pytest.raises(ValueError, match="int32"):
        ops.table_slots(2**31)


def test_hash_probe_launcher_rejects_cpu_tensors():
    """The launcher takes CUDA tensors only; it raises before building
    anything, and nothing is counted."""
    case = [torch.from_numpy(a) for a in _case(np.random.default_rng(4), 8, 8, 1, 3)]
    before = _launch_counts(ops.probe)
    with pytest.raises(ValueError, match="cuda"):
        ops.hash_probe_cuda(*case, counter=ops.probe)
    assert _launch_counts(ops.probe) == before
