"""Port differential: the bloom prefilter's positions, build and probe.

``repro_torch.kernels.bloom.ops`` (on CPU tensors: the plain scatter and
gather that the CUDA kernels are held against on the card) against
``repro.kernels.bloom.ops`` — its jnp path and its Pallas kernels in
interpret mode — and against both packages' loop oracles.  Exact equality:
positions and filters are int32, probe results bool."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.kernels.bloom import ops as jops  # noqa: E402
from repro.kernels.bloom import ref as jref  # noqa: E402
from repro_torch.kernels.bloom import ops, ref  # noqa: E402

EXTREMES = np.array([-(2**31), -(2**31) + 1, -2, -1, 0, 1, 2**31 - 2, 2**31 - 1], np.int32)


def _rows(seed, n, kw, lo=-(2**31), hi=2**31):
    """Random (keys, sigs, mask, fp) with the int32 extremes in the first rows."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(lo, hi, (n, kw), dtype=np.int64).astype(np.int32)
    fp = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    m = min(n, len(EXTREMES))
    keys[:m, 0] = EXTREMES[:m]
    fp[:m] = EXTREMES[::-1][:m]
    sigs = rng.integers(0, 5, n).astype(np.int32)
    mask = rng.random(n) < 0.6
    return keys, sigs, mask, fp


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("bits", [128, 1000, 4096, 2**24])
@pytest.mark.parametrize("with_fp", [False, True])
@pytest.mark.parametrize("kw", [1, 3])
def test_positions_match_reference(bits, with_fp, kw):
    keys, sigs, _, fp = _rows(bits + kw, 300, kw)
    jfp = jnp.asarray(fp) if with_fp else None
    want = np.asarray(jops.positions(jnp.asarray(keys), jnp.asarray(sigs), bits, fp=jfp))
    got = ops.positions(_t(keys), _t(sigs), bits, fp=_t(fp) if with_fp else None)
    assert got.dtype == torch.int32 and got.shape == (300, ops.NPROBE)
    np.testing.assert_array_equal(got.numpy(), want)
    assert ops.n_words(bits) == jops.n_words(bits)


@pytest.mark.parametrize("bits", [128, 1024, 4096])
@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_build_probe_match_reference(bits, impl):
    """The plain build and probe (what the wrappers run on the CPU) against
    the reference's jnp path and its Pallas kernels (interpret mode), and
    the loop oracles of both packages; with and without fingerprints."""
    keys, sigs, mask, fp = _rows(bits, 200, 2, lo=0, hi=40)
    jk, js, jm = jnp.asarray(keys), jnp.asarray(sigs), jnp.asarray(mask)
    tk, ts, tm = _t(keys), _t(sigs), _t(mask)
    for jfp, tfp in ((None, None), (jnp.asarray(fp), _t(fp))):
        want_f = np.asarray(jops.build(jk, js, jm, bits, impl=impl, fp=jfp))
        pos = ops.positions(tk, ts, bits, fp=tfp)
        filt = ops.build_plain(pos, tm, ops.n_words(bits))
        assert filt.dtype == torch.int32 and filt.shape == (ops.n_words(bits), ops.LANES)
        np.testing.assert_array_equal(filt.numpy(), want_f)
        np.testing.assert_array_equal(ops.build(tk, ts, tm, bits, fp=tfp).numpy(), want_f)
        want_h = np.asarray(jops.probe(jnp.asarray(want_f), jk, js, bits, impl=impl, fp=jfp))
        np.testing.assert_array_equal(ops.probe_plain(pos, filt).numpy(), want_h)
        np.testing.assert_array_equal(ops.probe(filt, tk, ts, bits, fp=tfp).numpy(), want_h)
        assert want_h[mask].all()  # no false negatives
    # the oracles (which hash without fingerprints)
    want_f = jref.build(jk, js, jm, bits)
    np.testing.assert_array_equal(ref.build(tk, ts, tm, bits), want_f)
    np.testing.assert_array_equal(
        ref.probe(_t(want_f), tk, ts, bits), jref.probe(want_f, jk, js, bits)
    )


def test_build_probe_edges():
    """No rows, all rows inactive, and every active row on one bit."""
    nw = ops.n_words(256)
    empty = ops.build_plain(torch.zeros((0, 2), dtype=torch.int32),
                            torch.zeros((0,), dtype=torch.bool), nw)
    assert empty.shape == (nw, ops.LANES) and int(empty.sum()) == 0
    assert ops.probe_plain(torch.zeros((0, 2), dtype=torch.int32), empty).shape == (0,)
    pos = torch.full((50, 2), 255, dtype=torch.int32)
    assert int(ops.build_plain(pos, torch.zeros(50, dtype=torch.bool), nw).sum()) == 0
    filt = ops.build_plain(pos, torch.ones(50, dtype=torch.bool), nw)
    assert int(filt.sum()) == 1 and int(filt.reshape(-1)[255]) == 1
    assert bool(ops.probe_plain(pos, filt).all())
    assert not bool(ops.probe_plain(torch.zeros((3, 2), dtype=torch.int32), filt).any())


@given(seed=st.integers(0, 10_000), bits=st.sampled_from([256, 512]),
       with_fp=st.booleans())
@settings(max_examples=10, deadline=None)
def test_no_false_negatives_property(seed, bits, with_fp):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 80))
    keys = _t(rng.integers(0, 1000, (n, 3)).astype(np.int32))
    sigs = _t(rng.integers(0, 3, n).astype(np.int32))
    fp = _t(rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)) if with_fp else None
    filt = ops.build(keys, sigs, torch.ones(n, dtype=torch.bool), bits, fp=fp)
    assert bool(ops.probe(filt, keys, sigs, bits, fp=fp).all())


def test_filters_some_nonmembers():
    rng = np.random.default_rng(0)
    bits = 8192
    members = _t(rng.integers(0, 100, (50, 1)).astype(np.int32))
    zeros = torch.zeros(50, dtype=torch.int32)
    filt = ops.build(members, zeros, torch.ones(50, dtype=torch.bool), bits)
    others = _t(rng.integers(1000, 2000, (200, 1)).astype(np.int32))
    hits = ops.probe(filt, others, torch.zeros(200, dtype=torch.int32), bits)
    assert int(hits.sum()) < 40  # false-positive rate well under 20 %


def test_launch_counters_untouched_on_cpu():
    before = (ops.build.launches, ops.probe.launches)
    keys, sigs, mask, _ = (_t(a) for a in _rows(1, 100, 1))
    filt = ops.build(keys, sigs, mask, 1024)
    ops.probe(filt, keys, sigs, 1024)
    assert (ops.build.launches, ops.probe.launches) == before


def test_cuda_tensor_never_takes_the_plain_path(monkeypatch):
    """The wrappers pick the plain versions only for CPU tensors: a CUDA
    input goes to the kernel launchers (here stubs standing in for the
    card), never to the plain versions."""
    seen = []
    for name in ("build_cuda", "build_plain", "probe_cuda", "probe_plain"):
        real = getattr(ops, name)
        monkeypatch.setattr(
            ops, name, lambda *a, _n=name, _f=real: seen.append(_n) or _f(*a)
        )
    keys, sigs, mask, _ = (_t(a) for a in _rows(2, 20, 1))
    filt = ops.build(keys, sigs, mask, 256)
    ops.probe(filt, keys, sigs, 256)
    assert seen == ["build_plain", "probe_plain"]
    monkeypatch.setattr(type(keys), "is_cuda", property(lambda self: True))
    monkeypatch.setattr(ops, "build_cuda", lambda *a: seen.append("build_cuda") or filt)
    monkeypatch.setattr(ops, "probe_cuda", lambda *a: seen.append("probe_cuda") or mask)
    ops.build(keys, sigs, mask, 256)
    ops.probe(filt, keys, sigs, 256)
    assert seen == ["build_plain", "probe_plain", "build_cuda", "probe_cuda"]
