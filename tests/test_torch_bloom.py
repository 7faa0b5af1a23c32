"""Port differential: the bloom prefilter's positions, build and probe.

``repro_torch.kernels.bloom.ops`` (on CPU tensors: the plain scatter and
gather that the CUDA kernels are held against on the card) against
``repro.kernels.bloom.ops`` — its jnp path and its Pallas kernels in
interpret mode — and against both packages' loop oracles.  Exact equality:
positions and filters are int32, probe results bool."""
import contextlib

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
    before = _counts()
    keys, sigs, mask, _ = (_t(a) for a in _rows(1, 100, 1))
    filt = ops.build(keys, sigs, mask, 1024)
    ops.probe(filt, keys, sigs, 1024)
    ops.probe_packed(ops.pack(filt[None].expand(3, -1, -1)), keys, sigs, 1024)
    assert _counts() == before


def _counts():
    return tuple(f.launches for f in (ops.build, ops.pack, ops.probe_packed, ops.probe))


def _pack_np(filt):
    """numpy bit pack of a flat 0/1 filter: bit b at word b >> 5, bit b & 31."""
    bits = (np.asarray(filt).reshape(-1, 32) > 0).astype(np.uint8)
    return np.packbits(bits, axis=1, bitorder="little").view("<u4").view(np.int32).reshape(-1)


def _ref_stack(seed, n_src, bits, kw=2):
    """``n_src`` filters built by ``repro`` over random rows (the shape the
    file's build test compiles), stacked; bit 31 of word 0 set in the first
    and the last bit in the last, and the rows of the first."""
    filts = []
    for s in range(n_src):
        keys, sigs, mask, fp = _rows(seed + s, 200, kw, lo=0, hi=40)
        filts.append(np.asarray(jops.build(jnp.asarray(keys), jnp.asarray(sigs),
                                           jnp.asarray(mask), bits, fp=jnp.asarray(fp))))
        if s == 0:
            first = (keys, sigs, mask, fp)
    stack = np.stack(filts)
    stack[0].reshape(-1)[31] = 1
    stack[-1].reshape(-1)[-1] = 1
    return stack, first


@pytest.mark.parametrize("bits", [128, 384, 1000, 2**16])
@pytest.mark.parametrize("n_src", [1, 4])
def test_pack_matches_reference(bits, n_src):
    """``pack`` (its plain version on the CPU) against the bit pack of
    ``repro``'s filters OR-ed over the stack; a lone ``(n_words, 128)``
    filter packs as a stack of one."""
    stack, _ = _ref_stack(bits + n_src, n_src, bits)
    want = _pack_np(stack.max(axis=0))
    assert (want.view(np.uint32)[[0, -1]] >> 31).all()  # bit 31, the last bit
    got = ops.pack(_t(stack))
    assert got.dtype == torch.int32 and got.shape == (ops.n_words(bits) * 4,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ops.pack_plain(_t(stack)).numpy(), want)
    if n_src == 1:
        np.testing.assert_array_equal(ops.pack(_t(stack[0])).numpy(), want)


@pytest.mark.parametrize("bits", [384, 4096])
@pytest.mark.parametrize("with_fp", [False, True])
@pytest.mark.parametrize("kw", [1, 2])
@pytest.mark.parametrize("sig_view", ["column", "stride0"])
def test_probe_packed_matches_reference(bits, with_fp, kw, sig_view):
    """``probe_packed`` of the packed OR of a stack against ``repro``'s
    probe of the OR-ed filter; the signature column as given or as the
    stride-0 view ``run_msj`` passes.  The stack's first filter holds the
    probed rows' active ones, so the probe answers both ways."""
    stack, (keys, sigs, mask, fp) = _ref_stack(bits + kw, 3, bits, kw=kw)
    if not with_fp:  # the first filter over the same rows, hashed without fp
        stack[0] = np.asarray(jops.build(jnp.asarray(keys), jnp.asarray(sigs),
                                         jnp.asarray(mask), bits))
    if sig_view == "stride0":
        sigs = np.full_like(sigs, 3)
        tsigs = torch.full((1,), 3, dtype=torch.int32).expand(len(sigs))
        assert tsigs.stride() == (0,)
    else:
        tsigs = _t(sigs)
    jfp, tfp = (jnp.asarray(fp), _t(fp)) if with_fp else (None, None)
    want = np.asarray(jops.probe(jnp.asarray(stack.max(axis=0)), jnp.asarray(keys),
                                 jnp.asarray(sigs), bits, fp=jfp))
    got = ops.probe_packed(ops.pack(_t(stack)), _t(keys), tsigs, bits, fp=tfp)
    assert got.dtype == torch.bool and got.shape == (len(sigs),)
    np.testing.assert_array_equal(got.numpy(), want)
    pos = ops.positions(_t(keys), tsigs, bits, fp=tfp)
    np.testing.assert_array_equal(ops.probe_packed_plain(ops.pack(_t(stack)), pos).numpy(), want)
    if sig_view == "column":
        assert want[mask].all() and not want.all()


@pytest.fixture
def fake_card(monkeypatch):
    """Stands in for the card at the bloom kernels' ctypes entry points:
    each records its kernel's name and returns the next code of ``rcs`` (0 =
    launched, the default).  A test makes its CPU tensors claim to be on
    CUDA itself."""
    calls, rcs = [], []

    def entry(name):
        return lambda *args: calls.append(name) or (rcs.pop(0) if rcs else 0)

    monkeypatch.setattr(ops, "_launchers",
                        lambda: (entry("build"), entry("pack"), entry("probe_packed")))
    monkeypatch.setattr(ops, "_stream", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    return calls, rcs


def _on_card(monkeypatch):
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))


def test_cuda_tensor_never_takes_the_plain_path(monkeypatch, fake_card):
    """The wrappers pick the plain versions only for CPU tensors: a CUDA
    input goes to the kernels' entry points (stubbed here), never to
    ``positions`` or a plain version; each launch counts once for its
    kernel, and ``probe``'s two once each for the wrapper too."""
    calls, _ = fake_card
    seen = []
    for name in ("positions", "build_plain", "probe_plain", "pack_plain",
                 "probe_packed_plain"):
        real = getattr(ops, name)
        monkeypatch.setattr(
            ops, name, lambda *a, _n=name, _f=real, **k: seen.append(_n) or _f(*a, **k)
        )
    keys, sigs, mask, _ = (_t(a) for a in _rows(2, 20, 1))
    filt = ops.build(keys, sigs, mask, 256)
    ops.probe(filt, keys, sigs, 256)
    packed = ops.pack(filt)
    ops.probe_packed(packed, keys, sigs, 256)
    plain = ["positions", "build_plain", "positions", "probe_plain", "pack_plain",
             "positions", "probe_packed_plain"]
    assert seen == plain and calls == []
    before = _counts()
    _on_card(monkeypatch)
    ops.build(keys, sigs, mask, 256)
    ops.probe(filt, keys, sigs, 256)
    ops.pack(filt[None].expand(4, -1, -1))
    ops.probe_packed(packed, keys, sigs, 256)
    assert seen == plain
    assert calls == ["build", "pack", "probe_packed", "pack", "probe_packed"]
    assert _counts() == tuple(b + d for b, d in zip(before, (1, 2, 2, 2)))


@pytest.mark.parametrize("which,rcs,counted", [
    ("build", [700], (0, 0, 0, 0)),
    ("probe", [0, 700], (0, 1, 0, 1)),   # the pack launched, the probe failed
    ("probe", [700], (0, 0, 0, 0)),      # the pack failed: the probe is not tried
])
def test_bloom_launch_counted_only_where_a_kernel_launched(monkeypatch, fake_card, which,
                                                           rcs, counted):
    calls, codes = fake_card
    codes.extend(rcs)
    keys, sigs, mask, _ = (_t(a) for a in _rows(3, 20, 1))
    filt = torch.zeros((ops.n_words(256), ops.LANES), dtype=torch.int32)
    _on_card(monkeypatch)
    before = _counts()
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        if which == "build":
            ops.build(keys, sigs, mask, 256)
        else:
            ops.probe(filt, keys, sigs, 256)
    assert calls == (["build"] if which == "build" else ["pack", "probe_packed"][: len(rcs)])
    assert _counts() == tuple(b + d for b, d in zip(before, counted))


def test_no_rows_no_launch(monkeypatch, fake_card):
    """No rows: an all-zero filter and no flags, with no launch."""
    calls, _ = fake_card
    _on_card(monkeypatch)
    keys, sigs = torch.zeros((0, 2), dtype=torch.int32), torch.zeros((0,), dtype=torch.int32)
    filt = ops.build(keys, sigs, torch.zeros((0,), dtype=torch.bool), 1000)
    assert filt.shape == (ops.n_words(1000), ops.LANES) and not bool(filt.any())
    packed = torch.zeros((ops.n_words(1000) * 4,), dtype=torch.int32)
    assert ops.probe_packed(packed, keys, sigs, 1000).shape == (0,)
    assert calls == []


def test_card_wrappers_check_their_inputs(monkeypatch, fake_card):
    """Strided columns and a stride-0 signature view pass (the kernels take
    element strides); a wrong dtype, a packed bitset of the wrong size or a
    filter whose rows are not contiguous raises before any launch."""
    calls, _ = fake_card
    _on_card(monkeypatch)
    flat = torch.zeros((10, 4), dtype=torch.int32)
    sig0 = torch.zeros((1,), dtype=torch.int32).expand(10)
    packed = torch.zeros((ops.n_words(256) * 4,), dtype=torch.int32)
    ops.probe_packed(packed, flat[:, 1:3], sig0, 256, fp=flat[:, 3])
    ops.build(flat[:, 1:3], flat[:, 0], torch.ones(10, dtype=torch.bool), 256, fp=flat[:, 3])
    assert calls == ["probe_packed", "build"]
    with pytest.raises(ValueError, match="int32"):
        ops.probe_packed(packed, flat[:, 1:3].long(), sig0, 256)
    with pytest.raises(ValueError, match="shape"):
        ops.probe_packed(packed[1:], flat[:, 1:3], sig0, 256)
    wide = torch.zeros((3, ops.n_words(256), 2 * ops.LANES), dtype=torch.int32)
    with pytest.raises(ValueError, match="contiguous"):
        ops.pack(wide[:, :, : ops.LANES])
    buf = torch.zeros((3, 2, ops.n_words(256), ops.LANES), dtype=torch.int32)
    ops.pack(buf[:, 1])  # each filter contiguous, the sources strided
    assert calls == ["probe_packed", "build", "pack"]
