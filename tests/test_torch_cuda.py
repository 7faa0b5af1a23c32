"""Card tests of the port: each hand-written CUDA kernel (the hash join
behind the bucketed and the all-pairs probe; bloom build, pack and probe)
against its plain torch version and its oracle, and MSJ runs on the card
(default, with the bloom prefilter, with the all-pairs probe) against the
same runs on the CPU, and the serving path of the dense, MoE, SSM and
hybrid decoders on the card against the CPU (no kernel of the repo is on
it).  They need a CUDA
device and skip without one; on a machine with a card run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Exact equality: hits and outputs are booleans and int32 values; logits
within a stated float32 tolerance."""
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
            bloom.pack.launches, bloom.probe_packed.launches, bloom.probe.launches)


@pytest.mark.parametrize("probe_fn,bloom_bits,launched", [
    (ops.probe_bucketed, 0, (8, 0, 0, 0, 0, 0)),  # a table build and a table probe per shard
    # + a bloom build and a pack per shard, a packed probe per semi-join and shard
    (ops.probe_bucketed, 2**14, (8, 0, 4, 4, 16, 0)),
    (ops.probe, 0, (0, 8, 0, 0, 0, 0)),
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


def _bloom_rows(seed, n, kw, device, sig_range=4):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-(2**31), 2**31, (n, kw), dtype=np.int64).astype(np.int32)
    arrs = (keys, rng.integers(0, sig_range, n).astype(np.int32), rng.random(n) < 0.6)
    return [torch.from_numpy(a).to(device) for a in arrs]


def _check_bloom(keys, sigs, mask, bits, fp):
    """The kernels against their plain versions on one case: the fused
    build, ``probe`` and ``probe_packed`` (of the packed filter and of a
    stack of it and an empty one) against ``positions`` and the plain
    build and probe; no false negative."""
    nw = bloom.n_words(bits)
    before = _counts()
    filt = bloom.build(keys, sigs, mask, bits, fp=fp)
    found = bloom.probe(filt, keys, sigs, bits, fp=fp)
    stack = torch.stack([filt, torch.zeros_like(filt)])
    packed = bloom.pack(stack)
    found_packed = bloom.probe_packed(packed, keys, sigs, bits, fp=fp)
    torch.cuda.synchronize()
    pos = bloom.positions(keys, sigs, bits, fp=fp)
    assert torch.equal(filt, bloom.build_plain(pos, mask, nw))
    assert torch.equal(packed, bloom.pack_plain(stack))
    assert torch.equal(found, bloom.probe_plain(pos, filt))
    assert torch.equal(found_packed, found)
    assert bool(found[mask].all())
    # build, pack (in probe and alone), probe_packed (the same), probe's own
    n = 1 if keys.shape[0] else 0
    assert tuple(a - b for a, b in zip(_counts(), before))[2:] == (n, 2, 2 * n, 1 + n)
    return filt, found


@pytest.mark.parametrize("bits", [128, 384, 1000, 2**16, 2**24])
@pytest.mark.parametrize("n", [0, 1, 1000, 70_001])
def test_bloom_kernels_match_plain(cuda, bits, n):
    keys, sigs, mask = _bloom_rows(bits + n, n, 1, cuda)
    for fp in (None, keys[:, 0]):
        filt, _ = _check_bloom(keys, sigs, mask, bits, fp)
    if n <= 1000:
        want = bloom_ref.build(keys, sigs, mask, bits)
        assert np.array_equal(bloom.build(keys, sigs, mask, bits).cpu().numpy(), want)
        assert np.array_equal(bloom.probe(filt, keys, sigs, bits).cpu().numpy(),
                              bloom_ref.probe(filt, keys, sigs, bits))


@pytest.mark.parametrize("case", ["inactive", "one_bit", "last_bit", "bit31"])
def test_bloom_kernels_edge_positions(cuda, case):
    """All rows inactive; every row the same (sig, key), so at most two bits;
    rows chosen from a larger pool because a position of theirs is the
    filter's last bit, or bit 31 of its word."""
    bits = 2**12
    keys, sigs, mask = _bloom_rows(5, 200_000, 2, cuda)
    mask[:] = True
    if case == "inactive":
        mask[:] = False
    elif case == "one_bit":
        keys[:], sigs[:] = keys[0].clone(), int(sigs[0])
    else:
        pos = bloom.positions(keys, sigs, bits)
        hit = pos == bits - 1 if case == "last_bit" else (pos & 31) == 31
        rows = hit.any(1) | (torch.arange(len(sigs), device=cuda) % 50 == 0)
        keys, sigs, mask = keys[rows], sigs[rows], mask[rows]
        assert bool(hit.any())
    filt, found = _check_bloom(keys, sigs, mask, bits, None)
    if case == "inactive":
        assert not bool(filt.any())
    elif case == "one_bit":
        assert 1 <= int(filt.sum()) <= 2 and bool(found.all())
    elif case == "last_bit":
        assert int(filt.reshape(-1)[-1]) == 1
    else:
        assert bool((bloom.pack(filt).view(-1) < 0).any())  # bit 31 is the sign bit


@pytest.mark.parametrize("with_fp", [False, True])
def test_bloom_kernels_read_strided_rows(cuda, with_fp):
    """As in ``run_msj``: KW = 2 key columns and the fingerprint as views of
    one buffer, the signature a stride-0 broadcast; read in place, equal to
    the same rows copied."""
    rng = np.random.default_rng(4)
    n, bits = 50_000, 2**16
    flat = torch.from_numpy(rng.integers(-(2**31), 2**31, (n, 4), dtype=np.int64)
                            .astype(np.int32)).to(cuda)
    keys, fp = flat[:, 1:3], (flat[:, 3] if with_fp else None)
    sigs = torch.full((1,), 2, dtype=torch.int32, device=cuda).expand(n)
    mask = torch.from_numpy(rng.random(n) < 0.5).to(cuda)
    assert keys.stride() == (4, 1) and sigs.stride() == (0,)
    _check_bloom(keys, sigs, mask, bits, fp)
    copies = [keys.contiguous(), sigs.contiguous(), mask]
    fpc = None if fp is None else fp.contiguous()
    filt = bloom.build(*copies, bits, fp=fpc)
    assert torch.equal(filt, bloom.build(keys, sigs, mask, bits, fp=fp))
    packed = bloom.pack(filt)
    assert torch.equal(bloom.probe_packed(packed, keys, sigs, bits, fp=fp),
                       bloom.probe_packed(packed, copies[0], copies[1], bits, fp=fpc))


@pytest.mark.parametrize("n_src", [1, 16])
def test_bloom_pack_reads_a_strided_stack(cuda, n_src):
    """The received stack is a view: ``pack`` reads each source's filter at
    the source axis's stride, and equals its plain version (the max over
    the sources, then the bit pack) on 0/1 filters with bit 31 and the
    last bit set."""
    nw = bloom.n_words(2**20)
    buf = (torch.rand((n_src, 2, nw, bloom.LANES), device=cuda) < 0.05).to(torch.int32)
    buf[0, 1].view(-1)[31] = 1
    buf[-1, 1].view(-1)[-1] = 1
    stack = buf[:, 1]
    assert stack.stride(0) == 2 * nw * bloom.LANES
    got = bloom.pack(stack)
    want = bloom.pack_plain(stack)
    assert torch.equal(got, want)
    assert int(want[0]) < 0 and int(want[-1]) < 0
    if n_src == 1:
        assert torch.equal(bloom.pack(stack[0]), want)


# --------------------------------------------------------------------------
# the service and shard-loss recovery on the card
# --------------------------------------------------------------------------


@pytest.mark.parametrize("bloom_bits", [0, 4096])
def test_service_tick_on_card_equals_cpu(cuda, bloom_bits):
    from repro_torch.core.executor import ExecutorConfig
    from repro_torch.service import SGFService, catalog_from_numpy

    tenants = [queries.tenant_queries(t) for t in range(4)]
    db_np = queries.gen_db([q for qs in tenants for q in qs], n_guard=2048, n_cond=2048)
    outs, reports = {}, {}
    for dev in ("cpu", cuda):
        svc = SGFService(catalog_from_numpy(db_np, P=4, device=dev),
                         config=ExecutorConfig(bloom_bits=bloom_bits))
        reqs = [svc.submit(qs, tenant=t) for t, qs in enumerate(tenants)]
        svc.tick()
        assert all(r.done for r in reqs)
        outs[str(dev)] = [r.outputs["Z0"] for r in reqs]
        reports[str(dev)] = svc.last_report
        # the warm tick serves the same tensors and runs nothing
        again = [svc.submit(qs, tenant=t) for t, qs in enumerate(tenants)]
        svc.tick()
        assert svc.last_report.n_jobs == 0
        for a, b in zip(again, reqs):
            assert torch.equal(a.outputs["Z0"].data, b.outputs["Z0"].data)
    for a, b in zip(outs["cpu"], outs["cuda"]):
        assert b.data.is_cuda
        assert torch.equal(a.data, b.data.cpu()) and torch.equal(a.valid, b.valid.cpu())
    assert reports["cpu"].bytes_shuffled() == reports["cuda"].bytes_shuffled()
    assert [r.stats for r in reports["cpu"].records] == \
        [r.stats for r in reports["cuda"].records]
    assert any(r.backend == "kernel" for r in reports["cuda"].records)


def test_catalog_compares_resolved_devices(cuda):
    from repro_torch.core.relation import Relation
    from repro_torch.service import Catalog

    cat = Catalog(P=2)  # the card by default
    index = torch.cuda.current_device()
    assert cat.device == torch.device("cuda", index)
    rows = np.arange(8, dtype=np.int32).reshape(4, 2)
    assert cat.register("R", rows).data.device == cat.device
    rel = Relation.from_numpy("S", rows, P=2, device=f"cuda:{index}")
    assert cat.register("S", rel).data is rel.data
    with pytest.raises(ValueError, match=f"'C' lies on cpu, catalog on cuda:{index}$"):
        cat.register("C", Relation.from_numpy("C", rows, P=2, device="cpu"))
    if torch.cuda.device_count() > 1:
        other = (index + 1) % torch.cuda.device_count()
        with pytest.raises(ValueError, match=f"lies on cuda:{other}, catalog on cuda:{index}$"):
            cat.register("O", Relation.from_numpy("O", rows, P=2, device=f"cuda:{other}"))


def test_lose_recover_shard_on_card_no_aliasing(cuda):
    from repro_torch.core.relation import Relation
    from repro_torch.ft import elastic

    rows = np.random.default_rng(3).integers(-99, 99, (1000, 3)).astype(np.int32)
    rel = Relation.from_numpy("R", rows, P=8, device=cuda)
    before = (rel.data.clone(), rel.valid.clone())
    damaged = elastic.lose_shard(rel, 3)
    assert damaged.data.is_cuda and damaged.data.data_ptr() != rel.data.data_ptr()
    assert damaged.valid.data_ptr() != rel.valid.data_ptr()
    assert not bool(damaged.valid[3].any()) and not bool(damaged.data[3].any())
    assert torch.equal(rel.data, before[0]) and torch.equal(rel.valid, before[1])
    recovered = elastic.recover_shard(damaged, rel, 3)
    assert recovered.data.is_cuda
    assert recovered.data.data_ptr() not in (rel.data.data_ptr(), damaged.data.data_ptr())
    assert torch.equal(recovered.data, rel.data) and torch.equal(recovered.valid, rel.valid)
    assert not bool(damaged.valid[3].any())
    cpu = elastic.recover_shard(
        elastic.lose_shard(Relation.from_numpy("R", rows, P=8, device="cpu"), 3),
        Relation.from_numpy("R", rows, P=4, device="cpu"), 3)
    other = elastic.recover_shard(damaged, Relation.from_numpy("R", rows, P=4, device=cuda), 3)
    assert torch.equal(other.data.cpu(), cpu.data) and torch.equal(other.valid.cpu(), cpu.valid)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-72b"])
def test_dense_serving_on_card_equals_cpu(cuda, arch):
    """The dense decoder's prefill and decode logits on the card against
    the CPU, float32 with TF32 off, same weights: within 1e-4 × max |logit|
    (summation order only); the batcher's tokens equal unbatched
    generation's on the card, exactly."""
    _serving_on_card_equals_cpu(cuda, arch)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "falcon-mamba-7b", "zamba2-7b"])
def test_family_serving_on_card_equals_cpu(cuda, arch):
    """The same for the MoE, SSM and hybrid families at SMOKE size (a
    31-token prompt; zamba2's 64-slot shared-attention window)."""
    _serving_on_card_equals_cpu(cuda, arch)


def _serving_on_card_equals_cpu(cuda, arch):
    from repro_torch.configs import get_config
    from repro_torch.models import model
    from repro_torch.serve.batcher import Batcher, Request
    from repro_torch.serve.serve_step import greedy_generate

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch, smoke=True, dtype="float32")
    card = model.init_params(cfg, 0, device=cuda)
    cpu = model.params_from_numpy(cfg, model.params_to_numpy(card), device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 33))
    logits = {}
    for where, p in (("card", card), ("cpu", cpu)):
        t = torch.as_tensor(tokens, device=p.device)
        with torch.inference_mode():
            cache, a = model.prefill(cfg, p, {"tokens": t[:, :31]}, 48)
            cache, b = model.decode_step(cfg, p, cache, t[:, 31:32])
            cache, c = model.decode_step(cfg, p, cache, t[:, 32:33])
        logits[where] = torch.stack([a, b, c]).cpu()
    err = (logits["card"] - logits["cpu"]).abs().max() / logits["cpu"].abs().max()
    assert float(err) <= 1e-4
    rng = np.random.default_rng(2)
    reqs = [Request(i, rng.integers(0, cfg.vocab, n).astype(np.int32), 6)
            for i, n in enumerate((7, 29, 3, 16, 11))]
    b = Batcher(cfg, card, max_batch=3, max_len=48)
    for r in reqs:
        b.submit(r)
    b.run()
    for r in reqs:
        batch = {"tokens": torch.as_tensor(r.prompt[None, :], device=cuda)}
        assert greedy_generate(cfg, card, batch, steps=6, max_len=48)[0].tolist() == r.out


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "seamless-m4t-medium"])
def test_frontend_serving_on_card_equals_cpu(cuda, arch):
    """The VLM and the enc-dec at SMOKE size: prefill with the stub
    frontend's embeddings and two decode steps on the card against the
    CPU (float32, TF32 off, within 1e-4 × max |logit|); greedy generation
    of a two-request batch equal to each request alone, on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import model
    from repro_torch.serve.serve_step import greedy_generate

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch, smoke=True, dtype="float32")
    card = model.init_params(cfg, 0, device=cuda)
    cpu = model.params_from_numpy(cfg, model.params_to_numpy(card), device="cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, (2, 33))
    emb = (0.1 * rng.standard_normal((2, cfg.frontend_tokens or 9, cfg.d_model))).astype(
        np.float32)
    logits = {}
    for where, p in (("card", card), ("cpu", cpu)):
        t = torch.as_tensor(tokens, device=p.device)
        e = torch.as_tensor(emb, device=p.device)
        with torch.inference_mode():
            cache, a = model.prefill(cfg, p, {"tokens": t[:, :31], "embeds": e}, 64)
            cache, b = model.decode_step(cfg, p, cache, t[:, 31:32])
            cache, c = model.decode_step(cfg, p, cache, t[:, 32:33])
        logits[where] = torch.stack([a, b, c]).cpu()
    err = (logits["card"] - logits["cpu"]).abs().max() / logits["cpu"].abs().max()
    assert float(err) <= 1e-4
    t = torch.as_tensor(tokens[:, :20], device=cuda)
    e = torch.as_tensor(emb, device=cuda)
    both = greedy_generate(cfg, card, {"tokens": t, "embeds": e}, steps=5, max_len=64)
    for i in range(2):
        alone = greedy_generate(cfg, card, {"tokens": t[i:i + 1], "embeds": e[i:i + 1]},
                                steps=5, max_len=64)
        assert both[i].tolist() == alone[0].tolist()


@pytest.mark.parametrize("causal,window,S", [(True, 0, 300), (False, 0, 257), (True, 64, 300)])
def test_flash_and_rmsnorm_backward_on_card_equal_cpu(cuda, causal, window, S):
    """The flash and rmsnorm backwards on the card against the CPU on the
    same float32 inputs (TF32 off): within 1e-4 of each gradient's max."""
    from repro_torch.models import flash, layers

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(S)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((2, 2, 2, S, 32), (2, 2, S, 32), (2, 2, S, 32), (2, 2, 2, S, 32),
             (3, S, 64), (64,), (3, S, 64))]
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        q, k, v, do, x, w, dy = (torch.as_tensor(a, device=dev) for a in arrs)
        for a in (q, k, v, x, w):
            a.requires_grad_(True)
        flash.flash_attention(q, k, v, causal, window, 0, 128, 128).backward(do)
        layers.rmsnorm(x, w, 1e-6).backward(dy)
        grads[dev.type] = [a.grad.cpu() for a in (q, k, v, x, w)]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-4


def test_loss_and_grads_on_card_equal_cpu(cuda):
    """qwen3-0.6b SMOKE's loss and every gradient on the card against the
    CPU, float32 (TF32 off), same weights: within 1e-4 of each leaf's max
    |g| (the embedding backward's atomics reorder sums on the card)."""
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic
    from repro_torch.models import model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen3-0.6b", smoke=True, dtype="float32")
    card = model.init_params(cfg, 0, device=cuda).requires_grad_(True)
    cpu = model.params_from_numpy(cfg, model.params_to_numpy(card), device="cpu")
    cpu.requires_grad_(True)
    out = {}
    for where, p in (("card", card), ("cpu", cpu)):
        batch = synthetic.token_batch(cfg, "train", 2, 61, 0, device=p.device)
        loss = model.loss_fn(cfg, p, batch)
        loss.backward()
        out[where] = (float(loss.detach()), [q.grad.cpu() for q in p.parameters()])
    assert abs(out["card"][0] - out["cpu"][0]) <= 1e-5 * out["cpu"][0]
    for got, want in zip(out["card"][1], out["cpu"][1]):
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-4


def test_filter_corpus_on_card_equals_cpu(cuda):
    """The Keep query on the card (each MSJ job on the hash-join kernel)
    against the CPU: the same kept ids and summary counters."""
    from repro_torch.data import pipeline, synthetic

    rels = synthetic.corpus_relations(1 << 16, seed=3)
    before = ops.probe_bucketed.launches
    got, summary = pipeline.filter_corpus(rels, P=8, device=cuda)
    assert ops.probe_bucketed.launches > before
    want, want_summary = pipeline.filter_corpus(rels, P=8, device="cpu")
    assert got.is_cuda and torch.equal(got.cpu(), want)
    for k in ("jobs", "bytes_shuffled", "input_rows"):
        assert summary[k] == want_summary[k]


@pytest.fixture(scope="module")
def nccl_mesh():
    """The host mesh at world size 1 over NCCL (``make_host_mesh`` starts
    the one-rank group), torn down after the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL runs on the card")
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib

    mesh = mesh_lib.make_host_mesh()
    yield mesh
    dist.destroy_process_group()


def test_meshcomm_over_nccl_equals_simcomm(nccl_mesh):
    """MeshComm's primitives at world size 1 over NCCL, and the A3 MSJ
    stages through ``run_pipeline`` under it against ``SimComm(1)``, bit
    for bit, the probe kernel launched."""
    import torch.distributed as dist

    from repro_torch.core import msj
    from repro_torch.engine.comm import MeshComm, run_pipeline

    assert dist.get_backend() == "nccl"
    comm = MeshComm(nccl_mesh, "data")
    x = torch.arange(12, dtype=torch.int32, device="cuda").reshape(1, 12)
    b = x % 3 == 0
    assert comm.P == 1 and comm.shard_id() == 0
    assert torch.equal(comm.all_to_all(x), x) and torch.equal(comm.all_to_all(b), b)
    assert torch.equal(comm.all_gather(x[0]), x) and torch.equal(comm.all_reduce_sum(x), x)
    assert torch.equal(comm.all_reduce_or(b), b) and torch.equal(comm.all_reduce_or(x), x)

    qs = queries.make_queries("A3")
    sjs = [sj for q in qs for sj in semijoins_of(q)]
    db = db_from_dict(queries.gen_db(qs, n_guard=4096, n_cond=4096, seed=1), P=1, device="cuda")
    spec = msj.make_spec(sjs)
    cap = msj.count_forward_cap(spec, db, SimComm(1))
    out = {}
    for label, c in (("sim", SimComm(1)), ("mesh", comm)):
        kit = msj._MSJKit(db, spec, c, cap, probe_fn=ops.probe_bucketed)
        before = ops.probe_bucketed.launches
        got = run_pipeline(c, [kit.stage_map, kit.stage_probe, kit.stage_out], kit.stacked)
        assert ops.probe_bucketed.launches > before
        out[label] = got
    (want, want_stats), (got, got_stats) = out["sim"], out["mesh"]
    for name in want:
        assert torch.equal(want[name].data[0], got[name].data)
        assert torch.equal(want[name].valid[0], got[name].valid)
    for k in want_stats:
        assert torch.equal(want_stats[k][0], got_stats[k]), k


def test_sharded_train_step_over_nccl_equals_unsharded(nccl_mesh):
    """qwen3-0.6b SMOKE on the (1, 1) mesh: two steps with microbatches
    and compression, bit for bit the unsharded step's."""
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic
    from repro_torch.ft import elastic
    from repro_torch.models import model
    from repro_torch.train import optimizer, train_step as ts

    cfg = get_config("qwen3-0.6b", smoke=True)
    opt = optimizer.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = ts.make_train_step(cfg, opt, microbatches=2, compress_frac=0.1)
    plain = ts.init_state(cfg, 0, opt, compress_frac=0.1, device="cuda")
    sharded = ts.init_state(cfg, 0, opt, compress_frac=0.1, device="cuda")
    sharded = elastic.reshard_state(sharded, ts.state_specs(cfg, sharded, nccl_mesh), nccl_mesh)
    for i in range(2):
        batch = synthetic.token_batch(cfg, "train", 4, 64, i, device="cuda")
        plain, m = step(plain, batch)
        sharded, ms = step(sharded, batch)
        assert float(m["loss"]) == float(ms["loss"])
    for key in ("params", "err"):
        want, got = model.params_to_numpy(plain[key]), model.params_to_numpy(sharded[key])
        assert all(np.array_equal(a, b) for a, b in zip(_leaves(want), _leaves(got)))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


_TRACE = """
import json, sys, torch
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import ShapeSpec
from repro_torch.launch import dryrun, mesh as mesh_lib
torch.cuda.set_device(0)
mesh_lib.make_fake_group(1)
mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=mesh_lib.AXES)
rec = dryrun.run_cell("qwen3-0.6b", ShapeSpec("train_4x1024", 1024, 4, "train"), mesh=mesh,
                      device="cuda", overrides={"n_layers": 2}, verbose=False)
print(json.dumps(rec))
"""


def test_dryrun_trace_holds_to_the_real_step_on_card(nccl_mesh):
    """The dry-run's trace of a train step (qwen3-0.6b's width, 2 layers,
    4 × 1024 tokens in its 2 microbatches) on a fake (1, 1) mesh, in a
    subprocess whose default group is the fake one, against the same step
    on the card's (1, 1) NCCL mesh: the matmul FLOPs equal
    ``FlopCounterMode``'s, the predicted peak above the step's start is
    within 10 % of ``max_memory_allocated``'s, and the step takes at least
    the roofline's lower bound."""
    import json
    import os
    import subprocess
    import sys
    import time
    from pathlib import Path

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.data import synthetic
    from repro_torch.ft import elastic
    from repro_torch.models import model
    from repro_torch.train import optimizer, train_step as ts

    src = str(Path(__file__).resolve().parents[1] / "src")
    run = subprocess.run([sys.executable, "-c", _TRACE], capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, PYTHONPATH=src))
    assert run.returncode == 0, run.stderr[-3000:]
    rec = json.loads(run.stdout.strip().splitlines()[-1])

    cfg = get_config("qwen3-0.6b", n_layers=2)
    opt = optimizer.OptConfig()
    state = ts.init_state(cfg, 0, opt, device="cuda")
    state = elastic.reshard_state(state, ts.state_specs(cfg, state, nccl_mesh), nccl_mesh)
    batch = synthetic.token_batch(cfg, "train", 4, 1024, 0, device="cuda")
    batch = elastic.reshard_state(batch, model.batch_specs(cfg, batch, nccl_mesh), nccl_mesh)
    step = ts.make_train_step(cfg, opt, microbatches=cfg.train_microbatches)
    with FlopCounterMode(display=False) as fc:
        state, m = step(state, batch)
        float(m["loss"])
    del m
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    float(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - start
    assert int(rec["xla_flops_per_chip"]) == fc.get_total_flops()
    assert abs(rec["temp_bytes"] - peak) <= 0.10 * peak, (rec["temp_bytes"], peak)
    assert wall >= rec["roofline"]["step_lower_bound_s"], (wall, rec["roofline"])
