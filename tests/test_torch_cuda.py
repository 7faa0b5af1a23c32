"""Card tests of the port: the hand-written CUDA probe kernel against its
plain torch version, and one MSJ run on the card against the same run on
the CPU.  They need a CUDA device and skip without one; on a machine with
a card run them with

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
from repro_torch.kernels.msj_probe import ops, ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the probe kernel has no CPU mode")
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
    assert ops.probe_bucketed.launches == before + (1 if nb and np_ else 0)


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


def test_msj_on_card_equals_cpu(cuda):
    qs = queries.make_queries("A3")
    db_np = queries.gen_db(qs, n_guard=4096, n_cond=4096, seed=2)
    sjs = [sj for q in qs for sj in semijoins_of(q)]
    out_c, st_c = run_msj(db_from_dict(db_np, P=4, device="cpu"), sjs, SimComm(4),
                          probe_fn=ops.probe_bucketed)
    before = ops.probe_bucketed.launches
    out_g, st_g = run_msj(db_from_dict(db_np, P=4), sjs, SimComm(4),
                          probe_fn=ops.probe_bucketed)
    assert ops.probe_bucketed.launches == before + 4
    for k in out_c:
        assert torch.equal(out_c[k].data, out_g[k].data.cpu())
        assert torch.equal(out_c[k].valid, out_g[k].valid.cpu())
    assert {k: int(v) for k, v in st_c.items()} == {k: int(v) for k, v in st_g.items()}
