"""Port differential: ``repro_torch.engine.hashing`` is bit-exact with
``repro.engine.hashing`` on edge and random int32 inputs over several
salts (uint32 wraparound, logical shifts, unsigned modulo, int32 wrap).
Exact equality: every value is an integer."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.engine import hashing as ref  # noqa: E402
from repro_torch.engine import hashing as port  # noqa: E402

EDGES = np.array(
    [-(2**31), -(2**31) + 1, -2, -1, 0, 1, 2, 0x7FFFFFFE, 0x7FFFFFFF, 0x7FEB352D],
    np.int32,
)
SALTS = [0, 1, 7, 0x5EED, 2**31 - 1, 0xFFFFFFFF]


def _inputs(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rand = rng.integers(-(2**31), 2**31, 500, dtype=np.int64).astype(np.int32)
    return np.concatenate([EDGES, rand])


def _eq(a_jax, b_torch):
    a = np.asarray(a_jax).astype(np.int64)
    b = b_torch.numpy().astype(np.int64)
    np.testing.assert_array_equal(a, b)


def test_mix32_and_prune_key_edges():
    x = _inputs()
    _eq(ref.mix32(jnp.asarray(x)), port.mix32(torch.from_numpy(x)))
    _eq(ref.prune_key(jnp.asarray(x)), port.prune_key(torch.from_numpy(x)))
    assert int(port.prune_key(torch.from_numpy(x)).min()) >= 0


@pytest.mark.parametrize("salt", SALTS)
@pytest.mark.parametrize("width", [1, 2, 4])
def test_hash_fingerprint_route_bucket(salt, width):
    x = _inputs(width)
    cols = np.stack([np.roll(x, 3 * k) for k in range(width)], axis=1)
    jc, tc = jnp.asarray(cols), torch.from_numpy(cols)
    _eq(ref.hash_cols(jc, salt=salt), port.hash_cols(tc, salt=salt))
    _eq(ref.fingerprint(jc, salt=salt), port.fingerprint(tc, salt=salt))
    for P in (1, 3, 16):
        _eq(ref.bucket_of(ref.hash_cols(jc, salt=salt), P),
            port.bucket_of(port.hash_cols(tc, salt=salt), P))
        _eq(ref.route_of(jc[:, 0], salt, P), port.route_of(tc[:, 0], salt, P))
    if width == 1:
        _eq(ref.fingerprint(jc, exact=True), port.fingerprint(tc, exact=True))


def test_dtypes_are_the_engine_contract():
    x = torch.from_numpy(_inputs())
    assert port.fingerprint(x[:, None]).dtype == torch.int32
    assert port.route_of(x, 3, 16).dtype == torch.int32
    assert port.prune_key(x).dtype == torch.int32
    h = port.hash_cols(x)
    assert h.dtype == torch.int64 and int(h.min()) >= 0 and int(h.max()) < 2**32
