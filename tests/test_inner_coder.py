"""The inner coder (T4) against an independent numpy reference: the K=7
mother code as two np.convolve calls with G1=171o / G2=133o, then the Table 3
puncture pattern, across all five code rates and carried state."""

import jax.numpy as jnp
import numpy as np
import pytest

from dvbt_tpu import tables
from dvbt_tpu.ops import inner_coder

G1 = np.array([1, 1, 1, 1, 0, 0, 1], np.uint8)    # 171o over b[n..n-6]
G2 = np.array([1, 0, 1, 1, 0, 1, 1], np.uint8)    # 133o


def _reference(stream: np.ndarray, rate: str) -> np.ndarray:
    bits = np.unpackbits(stream)
    n = len(bits)
    x = np.convolve(bits, G1)[:n] % 2
    y = np.convolve(bits, G2)[:n] % 2
    period = len(tables.PUNCTURE[rate][0])
    pairs = np.stack([x, y], axis=1).reshape(n // period, 2 * period)
    order = tables.puncture_serial_order(rate)
    return pairs[:, order].reshape(-1).astype(np.uint8)


@pytest.mark.parametrize("rate", ["1/2", "2/3", "3/4", "5/6", "7/8"])
def test_inner_coder_matches_numpy_reference(rate):
    rng = np.random.default_rng(21)
    n_bytes = 3 * 5 * 7 * 40          # every puncture period divides 8*n
    stream = rng.integers(0, 256, 2 * n_bytes, dtype=np.uint8)
    want = _reference(stream, rate)
    enc = inner_coder.make_inner_coder(n_bytes, rate)
    st = inner_coder.init_state()
    got = []
    for blk in range(2):              # the second block uses carried state
        st, coded = enc(st, jnp.asarray(stream[blk * n_bytes:
                                               (blk + 1) * n_bytes]))
        got.append(np.asarray(coded))
    assert np.array_equal(np.concatenate(got), want)
    assert np.array_equal(np.asarray(st), np.unpackbits(stream)[-6:])


def test_inner_coder_ragged_blocks_match_one_shot():
    """Blocks of unequal size chained through the 6-bit state give the
    one-shot encoding of the whole stream."""
    rate = "2/3"
    rng = np.random.default_rng(22)
    sizes = (123 * 204, 17, 1)
    stream = rng.integers(0, 256, sum(sizes), dtype=np.uint8)
    st, got, pos = inner_coder.init_state(), [], 0
    for n in sizes:
        st, coded = inner_coder.make_inner_coder(n, rate)(
            st, jnp.asarray(stream[pos: pos + n]))
        got.append(np.asarray(coded))
        pos += n
    assert np.array_equal(np.concatenate(got), _reference(stream, rate))
