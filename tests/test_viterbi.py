"""Viterbi decoder tests (R7): exactness at zero/low noise, carried state,
all puncturing rates (SURVEY.md §4 implication 2)."""

import jax.numpy as jnp
import numpy as np
import pytest

from dvbt_tpu import tables
from dvbt_tpu.ops import inner_coder, viterbi


def _roundtrip(rate, n, flip=0, seed=0, body=512, overlap=96):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, size=n, dtype=np.uint8)
    enc = inner_coder.make_inner_coder(n // 8, rate)
    _, coded = enc(inner_coder.init_state(), jnp.asarray(np.packbits(bits)))
    coded = np.array(coded)  # writable copy
    if flip:
        pos = rng.choice(len(coded), size=flip, replace=False)
        coded[pos] ^= 1
    dep = inner_coder.make_depuncture(n, rate)
    x, y, xm, ym = dep(jnp.asarray(coded * np.uint8(15)))
    xm = jnp.broadcast_to(xm, x.shape).astype(jnp.uint8)
    ym = jnp.broadcast_to(ym, y.shape).astype(jnp.uint8)
    dec = viterbi.make_viterbi_decoder(n, body=body, overlap=overlap)
    _, out = dec(viterbi.init_state(overlap), x, y, xm, ym)
    return bits, np.asarray(out)


@pytest.mark.parametrize("rate", ["1/2", "2/3", "3/4", "5/6", "7/8"])
def test_viterbi_noiseless_exact(rate):
    period = len(tables.PUNCTURE[rate][0])
    n = 8 * period * (512 // period)
    bits, out = _roundtrip(rate, n)
    assert np.array_equal(out, bits)


def test_viterbi_corrects_sparse_errors():
    # rate 1/2, a few well-separated hard errors must be corrected
    bits, out = _roundtrip("1/2", 4096, flip=40, seed=3)
    assert np.array_equal(out, bits)


def test_viterbi_state_carry_matches_single_block():
    rate, n = "2/3", 4096
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2, size=n, dtype=np.uint8)
    enc = inner_coder.make_inner_coder(n // 8, rate)
    _, coded = enc(inner_coder.init_state(), jnp.asarray(np.packbits(bits)))
    dep = inner_coder.make_depuncture(n, rate)
    x, y, xm, ym = (np.asarray(a) for a in dep(coded * np.uint8(15)))
    xm = np.broadcast_to(xm, x.shape).astype(np.uint8)
    ym = np.broadcast_to(ym, y.shape).astype(np.uint8)

    dec_full = viterbi.make_viterbi_decoder(n, body=512, overlap=96)
    _, full = dec_full(viterbi.init_state(96),
                       jnp.asarray(x), jnp.asarray(y),
                       jnp.asarray(xm), jnp.asarray(ym))

    h = n // 2
    dec_half = viterbi.make_viterbi_decoder(h, body=512, overlap=96)
    st = viterbi.init_state(96)
    st, a = dec_half(st, jnp.asarray(x[:h]), jnp.asarray(y[:h]),
                     jnp.asarray(xm[:h]), jnp.asarray(ym[:h]))
    st, b = dec_half(st, jnp.asarray(x[h:]), jnp.asarray(y[h:]),
                     jnp.asarray(xm[h:]), jnp.asarray(ym[h:]))
    two = np.concatenate([np.asarray(a), np.asarray(b)])
    assert np.array_equal(two, bits)
    assert np.array_equal(np.asarray(full), bits)
