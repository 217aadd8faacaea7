"""Pallas (Triton) Viterbi kernel parity vs the jnp scan (ops.viterbi), run
in the Pallas interpreter (SURVEY.md §7 step 6: every kernel ships with an
interpret-mode parity test).  Both are integer ACS with the same tie rules,
so any difference is a bug: the tolerance is zero."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest

from dvbt_tpu import tables
from dvbt_tpu.kernels import viterbi_triton as vt
from dvbt_tpu.ops import inner_coder, viterbi as vj
from dvbt_tpu.utils import bits as bitutils


def _parity(v):
    p = v ^ (v >> 4)
    p ^= p >> 2
    p ^= p >> 1
    return p & 1


def test_branch_table_matches_generators():
    """Edge outputs from the generator polynomials directly: the 7-bit
    window of edge pred(s', d) -> s' is (input bit s'>>5, then the 6 bits of
    the predecessor), tapped by G1=171o / G2=133o."""
    pox, poy = vt.branch_table()
    for s in range(64):
        for d in (0, 1):
            pred = ((s & 31) << 1) | d
            window = ((s >> 5) << 6) | pred
            assert pox[s][d] == _parity(window & tables.G1_OCT), (s, d)
            assert poy[s][d] == _parity(window & tables.G2_OCT), (s, d)


def test_pack_soft_fields():
    rng = np.random.default_rng(0)
    x, y = (jnp.asarray(rng.integers(0, 16, 64), jnp.uint8) for _ in "xy")
    xm, ym = (jnp.asarray(rng.integers(0, 2, 64), jnp.uint8) for _ in "xy")
    p = np.asarray(vt.pack_soft(x, y, xm, ym)).astype(np.int64)
    assert np.array_equal(p & 15, x)
    assert np.array_equal((p >> 4) & 15, y)
    assert np.array_equal((p >> 8) & 1, xm)
    assert np.array_equal((p >> 9) & 1, ym)
    assert (p >> 10 == 0).all()


def _coded(bits, rate, n_bits):
    coder = inner_coder.make_inner_coder(n_bits // 8, rate)
    _, coded = coder(inner_coder.init_state(), jnp.asarray(np.packbits(bits)))
    return np.asarray(coded, np.uint8)


def _impair(coded, kind, rng):
    """{0,1} coded bits -> soft metrics 0..15 for one of three cases."""
    if kind == "hard":       # {0, 15} with a few flipped decisions
        soft = coded * np.uint8(15)
        pos = rng.choice(len(soft), len(soft) // 200, replace=False)
        soft[pos] = 15 - soft[pos]
        return soft
    noisy = 7.5 + 7.5 * (2.0 * coded - 1.0) + rng.normal(0, 5.0, len(coded))
    soft = np.clip(np.round(noisy), 0, 15).astype(np.uint8)
    if kind == "erasure":    # a third of the metrics at the 7/8 midpoint
        pos = rng.random(len(soft)) < 1 / 3
        soft[pos] = rng.integers(7, 9, int(pos.sum()))
    return soft


# (body, overlap): the receiver default, a short body with 2*ov > body/2,
# and one whose window count is not a multiple of the program width
GEOMETRIES = [(1024, 128), (256, 96), (512, 64)]


@pytest.mark.parametrize("kind", ["hard", "soft", "erasure"])
@pytest.mark.parametrize("body,overlap", GEOMETRIES)
@pytest.mark.parametrize("rate", ["1/2", "2/3", "3/4", "5/6", "7/8"])
def test_punctured_matches_jnp(rate, body, overlap, kind):
    period = len(tables.PUNCTURE[rate][0])
    n_bits = 8 * period * 300 + 8 * period * (body // 64)
    ov = vj.effective_overlap(rate, overlap)
    rng = np.random.default_rng(zlib.crc32(f"{rate}{body}{kind}".encode()))
    dec_j = vj.make_viterbi_decoder(n_bits, body=body, overlap=ov)
    dec_k = vt.make_viterbi_decoder_punctured(n_bits, rate, body=body,
                                              overlap=ov, interpret=True)
    depunct = inner_coder.make_depuncture(n_bits, rate)
    sj, sk = vj.init_state(ov), vj.init_state(ov)
    for blk in range(2):     # the second block starts from carried state
        bits = rng.integers(0, 2, n_bits, dtype=np.uint8)
        soft = jnp.asarray(_impair(_coded(bits, rate, n_bits), kind, rng))
        x, y, xm, ym = depunct(soft)
        xm = jnp.broadcast_to(xm, x.shape).astype(jnp.uint8)
        ym = jnp.broadcast_to(ym, y.shape).astype(jnp.uint8)
        sj, out_j = dec_j(sj, x, y, xm, ym)
        sk, out_k = dec_k(sk, soft)
        want = np.asarray(bitutils.bits_to_bytes(out_j))
        assert np.array_equal(np.asarray(out_k), want), (rate, blk)
        for k in sj:
            assert np.array_equal(np.asarray(sj[k]), np.asarray(sk[k])), \
                (rate, blk, k)


def test_punctured_noiseless_exact_odd_period():
    rate = "3/4"
    n_bits = 8 * 3 * 480
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, size=n_bits, dtype=np.uint8)
    coded = _coded(bits, rate, n_bits) * np.uint8(15)
    ov = vj.effective_overlap(rate)
    dec = vt.make_viterbi_decoder_punctured(n_bits, rate, overlap=ov,
                                            interpret=True)
    _, out = dec(vj.init_state(ov), jnp.asarray(coded))
    assert np.array_equal(np.asarray(out), np.packbits(bits))
