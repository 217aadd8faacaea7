"""Per-block unit tests for the TX/RX bit-pipeline ops (SURVEY.md §4:
golden vectors + inverse-property tests, following the reference's qa_*.py
per-block pattern but with real coverage)."""

import jax.numpy as jnp
import numpy as np
import pytest

from dvbt_tpu import tables
from dvbt_tpu.mode import DvbtMode, MODE_2K_QPSK, MODE_8K_UK
from dvbt_tpu.ops import (
    bit_interleaver,
    energy,
    inner_coder,
    mapper,
    outer_interleaver,
    reed_solomon,
    symbol_interleaver,
)


# --- energy dispersal ------------------------------------------------------

def test_energy_dispersal_roundtrip_and_phase():
    rng = np.random.default_rng(0)
    n = 24
    pk = rng.integers(0, 256, size=(n, 188), dtype=np.uint8)
    pk[:, 0] = 0x47
    fwd = energy.make_energy_dispersal(n)
    phase, scr = fwd(jnp.int32(0), jnp.asarray(pk))
    assert int(phase) == n % 8
    scr = np.asarray(scr)
    assert (scr[0::8, 0] == 0xB8).all() and (scr[1::8, 0] == 0x47).all()
    assert not np.array_equal(scr, pk)
    # involution restores
    _, rec = fwd(jnp.int32(0), jnp.asarray(scr))
    assert np.array_equal(np.asarray(rec), pk)
    # phase detection on a rotated block
    rot = np.roll(scr, -3, axis=0)
    assert int(energy.detect_dispersal_phase(jnp.asarray(rot))) == 3


def test_energy_dispersal_phase_continuity():
    rng = np.random.default_rng(1)
    pk = rng.integers(0, 256, size=(16, 188), dtype=np.uint8)
    pk[:, 0] = 0x47
    fwd = energy.make_energy_dispersal(16)
    half = energy.make_energy_dispersal(8)
    _, full = fwd(jnp.int32(0), jnp.asarray(pk))
    ph, a = half(jnp.int32(0), jnp.asarray(pk[:8]))
    _, b = half(ph, jnp.asarray(pk[8:]))
    assert np.array_equal(np.asarray(full), np.concatenate([a, b]))


# --- Reed-Solomon ----------------------------------------------------------

def test_rs_encoder_matches_host_reference():
    rng = np.random.default_rng(2)
    msg = rng.integers(0, 256, size=(6, 188), dtype=np.uint8)
    enc = reed_solomon.make_rs_encoder()
    out = np.asarray(enc(jnp.asarray(msg)))
    assert np.array_equal(out, tables.rs_encode_ref(msg))


@pytest.mark.parametrize("n_err", [0, 1, 2, 5, 8])
def test_rs_decoder_corrects(n_err):
    rng = np.random.default_rng(10 + n_err)
    msg = rng.integers(0, 256, size=(8, 188), dtype=np.uint8)
    cw = tables.rs_encode_ref(msg)
    for r in range(cw.shape[0]):
        pos = rng.choice(204, size=n_err, replace=False)
        cw[r, pos] ^= rng.integers(1, 256, size=n_err).astype(np.uint8)
    dec = reed_solomon.make_rs_decoder()
    out, n_corr, bad = dec(jnp.asarray(cw))
    assert np.array_equal(np.asarray(out), msg)
    assert (np.asarray(n_corr) == n_err).all()
    assert not np.asarray(bad).any()


def test_rs_decoder_flags_uncorrectable():
    rng = np.random.default_rng(99)
    msg = rng.integers(0, 256, size=(16, 188), dtype=np.uint8)
    cw = tables.rs_encode_ref(msg)
    for r in range(cw.shape[0]):
        pos = rng.choice(204, size=12, replace=False)
        cw[r, pos] ^= rng.integers(1, 256, size=12).astype(np.uint8)
    dec = reed_solomon.make_rs_decoder()
    out, _, bad = dec(jnp.asarray(cw))
    # 12 random byte errors: overwhelmingly detected as uncorrectable
    assert np.asarray(bad).mean() > 0.9


# --- outer interleaver -----------------------------------------------------

def test_outer_interleaver_roundtrip_is_2244_byte_delay():
    rng = np.random.default_rng(3)
    n = 4 * 204 * 12
    x = rng.integers(0, 256, size=n, dtype=np.uint8)
    ilv = outer_interleaver.make_outer_interleaver(n)
    dilv = outer_interleaver.make_outer_deinterleaver(n)
    t1, y = ilv(outer_interleaver.init_state(), jnp.asarray(x))
    t2, z = dilv(outer_interleaver.init_state(), y)
    z = np.asarray(z)
    assert np.array_equal(z[2244:], x[:-2244])
    # carried state: second block continues the delay line seamlessly
    x2 = rng.integers(0, 256, size=n, dtype=np.uint8)
    _, y2 = ilv(t1, jnp.asarray(x2))
    _, z2 = dilv(t2, y2)
    both = np.concatenate([z, np.asarray(z2)])
    ref = np.concatenate([np.zeros(2244, np.uint8), x, x2])[: 2 * n]
    assert np.array_equal(both[2244:], ref[2244:])


def test_outer_interleaver_branch0_identity():
    # bytes at positions ≡ 0 (mod 12) pass with zero delay (sync alignment)
    x = np.arange(408, dtype=np.uint8)
    ilv = outer_interleaver.make_outer_interleaver(408)
    _, y = ilv(outer_interleaver.init_state(), jnp.asarray(x))
    y = np.asarray(y)
    assert (y[0::12] == x[0::12]).all()


# --- inner coder -----------------------------------------------------------

def _conv_ref(bits, rate):
    """Bit-serial host reference encoder."""
    g1, g2 = 0o171, 0o133
    reg = 0
    xs, ys = [], []
    for b in bits:
        w = (int(b) << 6) | reg
        xs.append(bin(w & g1).count("1") & 1)
        ys.append(bin(w & g2).count("1") & 1)
        reg = (reg >> 1) | (int(b) << 5)
    inter = []
    for x, y in zip(xs, ys):
        inter += [x, y]
    px, py = tables.PUNCTURE[rate]
    period = len(px)
    out = []
    for i in range(0, len(inter), 2 * period):
        blk = inter[i : i + 2 * period]
        for k in tables.puncture_serial_order(rate):
            out.append(blk[k])
    return np.array(out, dtype=np.uint8)


@pytest.mark.parametrize("rate", ["1/2", "2/3", "3/4", "5/6", "7/8"])
def test_inner_coder_matches_reference(rate):
    rng = np.random.default_rng(4)
    period = len(tables.PUNCTURE[rate][0])
    n = period * 40
    bits = rng.integers(0, 2, size=n, dtype=np.uint8)
    enc = inner_coder.make_inner_coder(n // 8, rate)
    st, coded = enc(inner_coder.init_state(), jnp.asarray(np.packbits(bits)))
    assert np.array_equal(np.asarray(coded), _conv_ref(bits, rate))
    assert np.array_equal(np.asarray(st), bits[-6:])


@pytest.mark.parametrize("rate", ["1/2", "2/3", "3/4", "5/6", "7/8"])
def test_depuncture_inverts_puncture(rate):
    rng = np.random.default_rng(5)
    period = len(tables.PUNCTURE[rate][0])
    n = period * 24
    bits = rng.integers(0, 2, size=n, dtype=np.uint8)
    enc = inner_coder.make_inner_coder(n // 8, rate)
    _, coded = enc(inner_coder.init_state(), jnp.asarray(np.packbits(bits)))
    dep = inner_coder.make_depuncture(n, rate)
    x, y, xk, yk = dep(coded)
    # recompute the mother streams and compare at known positions
    xs = np.convolve(bits, [1, 1, 1, 1, 0, 0, 1])[:n] % 2     # G1 = 171o
    ys = np.convolve(bits, [1, 0, 1, 1, 0, 1, 1])[:n] % 2     # G2 = 133o
    assert np.array_equal(np.asarray(x)[np.asarray(xk) == 1],
                          np.asarray(xs)[np.asarray(xk) == 1])
    assert np.array_equal(np.asarray(y)[np.asarray(yk) == 1],
                          np.asarray(ys)[np.asarray(yk) == 1])
    # kept fraction matches the rate
    num, den = (int(v) for v in rate.split("/"))
    assert (np.asarray(xk).sum() + np.asarray(yk).sum()) == n * den // num


# --- bit interleaver -------------------------------------------------------

@pytest.mark.parametrize("mode", [MODE_2K_QPSK, MODE_8K_UK,
                                  DvbtMode("2k", "16qam", "3/4")])
def test_bit_interleaver_roundtrip(mode):
    rng = np.random.default_rng(6)
    bits = rng.integers(0, 2, size=(3, mode.n_payload * mode.v), dtype=np.uint8)
    ilv = bit_interleaver.make_bit_interleaver(mode)
    dilv = bit_interleaver.make_bit_deinterleaver(mode)
    cells = ilv(jnp.asarray(bits))
    assert cells.shape == (3, mode.n_payload)
    assert int(cells.max()) < (1 << mode.v)
    rec = dilv(cells)
    assert np.array_equal(np.asarray(rec), bits)


# --- symbol interleaver ----------------------------------------------------

@pytest.mark.parametrize("mode", [MODE_2K_QPSK, MODE_8K_UK])
def test_symbol_interleaver_roundtrip(mode):
    rng = np.random.default_rng(7)
    cells = rng.integers(0, 1 << mode.v, size=(4, mode.n_payload)).astype(np.int32)
    ilv = symbol_interleaver.make_symbol_interleaver(mode, n_sym=4)
    dilv = symbol_interleaver.make_symbol_interleaver(mode, n_sym=4,
                                                     deinterleave=True)
    out = ilv(jnp.asarray(cells))
    rec = dilv(out)
    assert np.array_equal(np.asarray(rec), cells)
    # even and odd symbols use different permutations
    assert not np.array_equal(np.asarray(out)[0], np.asarray(out)[1])


def test_symbol_interleaver_even_rule():
    # even symbol: out[H[q]] = in[q]
    mode = MODE_2K_QPSK
    h = mode.symbol_interleaver_perm()
    cells = np.arange(mode.n_payload, dtype=np.int32)[None, :]
    ilv = symbol_interleaver.make_symbol_interleaver(mode, n_sym=1)
    out = np.asarray(ilv(jnp.asarray(cells)))[0]
    assert (out[h] == np.arange(mode.n_payload)).all()


# --- mapper ----------------------------------------------------------------

@pytest.mark.parametrize("con,alpha", [("qpsk", 0), ("16qam", 0), ("64qam", 0),
                                       ("16qam", 2), ("64qam", 4)])
def test_map_demap_roundtrip(con, alpha):
    mode = DvbtMode("2k", con, "1/2", alpha=alpha)
    cells = jnp.arange(1 << mode.v, dtype=jnp.int32)
    qmap = mapper.make_mapper(mode)
    qdemap = mapper.make_demapper(mode)
    pts = qmap(cells)
    assert np.allclose(np.mean(np.abs(np.asarray(pts)) ** 2), 1.0, atol=1e-5)
    rec = qdemap(pts)
    assert np.array_equal(np.asarray(rec), np.asarray(cells))
    # robust to small noise (64QAM alpha=4 has min half-distance ~0.096)
    rng = np.random.default_rng(8)
    noisy = np.asarray(pts) + 0.02 * (rng.standard_normal(pts.shape)
                                      + 1j * rng.standard_normal(pts.shape))
    assert np.array_equal(np.asarray(qdemap(jnp.asarray(noisy))),
                          np.asarray(cells))


@pytest.mark.parametrize("con,alpha", [("qpsk", 0), ("16qam", 0), ("64qam", 0),
                                       ("16qam", 1), ("16qam", 2),
                                       ("16qam", 4), ("64qam", 2)])
def test_demap_matches_nearest_point(con, alpha):
    """The rounding demapper must agree with the brute-force nearest-point
    rule (the reference's hard-decision contract) on noisy samples away
    from exact decision-boundary midpoints."""
    mode = DvbtMode("2k", con, "1/2", alpha=alpha)
    c = np.asarray(mode.constellation_table(), np.complex64)
    rng = np.random.default_rng(11)
    y = (rng.uniform(-1.5, 1.5, 4096)
         + 1j * rng.uniform(-1.5, 1.5, 4096)).astype(np.complex64)
    want = np.argmin(np.abs(y[:, None] - c[None, :]), axis=-1)
    got = np.asarray(mapper.make_demapper(mode)(jnp.asarray(y)))
    assert np.array_equal(got, want)


def test_demap_midpoint_tiebreak_deterministic():
    """Exact decision-boundary midpoints resolve by jnp.round's half-to-even
    rule — toward the EVEN half-axis level index (ADVICE r3: pins the
    documented tie-break so replays are bit-identical across runs)."""
    mode = DvbtMode("2k", "64qam", "1/2")
    c = np.asarray(mode.constellation_table(), np.complex64)
    scale = 7.0 / np.max(c.real)          # levels ±1,3,5,7 de-normalized
    # midpoints between level ranks (0,1), (1,2), (2,3): |z|*scale = 2, 4, 6
    mids = np.array([2.0, 4.0, 6.0], np.float32) / scale
    y = (mids + 1j * mids[::-1]).astype(np.complex64)
    got1 = np.asarray(mapper.make_demapper(mode)(jnp.asarray(y)))
    got2 = np.asarray(mapper.make_demapper(mode)(jnp.asarray(y)))
    assert np.array_equal(got1, got2)
    # half-to-even on (|z|*scale - alpha)/2 = 0.5, 1.5, 2.5 -> ranks 0, 2, 2
    pts = np.asarray(mapper.make_mapper(mode)(jnp.asarray(got1)))
    lv = np.array([1.0, 5.0, 5.0], np.float32) / scale
    assert np.allclose(pts.real, lv, atol=1e-5)
    assert np.allclose(pts.imag, lv[::-1], atol=1e-5)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("t,con,alpha", [("2k", "64qam", 0), ("2k", "16qam", 2),
                                         ("8k", "64qam", 0)])
def test_bit_interleaver_matmul_matches_gather_oracle(t, con, alpha, dtype):
    """The block-diagonal matmul forms must equal the direct gather/scatter
    permutation (bit_interleaver._symbol_indices is the oracle) — for BOTH
    matmul operand dtypes (bf16, the default, and int8 via DVBT_ILV)."""
    mode = DvbtMode(t, con, "2/3", alpha=alpha)
    idx = bit_interleaver._symbol_indices(mode)          # (n_payload, v)
    rng = np.random.default_rng(13)
    bits = rng.integers(0, 2, (3, mode.n_payload * mode.v), np.uint8)
    w = (1 << np.arange(mode.v - 1, -1, -1)).astype(np.int64)
    want_cells = (bits[:, idx].astype(np.int64) * w).sum(axis=-1)
    got_cells = np.asarray(
        bit_interleaver.make_bit_interleaver(mode, dtype=dtype)(
            jnp.asarray(bits)))
    assert np.array_equal(got_cells, want_cells)

    dilv = bit_interleaver.make_bit_deinterleaver(mode, dtype=dtype)
    got_bits = np.asarray(dilv(jnp.asarray(want_cells.astype(np.int32))))
    assert np.array_equal(got_bits, bits)

    soft = rng.integers(0, 16, (3, mode.n_payload, mode.v), np.uint8)
    want_soft = np.zeros((3, mode.n_payload * mode.v), np.uint8)
    want_soft[:, idx.reshape(-1)] = soft.reshape(3, -1)
    got_soft = np.asarray(
        bit_interleaver.make_soft_bit_deinterleaver(mode, dtype=dtype)(
            jnp.asarray(soft)))
    assert np.array_equal(got_soft, want_soft)


def test_soft_demapper_csi_weighting():
    """csi=None == csi=1 (flat channels bit-identical); a small csi must
    pull metrics toward the 7/8 erasure midpoint (ADVICE-proofing the
    round-4 CSI-weighted soft path)."""
    mode = DvbtMode("2k", "16qam", "1/2")
    sd = mapper.make_soft_demapper(mode)
    rng = np.random.default_rng(5)
    y = (rng.standard_normal(256) + 1j * rng.standard_normal(256)
         ).astype(np.complex64) * 0.7
    base = np.asarray(sd(jnp.asarray(y)))
    ones = np.asarray(sd(jnp.asarray(y), jnp.ones(y.shape, jnp.float32)))
    assert np.array_equal(base, ones)
    damped = np.asarray(sd(jnp.asarray(y),
                           jnp.full(y.shape, 0.05, jnp.float32)))
    # damped metrics sit strictly closer to the erasure band
    assert np.abs(damped.astype(int) - 7.5).mean() < \
        np.abs(base.astype(int) - 7.5).mean()
    assert damped.min() >= 0 and damped.max() <= 15
