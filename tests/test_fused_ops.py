"""The fused hot-path permutations must equal the straightforward
reference formulations they replaced (make_frame_adapter /
make_payload_extractor / symbol interleaver kept as executable
documentation)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dvbt_tpu.mode import SYMBOLS_PER_FRAME, DvbtMode, MODE_2K_QPSK
from dvbt_tpu.ops import reference_signals as rs, symbol_interleaver as si


@pytest.mark.parametrize("mode", [MODE_2K_QPSK,
                                  DvbtMode("2k", "64qam", "2/3")])
def test_frame_builder_equals_symilv_plus_adapter(mode):
    rng = np.random.default_rng(0)
    pts = (rng.standard_normal((SYMBOLS_PER_FRAME, mode.n_payload))
           + 1j * rng.standard_normal((SYMBOLS_PER_FRAME, mode.n_payload))
           ).astype(np.complex64)
    fidx = jnp.int32(2)
    ref = rs.make_frame_adapter(mode)(
        fidx, si.make_symbol_interleaver(mode)(jnp.asarray(pts)))
    fused = rs.make_frame_builder(mode)(fidx, jnp.asarray(pts))
    assert np.allclose(np.asarray(ref), np.asarray(fused))


@pytest.mark.parametrize("mode", [MODE_2K_QPSK,
                                  DvbtMode("2k", "16qam", "3/4")])
def test_cell_deinterleaver_equals_extract_plus_deint(mode):
    rng = np.random.default_rng(1)
    Y = (rng.standard_normal((SYMBOLS_PER_FRAME, mode.n_carriers))
         + 1j * rng.standard_normal((SYMBOLS_PER_FRAME, mode.n_carriers))
         ).astype(np.complex64)
    ref = si.make_symbol_interleaver(mode, deinterleave=True)(
        rs.make_payload_extractor(mode)(jnp.asarray(Y)))
    fused = rs.make_cell_deinterleaver(mode)(jnp.asarray(Y))
    assert np.allclose(np.asarray(ref), np.asarray(fused))


def test_builder_then_deinterleaver_roundtrip():
    mode = MODE_2K_QPSK
    rng = np.random.default_rng(2)
    pts = (rng.standard_normal((SYMBOLS_PER_FRAME, mode.n_payload))
           + 1j * rng.standard_normal((SYMBOLS_PER_FRAME, mode.n_payload))
           ).astype(np.complex64)
    carr = rs.make_frame_builder(mode)(jnp.int32(0), jnp.asarray(pts))
    back = rs.make_cell_deinterleaver(mode)(carr)
    # deinterleave(interleave(x)) over the payload cells is the identity
    assert np.allclose(np.asarray(back), pts, atol=1e-6)


def test_matmul_fft_matches_jnp_fft():
    """The two-stage Cooley-Tukey matmul DFT must match XLA's FFT to f32
    round-off (both directions, both FFT sizes)."""
    import numpy as np
    from dvbt_tpu.ops import ofdm
    rng = np.random.default_rng(17)
    for n in (2048, 8192):
        x = (rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
             ).astype(np.complex64)
        for inv in (False, True):
            f = ofdm.make_matmul_fft(n, inverse=inv)
            got = np.asarray(jax.jit(f)(jnp.asarray(x)))
            want = (np.fft.ifft(x, norm="ortho") if inv
                    else np.fft.fft(x, norm="ortho"))
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err < 2e-5, (n, inv, err)
