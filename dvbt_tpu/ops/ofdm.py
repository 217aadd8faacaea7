"""OFDM modulation/demodulation (T9 / R2) and symbol acquisition (R1).

Reference behavior: T9/R2 are *external* blocks in the reference flowgraphs
(`gr::fft::fft_vcc` + `gr::digital::ofdm_cyclic_prefixer`, FFTW-backed —
SURVEY.md §2.1 T9); R1 is `lib/ofdm_sym_acquisition_impl.cc` [unverified —
mount empty]; spec: EN300744 §4.4 + Table 5.

Design: `jnp.fft` with norm="ortho" (XLA-native FFT on the whole
68-symbol frame at once); carrier<->bin layout is a single static gather.
Acquisition (R1) replaces the reference's per-sample streaming correlator +
lock FSM with a batched moving-sum CP correlation over a whole super-block,
folded across symbol periods for a robust one-shot timing estimate
(SURVEY.md §7 hard part 2), plus fractional-CFO from the correlation phase.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..mode import DvbtMode


@functools.lru_cache(maxsize=None)
def _bin_map(mode: DvbtMode) -> np.ndarray:
    """Carrier k (0..Kmax) -> FFT bin ((k - Kmax/2) mod N): active spectrum
    centered on DC. [EN300744 §4.4: carrier Kmax/2 sits on the centre freq]"""
    k = np.arange(mode.n_carriers)
    return ((k - mode.kmax // 2) % mode.fft_len).astype(np.int32)


import os as _os

# FFT backend for the OFDM hot path: "jnp" (XLA's native FFT, cuFFT on a
# GPU) or "matmul" (two-stage Cooley-Tukey as matmuls, below).  Resolved
# once at import; A/B-measured on the card before changing the default.
FFT_IMPL = _os.environ.get("DVBT_FFT", "jnp")
# precision of the matmul FFT: "highest" (full f32) or "high" (bf16x3,
# relative error ~2^-21 — still orders of magnitude below any
# hard-decision margin).
FFT_PRECISION = _os.environ.get("DVBT_FFT_PRECISION", "highest")


def make_matmul_fft(n: int, inverse: bool = False):
    """DFT of length n = n1*n2 as two batched matmuls (norm="ortho").

    Decimation-in-time Cooley-Tukey with x[n1*N2 + n2] = A[n1, n2]:
    stage 1 contracts an (n1, n1) DFT matrix over the major axis, the
    twiddle e^{±2πi k1 n2 / n} fuses elementwise, stage 2 contracts an
    (n2, n2) DFT matrix over the minor axis, and the k2-major output
    reorder is a transpose.  ~9x the FLOPs of an FFT, run as dense matrix
    products at full f32 precision (precision="highest"); it was chosen
    on the chain's first platform, whose FFT underperformed.
    On a GPU it is an option to A/B against cuFFT, not the default.
    """
    assert n % 2 == 0
    n1 = 128 if n % (128 * 128) == 0 else 64
    n2 = n // n1
    sign = 2.0j * np.pi if inverse else -2.0j * np.pi
    k1 = np.arange(n1)
    k2 = np.arange(n2)
    F1 = np.exp(sign * np.outer(k1, k1) / n1).astype(np.complex64)
    F2 = np.exp(sign * np.outer(k2, k2) / n2).astype(np.complex64)
    tw = (np.exp(sign * np.outer(k1, k2) / n)
          / np.sqrt(n)).astype(np.complex64)     # fold in the ortho scale

    prec = (jax.lax.Precision.HIGHEST if FFT_PRECISION == "highest"
            else jax.lax.Precision.HIGH)

    def fft(x: jnp.ndarray) -> jnp.ndarray:
        *b, n_ = x.shape
        A = x.reshape(*b, n1, n2)
        Y = jnp.einsum("...nm,nk->...km", A, jnp.asarray(F1),
                       precision=prec)
        Y = Y * jnp.asarray(tw)
        O = jnp.einsum("...km,mj->...kj", Y, jnp.asarray(F2),
                       precision=prec)
        return jnp.moveaxis(O, -2, -1).reshape(*b, n).astype(jnp.complex64)

    return fft


def make_ofdm_modulator(mode: DvbtMode, fft_impl: str | None = None):
    """Returns modulate(carriers): complex64 (..., n_sym, K)
    -> (..., n_sym*(N+guard)) time-domain baseband at 64/7 Msps."""
    bins = _bin_map(mode)
    N, G = mode.fft_len, mode.guard_len
    impl = FFT_IMPL if fft_impl is None else fft_impl
    ifft = (make_matmul_fft(N, inverse=True) if impl == "matmul"
            else lambda s: jnp.fft.ifft(s, axis=-1, norm="ortho"))

    def modulate(carriers: jnp.ndarray) -> jnp.ndarray:
        spec = jnp.zeros(carriers.shape[:-1] + (N,), jnp.complex64)
        spec = spec.at[..., bins].set(carriers.astype(jnp.complex64))
        x = ifft(spec).astype(jnp.complex64)
        with_cp = jnp.concatenate([x[..., N - G:], x], axis=-1)
        return with_cp.reshape(*carriers.shape[:-2], -1)

    return jax.jit(modulate)


def make_ofdm_demodulator(mode: DvbtMode, n_sym: int,
                          fft_impl: str | None = None):
    """Returns demodulate(iq): complex64 (..., n_sym*(N+guard))
    -> carriers (..., n_sym, K).  Assumes symbol-aligned input (R1 output)."""
    bins = _bin_map(mode)
    N, G = mode.fft_len, mode.guard_len
    impl = FFT_IMPL if fft_impl is None else fft_impl
    fft = (make_matmul_fft(N) if impl == "matmul"
           else lambda s: jnp.fft.fft(s, axis=-1, norm="ortho"))

    def demodulate(iq: jnp.ndarray) -> jnp.ndarray:
        syms = iq.reshape(*iq.shape[:-1], n_sym, N + G)[..., G:]
        spec = fft(syms)
        return spec[..., bins]

    return jax.jit(demodulate)


# --- R1: symbol acquisition ------------------------------------------------


def make_symbol_acquisition(mode: DvbtMode, n_samples: int):
    """One-shot timing + fractional CFO estimator over a sample block.

    Returns acquire(iq) -> (theta, cfo_frac):
      theta    : int32 — offset of the first complete symbol start in
                 [0, N+guard)
      cfo_frac : float32 — fractional carrier offset in subcarrier units

    Method (van-de-Beek-style, as the reference's R1): moving-sum CP
    correlation gamma(n) = sum_{k<G} r[n+k] conj(r[n+k+N]) minus an energy
    term, folded over all whole symbol periods in the block and argmaxed.
    The host-side lock/reacquire FSM lives in models/rx.py streaming mode.
    """
    N, G = mode.fft_len, mode.guard_len
    L = N + G
    n_folds = (n_samples - N - G) // L
    assert n_folds >= 1, "need at least one full symbol for acquisition"
    rho = 0.1  # SNR-dependent energy weight; modest value is robust

    def acquire(iq: jnp.ndarray):
        r = iq
        prod = r[..., : n_samples - N] * jnp.conj(r[..., N:])
        eng = (jnp.abs(r[..., : n_samples - N]) ** 2
               + jnp.abs(r[..., N:]) ** 2) * 0.5
        # moving sums over the guard window via cumsum difference
        cs = jnp.cumsum(prod, axis=-1)
        ce = jnp.cumsum(eng, axis=-1)
        zeros = jnp.zeros_like(cs[..., :1])
        cs = jnp.concatenate([zeros, cs], axis=-1)
        ce = jnp.concatenate([jnp.zeros_like(ce[..., :1]), ce], axis=-1)
        gamma = cs[..., G:] - cs[..., :-G]           # (..., n_samples-N-G+1)
        phi = jnp.real(ce[..., G:] - ce[..., :-G])
        metric = jnp.abs(gamma) - rho * phi
        # fold across symbol periods
        usable = n_folds * L
        m = metric[..., :usable].reshape(*metric.shape[:-1], n_folds, L)
        g = gamma[..., :usable].reshape(*metric.shape[:-1], n_folds, L)
        score = m.sum(axis=-2)
        theta = jnp.argmax(score, axis=-1).astype(jnp.int32)
        g_sum = jnp.take_along_axis(
            g.sum(axis=-2), theta[..., None], axis=-1)[..., 0]
        cfo = (-jnp.angle(g_sum) / (2.0 * jnp.pi)).astype(jnp.float32)
        return theta, cfo

    return jax.jit(acquire)
