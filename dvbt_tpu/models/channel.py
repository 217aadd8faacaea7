"""Channel impairment models for loopback / BER testing.

The reference has no channel model of its own (loopback was file-based, or
over the air); these are the impairments its RX chain is built to survive:
AWGN, carrier frequency offset, timing offset, static multipath.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.cplx import cis


def awgn(key: jax.Array, iq: jnp.ndarray, snr_db: float) -> jnp.ndarray:
    """Add complex AWGN at the given SNR relative to measured signal power."""
    p_sig = jnp.mean(jnp.abs(iq) ** 2)
    p_noise = p_sig / (10.0 ** (snr_db / 10.0))
    k1, k2 = jax.random.split(key)
    sigma = jnp.sqrt(p_noise / 2.0).astype(jnp.float32)
    # complex noise from two real normals (unit variance per component)
    n = jax.lax.complex(jax.random.normal(k1, iq.shape, jnp.float32),
                        jax.random.normal(k2, iq.shape, jnp.float32)) * sigma
    return (iq + n).astype(jnp.complex64)


def apply_cfo(iq: jnp.ndarray, cfo_subcarriers: float, fft_len: int,
              phase0: float = 0.0) -> jnp.ndarray:
    """Rotate by a carrier frequency offset given in subcarrier spacings."""
    n = jnp.arange(iq.shape[-1], dtype=jnp.float32)
    rot = cis(2.0 * jnp.pi * cfo_subcarriers * n / fft_len + phase0)
    return (iq * rot).astype(jnp.complex64)


def apply_delay(iq: jnp.ndarray, delay: int) -> jnp.ndarray:
    """Prepend `delay` zero samples (timing offset), keeping length."""
    if delay == 0:
        return iq
    pad = jnp.zeros(iq.shape[:-1] + (delay,), iq.dtype)
    return jnp.concatenate([pad, iq], axis=-1)[..., : iq.shape[-1]]


def resample_ppm(iq, ppm: float):
    """Sample-clock offset: resample by a factor (1 + ppm*1e-6).

    Host-side (numpy) linear interpolation — models a receiver ADC whose
    clock runs `ppm` parts-per-million FAST relative to the transmitter
    (ppm > 0 squeezes the waveform: each output sample advances less signal
    time, so symbol boundaries drift later in the sample stream).
    """
    import numpy as np
    x = np.asarray(iq, np.complex64)
    f = 1.0 + ppm * 1e-6
    n_out = int(np.floor((len(x) - 1) * f))
    pos = np.arange(n_out) / f          # signal time of each output sample
    t = np.arange(len(x))
    return (np.interp(pos, t, x.real) + 1j * np.interp(pos, t, x.imag)
            ).astype(np.complex64)


def multipath(iq: jnp.ndarray, taps: jnp.ndarray) -> jnp.ndarray:
    """Static FIR multipath (taps complex, tap 0 = line of sight)."""
    out = taps[0] * iq
    for d in range(1, taps.shape[0]):
        out = out + taps[d] * apply_delay(iq, d)
    return out.astype(jnp.complex64)


# --- EN 300 744 Annex B propagation profiles --------------------------------
# 20-echo ensemble (amplitude rho_i, phase theta_i rad, delay tau_i us) used
# for the spec's "fixed reception" (F1, Ricean K = 10 dB: the same echoes
# plus a direct ray) and "portable reception" (P1, Rayleigh: echoes only)
# performance figures [EN300744 Annex B; values as commonly reproduced —
# /root/reference and the spec text are unavailable in this environment, so
# cross-check the table when they are].  Delays are rounded to the 64/7 MHz
# sample grid (error <= 0.05 us << any guard interval).

_ANNEX_B_RHO = (
    0.057662, 0.176809, 0.407163, 0.303585, 0.258782,
    0.061831, 0.150340, 0.051534, 0.185074, 0.400967,
    0.295723, 0.350825, 0.262909, 0.225894, 0.170996,
    0.149723, 0.240140, 0.116587, 0.221155, 0.259730,
)
_ANNEX_B_THETA = (
    4.855121, 3.419109, 5.864470, 2.215894, 3.758058,
    5.430202, 3.952093, 1.093586, 5.775198, 0.154459,
    5.928383, 3.053023, 0.628578, 2.128544, 1.099463,
    3.462951, 3.664773, 2.833799, 3.334290, 0.393889,
)
_ANNEX_B_TAU_US = (
    1.003019, 5.422091, 0.518650, 2.751772, 0.602895,
    1.016585, 0.143556, 0.153832, 3.324866, 1.935570,
    0.429948, 3.228872, 0.848831, 0.073883, 0.203952,
    0.194207, 0.924450, 1.381320, 0.640512, 1.368671,
)


def annex_b_taps(profile: str, sample_rate_hz: float = 64e6 / 7):
    """Static FIR taps for the Annex B channel: "F1" (fixed / Ricean,
    K = 10 dB direct ray at delay 0) or "P1" (portable / Rayleigh, echoes
    only).  Returns a unit-power complex64 tap vector on the sample grid,
    consumable by :func:`multipath`."""
    import numpy as np
    assert profile in ("F1", "P1"), profile
    rho = np.asarray(_ANNEX_B_RHO)
    theta = np.asarray(_ANNEX_B_THETA)
    d = np.round(np.asarray(_ANNEX_B_TAU_US) * 1e-6 * sample_rate_hz
                 ).astype(np.int64)
    taps = np.zeros(int(d.max()) + 1, np.complex128)
    np.add.at(taps, d, rho * np.exp(-1j * theta))
    if profile == "F1":
        # Ricean factor K = 10 dB: direct-ray power = 10 * echo power
        taps[0] += np.sqrt(10.0 * np.sum(rho ** 2))
    taps /= np.sqrt(np.sum(np.abs(taps) ** 2))
    return jnp.asarray(taps.astype(np.complex64))
