"""Full receiver synchronization front-end: R1 + the sync half of R3.

Reference behavior: `lib/ofdm_sym_acquisition_impl.cc` (symbol timing +
fractional CFO) and the integer-CFO / frame-sync half of
`lib/reference_signals_impl.cc`'s `demod_reference_signals` (SURVEY.md R1/R3)
[unverified — mount empty]; spec: EN300744 §4.4–4.6.

Design (SURVEY.md §7 hard part 2): the reference's per-sample
streaming correlator + lock FSM becomes ONE batched pass over a capture
block —

1. CP correlation timing + fractional CFO       (ops.ofdm.make_symbol_acquisition)
2. NCO derotation of the whole block            (vectorized complex multiply)
3. FFT of every candidate symbol at once        (XLA-native batched FFT)
4. integer CFO by continual-pilot power search  (static gather over shifts)
5. scattered-pilot phase (l mod 4) detection    (energy fold over 4 phases)
6. TPS sync-word correlation (symbol mod 68)    (gather + reduce, polarity-
   agnostic |sum| so the alternate-frame inverted sync word also votes)
7. TPS frame-number readout + block alignment   (frames_per_block > 1 modes
   must start on a packet-aligned frame)

Everything is static-shape; the only data-dependent values are scalars
(theta, shift, frame start) consumed by `jax.lax.dynamic_slice`.  The
host-side lock/re-acquire FSM lives in models/loopback.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..mode import SYMBOLS_PER_FRAME, DvbtMode
from ..utils.cplx import cis
from . import ofdm, reference_signals

DEFAULT_MAX_INT_CFO = 8
DEFAULT_BACKOFF = 8  # samples of CP margin before the detected boundary


def min_capture_samples(mode: DvbtMode, n_frames_out: int) -> int:
    """Smallest capture length make_synchronizer accepts: the decode block
    plus worst-case timing (one symbol) + frame (68 symbols) + block
    (frames_per_block-1 frames) misalignment, plus one TPS-sync tail frame."""
    L = mode.symbol_len
    f = mode.frames_per_block
    n_out_sym = n_frames_out * SYMBOLS_PER_FRAME
    slack_sym = SYMBOLS_PER_FRAME * f + SYMBOLS_PER_FRAME
    return (n_out_sym + slack_sym) * L + L


def make_synchronizer(mode: DvbtMode, n_samples_in: int, n_frames_out: int,
                      max_int_cfo: int = DEFAULT_MAX_INT_CFO,
                      backoff: int = DEFAULT_BACKOFF):
    """Returns sync(iq) -> (aligned, info).

    iq      : complex64 (n_samples_in,) raw baseband with unknown delay,
              CFO (|int| <= max_int_cfo subcarriers + fractional), noise.
    aligned : complex64 (n_frames_out * 68 * symbol_len,) CFO-corrected
              baseband starting exactly at a packet-aligned frame start —
              directly consumable by models.rx.make_receiver.
    info    : dict of scalar estimates (theta, cfo_frac, cfo_int, frame_sym,
              frame_num, start, and detection quality scores).
    """
    N, G, L = mode.fft_len, mode.guard_len, mode.symbol_len
    f = mode.frames_per_block
    n_out_sym = n_frames_out * SYMBOLS_PER_FRAME
    n_out = n_out_sym * L
    assert n_samples_in >= min_capture_samples(mode, n_frames_out), (
        n_samples_in, min_capture_samples(mode, n_frames_out))
    n_sym_avail = (n_samples_in - L) // L

    acquire = ofdm.make_symbol_acquisition(mode, n_samples_in)
    bins = ofdm._bin_map(mode)  # (K,)
    t = reference_signals._frame_tables(mode)
    sp_idx_np = t["sp_idx"]                       # (4, n_sp_max)
    cp_bins_np = bins[mode.continual_pilots()]    # (n_cp,)
    tp_np = t["tp"].astype(np.int32)              # (n_tps,)

    from .. import tables
    sync_sign_np = (1.0 - 2.0 * np.array(tables.TPS_SYNC,
                                         np.float32))  # (16,)

    # TPS sync-word vote positions: for candidate frame start c in [0, 68),
    # frame replica r, word bit i -> diff-bit index c + 68 r + (i + 1)
    n_votes = (n_sym_avail - 1 - 16 - (SYMBOLS_PER_FRAME - 1)) \
        // SYMBOLS_PER_FRAME + 1
    assert n_votes >= 1

    def sync(iq: jnp.ndarray):
        theta, cfo_frac = acquire(iq)
        theta_b = (theta - backoff) % L

        # fractional-CFO derotation of the whole capture (integer CFO does
        # not break subcarrier orthogonality, so it is corrected post-FFT)
        n = jnp.arange(n_samples_in, dtype=jnp.float32)
        rot = cis(-2.0 * jnp.pi * cfo_frac * n / N)
        r = iq * rot

        syms = jax.lax.dynamic_slice(r, (theta_b,), (n_sym_avail * L,))
        spec = jnp.fft.fft(
            syms.reshape(n_sym_avail, L)[:, G:], axis=-1, norm="ortho")

        # --- integer CFO: continual-pilot power over candidate shifts -----
        P = jnp.sum(jnp.abs(spec) ** 2, axis=0)  # (N,)
        shifts = np.arange(-max_int_cfo, max_int_cfo + 1)
        cp_shift_idx = (cp_bins_np[None, :] + shifts[:, None]) % N
        cp_score = P[jnp.asarray(cp_shift_idx)].sum(axis=-1)
        cfo_int = jnp.argmax(cp_score).astype(jnp.int32) - max_int_cfo

        carriers = spec[:, (jnp.asarray(bins) + cfo_int) % N]  # (S, K)

        # --- scattered-pilot phase (l mod 4) ------------------------------
        E = jnp.sum(jnp.abs(carriers[:, jnp.asarray(sp_idx_np)]) ** 2,
                    axis=-1)                                   # (S, 4)
        s_i = jnp.arange(n_sym_avail, dtype=jnp.int32)
        m_scat = jnp.stack(
            [E[s_i, (s_i + o) % 4].sum() for o in range(4)])   # (4,)
        o_hat = jnp.argmax(m_scat).astype(jnp.int32)

        # --- TPS: DBPSK diff votes + sync-word correlation ----------------
        cells = carriers[:, jnp.asarray(tp_np)]                # (S, n_tps)
        votes = jnp.sum(jnp.real(cells[1:] * jnp.conj(cells[:-1])), axis=-1)
        bsign = jnp.concatenate(
            [jnp.zeros((1,), votes.dtype), jnp.sign(votes)])   # (S,) +-1
        c = jnp.arange(SYMBOLS_PER_FRAME, dtype=jnp.int32)
        rrep = jnp.arange(n_votes, dtype=jnp.int32)
        i = jnp.arange(16, dtype=jnp.int32)
        pos = (c[:, None, None] + SYMBOLS_PER_FRAME * rrep[None, :, None]
               + i[None, None, :] + 1)                         # (68, R, 16)
        corr = jnp.sum(bsign[pos] * jnp.asarray(sync_sign_np), axis=-1)
        m_tps = jnp.sum(jnp.abs(corr), axis=-1)                # (68,)
        # frame start must be consistent with the scattered phase
        valid = (c + o_hat) % 4 == 0
        c_hat = jnp.argmax(jnp.where(valid, m_tps, -jnp.inf)).astype(jnp.int32)

        # --- frame number + block (packet) alignment ----------------------
        bbit = (bsign < 0).astype(jnp.int32)
        frame_num = (bbit[c_hat + 23] << 1) | bbit[c_hat + 24]
        adv = (-frame_num) % f
        c_full = c_hat + adv * SYMBOLS_PER_FRAME

        # --- aligned, fully CFO-corrected output block ---------------------
        start = theta_b + c_full * L
        aligned = jax.lax.dynamic_slice(r, (start,), (n_out,))
        m = jnp.arange(n_out, dtype=jnp.float32)
        irot = cis(-2.0 * jnp.pi * cfo_int.astype(jnp.float32) * m / N)
        aligned = (aligned * irot).astype(jnp.complex64)

        info = {
            "theta": theta, "cfo_frac": cfo_frac, "cfo_int": cfo_int,
            "frame_sym": c_hat, "frame_num": frame_num, "start": start,
            "start_frame": (frame_num + adv) % 4,
            "scat_score": m_scat, "tps_score": m_tps[c_hat],
        }
        return aligned, info

    return jax.jit(sync)


def make_tracker(mode: DvbtMode, n_frames_out: int,
                 backoff: int = DEFAULT_BACKOFF):
    """Steady-state (locked) front-end: consume exactly one decode block at a
    known offset/CFO — no search, just derotation (cheap enough to fuse with
    the receiver).  Returns track(iq, cfo_frac, cfo_int, phase) ->
    (aligned, phase').

    ``phase`` carries the NCO angle across blocks so the derotation is
    continuous sample-to-sample (the equalizer would absorb a jump, but a
    continuous NCO matches the reference's streaming derotator).
    """
    N = mode.fft_len
    n_out = n_frames_out * SYMBOLS_PER_FRAME * mode.symbol_len

    def track(iq: jnp.ndarray, cfo_frac: jnp.ndarray, cfo_int: jnp.ndarray,
              phase: jnp.ndarray):
        cfo = cfo_frac + cfo_int.astype(jnp.float32)
        n = jnp.arange(n_out, dtype=jnp.float32)
        rot = cis(-2.0 * jnp.pi * cfo * n / N + phase)
        phase1 = jnp.mod(phase - 2.0 * jnp.pi * cfo * n_out / N,
                         2.0 * jnp.pi).astype(jnp.float32)
        return (iq * rot).astype(jnp.complex64), phase1

    return jax.jit(track)
