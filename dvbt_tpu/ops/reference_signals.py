"""Frame adaptation, pilots & TPS (T8) and their RX-side duals (R3).

Reference behavior: `lib/reference_signals_impl.cc` — the shared TX/RX file
hosting `reference_signals` and `demod_reference_signals` (SURVEY.md T8/R3)
[unverified — mount empty]; spec: EN300744 §4.4 (frame adaptation), §4.5
(pilots), §4.6 (TPS).

Design: the reference's per-carrier pilot/TPS state machine
becomes static per-frame templates — a frame is 68 symbols, the scattered
pattern repeats with period 4 and the continual/TPS carrier sets are fixed,
so everything except the TPS payload is a precomputed (68, K) numpy constant.
The TPS differential modulation collapses to a (4, 68, n_tps) sign tensor
indexed by the carried frame counter.  Channel estimation interpolates the
scattered-pilot LS estimates with precomputed gather+weight tables (one
static gather instead of per-carrier control flow).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import tables
from ..mode import SYMBOLS_PER_FRAME, DvbtMode
from . import permute

PILOT_BOOST = 4.0 / 3.0  # scattered/continual pilot amplitude [EN300744 §4.5.2]


@functools.lru_cache(maxsize=None)
def _frame_tables(mode: DvbtMode):
    """Static numpy tables for one 68-symbol frame."""
    K = mode.n_carriers
    kmax = mode.kmax
    w = tables.wk_sequence(K).astype(np.int64)
    sign_w = (1 - 2 * w).astype(np.float32)
    cp = mode.continual_pilots()
    tp = mode.tps_carriers()
    cp_set, tp_set = set(cp.tolist()), set(tp.tolist())

    # everything below is periodic in l mod 4, so only 4 rows are stored
    # (tiled to 68 on device) — keeps embedded constants small
    pilot_rows = np.zeros((4, K), dtype=np.float32)
    data_idx = np.zeros((4, mode.n_payload), dtype=np.int32)
    sp_list = []
    for l in range(4):
        sp = tables.scattered_pilot_carriers(l, kmax)
        sp_list.append(sp)
        boosted = np.union1d(sp, cp)
        pilot_rows[l, boosted] = PILOT_BOOST * sign_w[boosted]
        is_data = np.ones(K, dtype=bool)
        is_data[boosted] = False
        is_data[tp] = False
        d = np.nonzero(is_data)[0]
        assert len(d) == mode.n_payload, (l, len(d))
        data_idx[l] = d

    # TPS cell signs for each of the 4 frame numbers: DBPSK chain from the
    # w_k-initialised state, same bit on every TPS carrier [EN300744 §4.6]
    tps_cells = np.zeros((4, SYMBOLS_PER_FRAME, len(tp)), dtype=np.float32)
    tps_bits_all = np.zeros((4, SYMBOLS_PER_FRAME), dtype=np.uint8)
    for f in range(4):
        s = mode.tps_bits(f)
        tps_bits_all[f] = s
        fac = np.ones(SYMBOLS_PER_FRAME, dtype=np.float32)
        for l in range(1, SYMBOLS_PER_FRAME):
            fac[l] = fac[l - 1] * (1.0 - 2.0 * float(s[l]))
        tps_cells[f] = fac[:, None] * sign_w[tp][None, :]

    # scattered-pilot interpolation tables: for every (l, k) a left pilot
    # slot + linear weight into the per-symbol pilot array (padded to the
    # max count so the frame is rectangular)
    n_sp_max = max(len(sp) for sp in sp_list)
    sp_idx = np.zeros((4, n_sp_max), dtype=np.int32)
    left_slot = np.zeros((4, K), dtype=np.int32)
    weight = np.zeros((4, K), dtype=np.float32)
    for l in range(4):
        sp = sp_list[l]
        n_sp = len(sp)
        sp_idx[l, :n_sp] = sp
        sp_idx[l, n_sp:] = sp[-1]
        pos = (np.arange(K) - sp[0]) / 12.0
        i0 = np.clip(np.floor(pos).astype(np.int64), 0, n_sp - 2)
        weight[l] = np.clip(pos - i0, 0.0, 1.0).astype(np.float32)
        left_slot[l] = i0.astype(np.int32)

    pilot_ref = PILOT_BOOST * sign_w[sp_idx]  # (4, n_sp_max)
    return dict(
        pilot_rows=pilot_rows, data_idx=data_idx, tp=tp,
        tps_cells=tps_cells, tps_bits=tps_bits_all,
        sp_idx=sp_idx, pilot_ref=pilot_ref,
        left_slot=left_slot, weight=weight,
    )


_TILE = SYMBOLS_PER_FRAME // 4


def _tile68(x4) -> jnp.ndarray:
    """Tile a (4, ...) per-phase table to (68, ...) symbol rows on device."""
    return jnp.tile(jnp.asarray(x4), (_TILE,) + (1,) * (x4.ndim - 1))


def make_frame_adapter(mode: DvbtMode):
    """TX frame adaptation.  Returns apply(frame_idx, data) where
    data: complex64 (..., 68, n_payload) -> carriers (..., 68, K).

    ``frame_idx`` (int32, mod 4) is the carried superframe position selecting
    the TPS payload (frame number + alternating sync word).
    """
    t = _frame_tables(mode)
    pilot_rows_np = t["pilot_rows"].astype(np.complex64)
    data_idx_np = t["data_idx"]
    tp = t["tp"].astype(np.int32)
    tps_cells_np = t["tps_cells"].astype(np.complex64)

    def apply(frame_idx: jnp.ndarray, data: jnp.ndarray) -> jnp.ndarray:
        pilot_rows = _tile68(pilot_rows_np)
        data_idx = _tile68(data_idx_np)
        tps_cells = jnp.asarray(tps_cells_np)
        rows = jnp.arange(SYMBOLS_PER_FRAME, dtype=jnp.int32)[:, None]
        out = jnp.broadcast_to(pilot_rows, data.shape[:-2] + pilot_rows.shape)
        out = out.at[..., rows, data_idx].set(data.astype(jnp.complex64))
        out = out.at[..., rows, tp[None, :]].set(tps_cells[frame_idx % 4])
        return out

    return jax.jit(apply)


def make_channel_estimator(mode: DvbtMode):
    """RX LS channel estimation + linear frequency interpolation.

    Returns estimate(Y): complex64 (..., 68, K) -> H (..., 68, K).
    Mirrors the reference's scattered-pilot divide + every-12th-carrier
    linear interpolation (SURVEY.md R3).  All three permutations run as
    phase-major row takes (ops.permute).
    """
    t = _frame_tables(mode)
    pilot_ref_np = t["pilot_ref"].astype(np.complex64)
    weight_np = t["weight"].astype(np.float32)
    take_sp = permute.make_row_take4(t["sp_idx"])
    take_hl = permute.make_row_take4(t["left_slot"])
    take_hr = permute.make_row_take4(t["left_slot"] + 1)

    def estimate(Y: jnp.ndarray) -> jnp.ndarray:
        weight = _tile68(weight_np)
        pilot_ref = _tile68(pilot_ref_np)
        Hp = take_sp(Y) / pilot_ref
        hl, hr = take_hl(Hp), take_hr(Hp)
        return hl * (1.0 - weight) + hr * weight

    return jax.jit(estimate)


def make_time_channel_estimator(mode: DvbtMode):
    """RX channel estimation at REFERENCE density (SURVEY.md R3,
    `lib/reference_signals_impl.cc` [unverified — mount empty]): scattered
    pilots are combined across the 4-symbol time pattern (zero-order hold —
    the most recent pilot per carrier), which yields an every-THIRD-carrier
    grid, then linear frequency interpolation fills the remaining carriers.
    Echo-delay tolerance is ~Tu/3 vs the frequency-only estimator's ~Tu/12
    (make_channel_estimator, the cheap path behind ``chan_est="freq"``).

    Returns estimate(tail, valid, Y) -> (tail', H):
      Y     : complex64 (..., S, K) frame-aligned carriers, S % 4 == 0, row
              phase = row index mod 4 (time-contiguous across frames).
      tail  : complex64 (..., 3, n_sp_max) — LS pilot estimates of the 3
              symbols BEFORE row 0 (phases 1, 2, 3; S ≡ 0 mod 4 keeps this
              shape invariant).  tail' is the same for the next block.
      valid : bool — False at stream start; the estimator then substitutes
              rows 1..3 of THIS block (nearest same-phase symbols), so cold
              starts degrade gracefully instead of dividing by zeros.

    All time operations are major-axis repeats/slices; the slot->carrier
    expansion is a minor-axis repeat (a static lane interleave, not a
    gather).  Slot s = l + 4m of the /3 grid holds the phase-l pilot at
    carrier 3s; phases 1..3 carry one padded slot that lands beyond kmax/3
    and is statically dropped.
    """
    t = _frame_tables(mode)
    pilot_ref_np = t["pilot_ref"].astype(np.complex64)   # (4, n_sp_max)
    take_sp = permute.make_row_take4(t["sp_idx"])
    n_sp = t["sp_idx"].shape[1]
    K = mode.n_carriers
    n3 = mode.kmax // 3 + 1
    # A_l[t] = latest phase-l pilot row <= symbol t: upsample the phase-l
    # rows of the tail-extended pilot history by 4 and slice at off[l]
    off = (0, 3, 2, 1)
    w_np = ((np.arange(K) % 3) / 3.0).astype(np.float32)

    def estimate(tail: jnp.ndarray, valid: jnp.ndarray, Y: jnp.ndarray):
        *b, S, _ = Y.shape
        assert S % 4 == 0, S
        pref = jnp.tile(jnp.asarray(pilot_ref_np), (S // 4, 1))
        Hp = take_sp(Y) / pref                            # (..., S, n_sp)
        tail_eff = jnp.where(valid, tail, Hp[..., 1:4, :])
        ext = jnp.concatenate([tail_eff, Hp], axis=-2)    # (..., S+3, n_sp)
        cols = []
        for l in range(4):
            i0 = (l + 3) % 4                              # ext row of the
            HpL = ext[..., i0::4, :]                      # phase-l symbols
            R = jnp.repeat(HpL, 4, axis=-2)
            cols.append(jax.lax.slice_in_dim(R, off[l], off[l] + S, axis=-2))
        G = jnp.stack(cols, axis=-1)                      # (..., S, n_sp, 4)
        C = G.reshape(*b, S, 4 * n_sp)[..., :n3]          # /3-grid, slot s
        Cp = jnp.concatenate([C, C[..., -1:]], axis=-1)
        R3 = jnp.repeat(Cp, 3, axis=-1)                   # R3[k] = C[k//3]
        w = jnp.asarray(w_np)
        H = R3[..., :K] * (1.0 - w) + R3[..., 3:K + 3] * w
        return Hp[..., S - 3:, :], H

    return jax.jit(estimate)


def init_time_channel_state(mode: DvbtMode):
    """(tail, valid) leaves for the carried RX state pytree."""
    n_sp = _frame_tables(mode)["sp_idx"].shape[1]
    return (jnp.zeros((3, n_sp), jnp.complex64), jnp.asarray(False))


def make_chan_tail_retimer(mode: DvbtMode):
    """f(tail, adj) -> tail' compensating an SCO timing step.

    Consuming ``adj`` extra samples before a block moves the FFT window
    later, so the channel's effective delay drops by adj and every
    subsequent H(k) picks up the linear phase e^{+j 2π f(k) adj / N}
    (f(k) = k - kmax/2, the signed subcarrier frequency; exact for integer
    adj).  Without this, the carried pilot history decorrelates from the
    new block's pilots at high carriers after every SCO nudge (a 1-sample
    step is ~a half-turn at the band edge).  adj == 0 multiplies by
    exactly 1+0j — a no-op, so the hot path needs no conditional.
    """
    from ..utils.cplx import cis
    t = _frame_tables(mode)
    f_np = (t["sp_idx"][1:4].astype(np.float32)
            - np.float32(mode.kmax // 2))            # (3, n_sp) signed freq
    two_pi_over_n = np.float32(2.0 * np.pi / mode.fft_len)

    def retime(tail: jnp.ndarray, adj: jnp.ndarray) -> jnp.ndarray:
        ang = two_pi_over_n * adj.astype(jnp.float32)
        return (tail * cis(ang * jnp.asarray(f_np))).astype(jnp.complex64)

    return jax.jit(retime)


def make_cell_deinterleaver(mode: DvbtMode):
    """RX: payload extraction fused with the symbol deinterleaver (R3 + R5).

    Returns f(cells): (..., 68, K) demapped cell values (pilot/TPS columns
    are don't-cares) -> (..., 68, n_payload) in symbol-deinterleaved order.
    Composing the two static maps removes one full-size permutation and the
    downstream chain never sees pilot columns.
    """
    from . import symbol_interleaver as si
    t = _frame_tables(mode)
    pair = si._perm_pair(mode, deinterleave=True)       # (2, P)
    idx = np.stack([t["data_idx"][p][pair[p % 2]] for p in range(4)])
    return jax.jit(permute.make_row_take4(idx))


def make_frame_builder(mode: DvbtMode):
    """TX: symbol interleaver + QAM map placement + frame adaptation fused
    (T6 + T8).  Returns build(frame_idx, points) with points complex64
    (..., 68, n_payload) in PRE-symbol-interleave order -> (..., 68, K).

    The non-data carriers (pilots AND the frame-dependent TPS cells) come
    from ONE precomputed (4, 68, K) template selected by frame_idx, so the
    whole frame adaptation is a single jnp.where instead of a minor-axis
    ``.at[..., tps].set`` scatter.
    """
    from . import symbol_interleaver as si
    t = _frame_tables(mode)
    pair = si._perm_pair(mode, deinterleave=False)      # (2, P) tx gathers
    K = mode.n_carriers
    # carrier k of symbol-phase p reads points[:, TX_IDX[p, k]] when a data
    # cell, else the pilot template.  inv_data[p, data_idx[p, j]] = j.
    tx_idx = np.zeros((4, K), np.int32)
    is_data = np.zeros((4, K), bool)
    for p in range(4):
        inv = np.zeros(K, np.int64)
        inv[t["data_idx"][p]] = np.arange(mode.n_payload)
        is_data[p, t["data_idx"][p]] = True
        tx_idx[p] = pair[p % 2][inv]                     # valid where is_data
    take_tx = permute.make_row_take4(tx_idx)
    mask_np = is_data
    tp = t["tp"]
    # (4 frame numbers, 68 symbols, K): pilots (row phase = symbol mod 4)
    # with the frame's DBPSK TPS cells already in their columns
    ref_np = np.tile(t["pilot_rows"].astype(np.complex64)[None],
                     (4, _TILE, 1))                      # (4, 68, K)
    ref_np[:, :, tp] = t["tps_cells"].astype(np.complex64)

    def build(frame_idx: jnp.ndarray, points: jnp.ndarray) -> jnp.ndarray:
        placed = take_tx(points)                         # (..., 68, K)
        mask = _tile68(mask_np)
        ref = jnp.asarray(ref_np)[frame_idx % 4]         # (..., 68, K)
        return jnp.where(mask, placed, ref)

    return jax.jit(build)


def make_payload_extractor(mode: DvbtMode):
    """RX: gather the 1512/6048 payload cells out of the equalized carriers.

    Returns extract(X): (..., 68, K) -> (..., 68, n_payload).
    """
    t = _frame_tables(mode)
    data_idx_np = t["data_idx"]

    def extract(X: jnp.ndarray) -> jnp.ndarray:
        data_idx = _tile68(data_idx_np)
        idx = jnp.broadcast_to(data_idx, X.shape[:-2] + data_idx.shape)
        return jnp.take_along_axis(X, idx, axis=-1)

    return jax.jit(extract)


def make_tps_decoder(mode: DvbtMode):
    """RX: DBPSK-demodulate the TPS bits of one frame-aligned symbol block.

    Returns decode(Y) -> (bits (..., 68) uint8, frame_num (...,) int32).
    bit l (l>=1) is the majority vote over TPS carriers of the differential
    phase between symbols l-1 and l; s0 is reported as 0 (it is the
    modulation init, not data).  frame_num is read from s23/s24.
    """
    t = _frame_tables(mode)
    tp = t["tp"].astype(np.int32)

    def decode(Y: jnp.ndarray):
        cells = Y[..., tp]  # (..., 68, n_tps)
        diff = cells[..., 1:, :] * jnp.conj(cells[..., :-1, :])
        votes = jnp.sum(jnp.real(diff), axis=-1)  # (..., 67)
        bits = (votes < 0).astype(jnp.uint8)
        zeros = jnp.zeros_like(bits[..., :1])
        s = jnp.concatenate([zeros, bits], axis=-1)
        frame_num = (s[..., 23].astype(jnp.int32) << 1) | s[..., 24]
        return s, frame_num

    return jax.jit(decode)


def expected_tps_bits(mode: DvbtMode, frame_idx: int) -> np.ndarray:
    """Host-side TPS reference for tests/sync (s0 zeroed like the decoder)."""
    s = mode.tps_bits(frame_idx).copy()
    s[0] = 0
    return s
