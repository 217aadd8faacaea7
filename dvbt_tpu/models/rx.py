"""The complete DVB-T receive chain as ONE pure jitted function.

Reference: the RX flowgraph of SURVEY.md §3.2 (ofdm_sym_acquisition → FFT →
demod_reference_signals → dvbt_demap → symbol/bit deinterleavers →
viterbi_decoder → convolutional_deinterleaver → reed_solomon_dec →
energy_descramble).  This module provides the symbol-aligned receiver
(acquisition/CFO handled by ops.sync + the streaming front-end in
models/loopback.py); every data-dependent streaming behavior of the
reference (sync-byte search, lock state) is re-expressed as batched
detection + carried state under jit.

Hierarchical modes decode BOTH streams: the bit deinterleaver output splits
into v-bit slots of which b0,b1 belong to HP and b2..b5 to LP
[EN300744 §4.3.4.1]; each stream then runs its own depuncture → Viterbi →
outer deinterleave → RS → descramble chain at its own code rate.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..mode import RS_PACKET, SYMBOLS_PER_FRAME, DvbtMode
from ..ops import (
    bit_interleaver,
    energy,
    inner_coder,
    mapper,
    ofdm,
    outer_interleaver,
    reed_solomon,
    reference_signals,
    viterbi,
)
from ..utils import bits as bitutils


def _init_stream_state(rate: str, overlap: int) -> dict:
    return {
        "deint_tail": outer_interleaver.init_state(),
        "viterbi": viterbi.init_state(viterbi.effective_overlap(rate,
                                                                overlap)),
        "descr_phase": jnp.int32(0),
        "descr_locked": jnp.asarray(False),
    }


def init_rx_state(mode: DvbtMode,
                  overlap: int = viterbi.DEFAULT_OVERLAP) -> dict:
    """Carried RX state pytree (SURVEY.md §5.4): deinterleaver tail, Viterbi
    boundary window, descrambler phase lock (per stream), channel-estimator
    pilot history (3 symbols, reference-density time interpolation).  The
    Viterbi tail length is `effective_overlap(rate, overlap)` — byte- and
    puncture-phase aligned so the SAME pytree drives the jnp scan and the
    Pallas kernel (checkpoints are implementation-independent)."""
    state = _init_stream_state(mode.code_rate, overlap)
    tail, valid = reference_signals.init_time_channel_state(mode)
    state["chan_tail"] = tail
    state["chan_valid"] = valid
    if mode.hierarchical:
        state["lp"] = _init_stream_state(mode.code_rate_lp, overlap)
    return state


VITERBI_IMPLS = ("jnp", "pallas", "pallas-interpret")


def _resolve_viterbi_impl(impl: str, platform: str | None = None) -> str:
    """'auto' -> the Pallas (Triton) kernel on a GPU, the jnp scan on any
    other platform (default: the platform of jax's default backend)."""
    if impl == "auto":
        if platform is None:
            platform = jax.default_backend()
        impl = "pallas" if platform == "gpu" else "jnp"
    assert impl in VITERBI_IMPLS, impl
    return impl


def _make_stream_decoder(mode: DvbtMode, stream: str, n_blocks: int,
                         viterbi_body, viterbi_overlap, viterbi_impl,
                         measure_pre_rs: bool = False):
    """Per-stream byte pipeline: coded bits -> TS packets (R7..R10)."""
    n_packets = mode.stream_packets_per_block(stream) * n_blocks
    n_bytes = n_packets * RS_PACKET
    n_info_bits = n_bytes * 8
    rate = mode.code_rate if stream == "hp" else mode.code_rate_lp
    overlap = viterbi.effective_overlap(rate, viterbi_overlap)

    impl = _resolve_viterbi_impl(viterbi_impl)
    if impl.startswith("pallas"):
        # ACS + traceback in one kernel launch, decoded bytes out
        # ("pallas-interpret" runs it in the Pallas interpreter: the CPU
        # path for full-receiver parity, tests/test_fused_chain.py)
        from ..kernels import viterbi_triton
        decode_bytes = viterbi_triton.make_viterbi_decoder_punctured(
            n_info_bits, rate, viterbi_body, overlap,
            interpret=impl.endswith("-interpret"))
    else:
        depunct = inner_coder.make_depuncture(n_info_bits, rate)
        vit = viterbi.make_viterbi_decoder(n_info_bits, viterbi_body,
                                           overlap)

        def decode_bytes(vstate, coded_bits):
            x, y, xm, ym = depunct(coded_bits)
            xm = jnp.broadcast_to(xm, x.shape).astype(jnp.uint8)
            ym = jnp.broadcast_to(ym, y.shape).astype(jnp.uint8)
            vstate, info_bits = vit(vstate, x, y, xm, ym)
            return vstate, bitutils.bits_to_bytes(info_bits)

    out_dilv = outer_interleaver.make_outer_deinterleaver(n_bytes)
    rs_dec = reed_solomon.make_rs_decoder()
    # RS decode in <=256-codeword chunks via lax.map: the chunking was
    # tuned on the chain's first platform, where one full-batch decode
    # anti-scaled; not re-tuned on the GPU yet.
    import os as _os
    rs_target = int(_os.environ.get("DVBT_RS_CHUNK", "256"))
    n_rs_chunks = 1
    for n in range(1, n_packets + 1):
        if n_packets % n == 0 and n_packets // n <= rs_target:
            n_rs_chunks = n
            break

    def rs_decode(packets204):
        if n_rs_chunks == 1:
            return rs_dec(packets204)
        ck = packets204.reshape(n_rs_chunks, n_packets // n_rs_chunks,
                                RS_PACKET)
        msg, corr, bad = jax.lax.map(rs_dec, ck)
        return (msg.reshape(n_packets, -1),
                corr.reshape(n_packets), bad.reshape(n_packets))

    descramble = energy.make_energy_dispersal(n_packets)
    if measure_pre_rs:
        rs_reenc = reed_solomon.make_rs_encoder()

    def run(state: dict, coded_bits: jnp.ndarray):
        with jax.named_scope("viterbi_decode"):
            vstate, stream_bytes = decode_bytes(state["viterbi"], coded_bits)
        with jax.named_scope("outer_deinterleave"):
            tail, deinterleaved = out_dilv(state["deint_tail"], stream_bytes)
        packets204 = deinterleaved.reshape(n_packets, RS_PACKET)
        with jax.named_scope("rs_decode"):
            msg, rs_corr, rs_bad = rs_decode(packets204)
        detected = energy.detect_dispersal_phase(msg)
        phase = jnp.where(state["descr_locked"], state["descr_phase"],
                          detected)
        new_phase, ts = descramble(phase, msg)
        # only latch the group phase once the detection is credible (mostly
        # correctable packets) — a garbage block after (re)acquisition must
        # not freeze a phase guessed from noise (SURVEY.md §5.3 resync)
        credible = jnp.mean(rs_bad.astype(jnp.float32)) < 0.5
        new_state = {
            "deint_tail": tail,
            "viterbi": vstate,
            "descr_phase": new_phase,
            "descr_locked": state["descr_locked"] | credible,
        }
        metrics = {"rs_corrected": rs_corr, "rs_uncorrectable": rs_bad}
        if measure_pre_rs:
            # exact post-Viterbi (pre-RS) bit errors per CORRECTABLE packet:
            # re-encoding the corrected message reproduces the transmitted
            # codeword, so XOR with the received bytes counts channel errors
            # that the Viterbi stage left behind.  Uncorrectable packets are
            # masked (their error count is unknown, >= 9 bytes).
            diff = packets204 ^ rs_reenc(msg)
            nbits = bitutils.bytes_to_bits(diff).sum(
                axis=-1, dtype=jnp.int32)
            metrics["pre_rs_bit_errors"] = jnp.where(rs_bad, 0, nbits)
        return new_state, ts, metrics

    return run, n_packets


def make_receiver(mode: DvbtMode, n_frames: int | None = None,
                  equalize: bool = True,
                  viterbi_body: int | None = None,
                  viterbi_overlap: int = viterbi.DEFAULT_OVERLAP,
                  viterbi_impl: str = "auto",
                  demap: str = "hard",
                  chan_est: str = "time",
                  metrics: str = "full",
                  fft_impl: str | None = None,
                  measure_pre_rs: bool = False):
    """Returns (rx, n_packets, n_samples).

    rx(state, iq): complex64 (n_samples,) symbol-aligned baseband ->
    (state', ts, metrics).  Non-hierarchical: ts uint8 (n_packets, 188);
    hierarchical: ts = (ts_hp, ts_lp) and n_packets = (n_hp, n_lp).

    chan_est: "time" (default) — reference-density estimation combining
    scattered pilots across the 4-symbol pattern (every-3rd-carrier grid,
    echo tolerance ~Tu/3, carries a 3-symbol pilot history); "freq" — the
    cheaper frequency-only interpolation from the current symbol's pilots
    (12-carrier grid, ~Tu/12 tolerance, stateless).

    metrics: "full" (default) — rs_corrected / rs_uncorrectable per stream
    (hp_/lp_ prefixed when hierarchical), tps_bits (F, 68), tps_frame (F,),
    mer_db, timing_tau — the observability counters of SURVEY.md §5.5;
    "min" — drops the TPS decode and the MER estimate (two extra cell
    permutations) from the compiled program, keeping only the counters the
    lock/SCO control loop consumes (rs_*, timing_tau).
    """
    if n_frames is None:
        n_frames = mode.frames_per_block
    assert n_frames % mode.frames_per_block == 0
    n_blocks = n_frames // mode.frames_per_block
    n_sym = n_frames * SYMBOLS_PER_FRAME
    n_samples = n_sym * mode.symbol_len
    slots = mode.n_payload

    assert chan_est in ("time", "freq"), chan_est
    assert metrics in ("full", "min"), metrics
    full_metrics = metrics == "full"
    time_est = chan_est == "time"
    demod = ofdm.make_ofdm_demodulator(mode, SYMBOLS_PER_FRAME,
                                       fft_impl=fft_impl)
    if time_est:
        est = reference_signals.make_time_channel_estimator(mode)
    else:
        est = reference_signals.make_channel_estimator(mode)
    cell_dilv = reference_signals.make_cell_deinterleaver(mode)  # R3+R5 fused
    tps_dec = reference_signals.make_tps_decoder(mode)
    assert demap in ("hard", "soft")
    qdemap = mapper.make_demapper(mode)
    qmap_points = mapper.make_mapper(mode)
    bit_dilv = bit_interleaver.make_bit_deinterleaver(mode, scale=15)
    if demap == "soft":
        soft_demap = mapper.make_soft_demapper(mode)
        soft_bit_dilv = bit_interleaver.make_soft_bit_deinterleaver(mode)
    hp_dec, n_pk_hp = _make_stream_decoder(
        mode, "hp", n_blocks, viterbi_body, viterbi_overlap, viterbi_impl,
        measure_pre_rs)
    if mode.hierarchical:
        lp_dec, n_pk_lp = _make_stream_decoder(
            mode, "lp", n_blocks, viterbi_body, viterbi_overlap, viterbi_impl,
            measure_pre_rs)

    def rx(state: dict, iq: jnp.ndarray):
        frames = iq.reshape(n_frames, -1)
        with jax.named_scope("ofdm_demod"):
            carriers = demod(frames)                   # (F, 68, K)
        chan_state = (state["chan_tail"], state["chan_valid"])
        if equalize:
            with jax.named_scope("channel_estimate"):
                if time_est:
                    flat = carriers.reshape(
                        n_frames * SYMBOLS_PER_FRAME, -1)
                    new_tail, H = est(state["chan_tail"],
                                      state["chan_valid"], flat)
                    chan_state = (new_tail, jnp.asarray(True))
                    H = H.reshape(carriers.shape)
                else:
                    H = est(carriers)
            X = carriers / H
            # per-symbol timing offset from the channel phase slope: a delay
            # of tau samples gives H(k) ~ exp(-j 2 pi k tau / N), so the
            # power-weighted mean carrier-to-carrier rotation reads tau out
            # directly.  Feeds the SCO tracking loop in models/loopback.py
            # (the reference re-times every symbol in R1; SURVEY.md §2.2).
            dphi = jnp.sum(H[..., 1:] * jnp.conj(H[..., :-1]), axis=-1)
            timing_tau = (-jnp.angle(dphi)
                          * (mode.fft_len / (2.0 * np.pi))).reshape(-1)
        else:
            X = carriers
        if full_metrics:
            with jax.named_scope("tps_decode"):
                tps_bits, tps_frame = tps_dec(X)
        # demap everything (elementwise; pilot columns are don't-cares),
        # then extract+symbol-deinterleave as one fused row-take permutation
        with jax.named_scope("demap_deinterleave"):
            cells = cell_dilv(qdemap(X))               # (F, 68, C)
        if full_metrics:
            # MER / SNR estimate (SURVEY.md §5.5 observability): error power
            # of the equalized payload cells vs their hard decisions.  (A
            # masked full-board formulation that skips the second
            # permutation measured slower on the chain's first platform:
            # reusing the demap output for both consumers blocked the
            # demap+deinterleave fusion.  Not re-measured on the GPU.)
            X_cells = cell_dilv(X)
            p_hat = qmap_points(cells)
            err = X_cells - p_hat
            mer_db = 10.0 * jnp.log10(
                jnp.sum(jnp.abs(p_hat) ** 2)
                / jnp.maximum(jnp.sum(jnp.abs(err) ** 2), 1e-12))
        if demap == "soft":
            # per-bit max-log metrics, CSI-weighted by |H|^2 (noise after
            # zero-forcing is amplified 1/|H|^2, so faded carriers must
            # speak softly — without this the soft chain loses to hard on
            # Rayleigh profiles), permuted like the cells (v rides a
            # leading batch axis through the row-take)
            if equalize:
                csi = jnp.abs(H) ** 2
                csi = csi / jnp.mean(csi, axis=-1, keepdims=True)
                csi = cell_dilv(csi)
            else:
                csi = None
            # permute FIRST, demap the 6048 payload cells only (the
            # elementwise demap commutes with the cell permutation, so
            # values are bit-identical to demap-then-permute; this drops
            # the pilot/TPS columns before the expensive max-log metrics
            # and the v-axis moveaxis dance — VERDICT r4 item 9)
            sm = soft_demap(cell_dilv(X), csi)         # (F, 68, C, v)
            bits = soft_bit_dilv(sm)                   # (F, 68, C*v) 0..15
        else:
            # hard decisions as saturated soft metrics {0,15} for Viterbi
            # (the x15 rides the deinterleaver matmul via scale=15)
            bits = bit_dilv(cells)                     # (F, 68, C*v)
        hp_state = {k: state[k] for k in
                    ("deint_tail", "viterbi", "descr_phase", "descr_locked")}
        if mode.hierarchical:
            grouped = bits.reshape(n_frames, SYMBOLS_PER_FRAME, slots, mode.v)
            hp_bits = grouped[..., :2].reshape(-1)
            lp_bits = grouped[..., 2:].reshape(-1)
            hp_state, ts_hp, m_hp = hp_dec(hp_state, hp_bits)
            lp_state, ts_lp, m_lp = lp_dec(state["lp"], lp_bits)
            new_state = dict(hp_state)
            new_state["chan_tail"], new_state["chan_valid"] = chan_state
            new_state["lp"] = lp_state
            out_metrics = {
                **m_hp,
                **{f"lp_{k}": v for k, v in m_lp.items()},
            }
            if full_metrics:
                out_metrics.update(tps_bits=tps_bits, tps_frame=tps_frame,
                                   mer_db=mer_db)
            if equalize:
                out_metrics["timing_tau"] = timing_tau
            return new_state, (ts_hp, ts_lp), out_metrics
        hp_state, ts, m = hp_dec(hp_state, bits.reshape(-1))
        hp_state = dict(hp_state)
        hp_state["chan_tail"], hp_state["chan_valid"] = chan_state
        out_metrics = dict(m)
        if full_metrics:
            out_metrics.update(tps_bits=tps_bits, tps_frame=tps_frame,
                               mer_db=mer_db)
        if equalize:
            out_metrics["timing_tau"] = timing_tau
        return hp_state, ts, out_metrics

    n_packets = (n_pk_hp, n_pk_lp) if mode.hierarchical else n_pk_hp
    return jax.jit(rx), n_packets, n_samples
