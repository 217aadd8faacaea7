"""Time-axis (sequence) parallelism: one DVB-T stream sharded over chips.

The reference streams one signal through pipelined threads (SURVEY.md §2.4);
the multi-device analog shards the TIME axis: chip d processes super-block
s*D + d.  The streaming chain is stateful (interleaver tails, coder bits,
Viterbi warmup, scrambler phase — SURVEY.md §5.4), which would serialize the
chips, so state is NOT passed along the chain: every piece of carried state
is *recomputed from a bounded halo* of the neighbor's data (overlap-save,
SURVEY.md §5.7):

  TX state from a 12-packet halo:
    * dispersal phase / frame index — pure functions of the block index
    * outer-interleaver tail        — last 2244 bytes of the re-encoded halo
    * coder bit state               — last 6 bits of the halo's interleaved
                                      stream (deepest branch reaches back
                                      2245 bytes, hence 12 packets)
  RX state from an H-symbol sample halo (H = enough symbols to cover the
  2244-byte deinterleaver tail + Viterbi warmup; 1 symbol at the 8K UK
  profile, 13 at 2K QPSK 1/2):
    * decode the halo symbols with a cold Viterbi (its first ~K*5 bits of
      garbage die out long before the tail we keep)
    * deinterleaver tail = last 2244 decoded bytes; Viterbi warmup = last
      `overlap` depunctured mother bits; scrambler phase — analytic

  The halos themselves move between neighbours via `jax.lax.ppermute` inside
  `shard_map` (NCCL over NVLink on GPUs); the d=0 device's halo is the
  host-carried tail of the previous step.  Result: byte-identical to the single-chip streaming receiver
  (tests/test_time_sharding.py), with zero sequential dependence inside a
  step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..mode import RS_PACKET, SYMBOLS_PER_FRAME, DvbtMode
from ..ops import (bit_interleaver, energy, inner_coder, mapper, ofdm,
                   outer_interleaver, reed_solomon, reference_signals,
                   viterbi)
from ..utils import bits as bitutils
from ..models import rx as rxm, tx as txm

HALO_PACKETS = 12  # > (2244 + 1) / 204


def _stream_rate(mode: DvbtMode, stream: str) -> str:
    """Stream code rate as the registry STRING (effective_overlap and the
    depuncture maker key on it; DvbtMode.stream_rate returns a Fraction)."""
    return mode.code_rate if stream == "hp" else mode.code_rate_lp


def _info_bits_per_symbol(mode: DvbtMode, stream: str = "hp") -> int:
    # delegate the EN300744 §4.3.4.1 HP/LP bit-split to DvbtMode so the
    # halo sizing can never drift from the mode's own rate algebra
    return int(mode.stream_info_bits_per_symbol(stream))


CHAN_WARMUP = 3  # extra halo symbols feeding the time channel estimator


def rx_halo_symbols(mode: DvbtMode) -> int:
    """Symbols needed to recompute the RX carried state: 2244
    deinterleaver-tail bytes + Viterbi cold-start slack, plus CHAN_WARMUP
    symbols so the time channel estimator's pilot history (and the halo
    decode's own estimates) match the streaming receiver exactly — the
    pilot history is a pure function of the last 3 received symbols, so
    the recompute needs no recursion.  Hierarchical modes take the max
    over the HP and LP stream needs (the halo decode rebuilds both)."""
    streams = ("hp", "lp") if mode.hierarchical else ("hp",)
    h = 0
    for stream in streams:
        need_bits = ((outer_interleaver.TAIL + 64) * 8
                     + viterbi.effective_overlap(_stream_rate(mode, stream)))
        h = max(h, -(-need_bits // _info_bits_per_symbol(mode, stream)))
    h += CHAN_WARMUP
    assert h < SYMBOLS_PER_FRAME
    return h


def make_tx_state_from_halo(mode: DvbtMode, stream: str = "hp"):
    """f(block_idx, halo_packets (12, 188)) -> TX carried-state pytree for
    one stream, equal to what streaming TX would carry into that block.
    ``stream`` selects the packet cadence (hierarchical LP blocks carry a
    different packet count); the bit pipeline (dispersal -> RS -> outer ->
    coder state) is rate-independent."""
    n_halo_bytes = HALO_PACKETS * RS_PACKET
    rs_enc = reed_solomon.make_rs_encoder()

    def recompute(block_idx: jnp.ndarray, halo: jnp.ndarray) -> dict:
        p_blk = mode.stream_packets_per_block(stream)
        first_pk = block_idx * p_blk
        phase0 = (first_pk - HALO_PACKETS) % 8
        _, randomized = energy.make_energy_dispersal(HALO_PACKETS)(
            phase0, halo)
        bstream = rs_enc(randomized).reshape(-1)       # (2448,)
        tail = bstream[-outer_interleaver.TAIL:]
        # interleaved byte at global position G-1 (G = block start):
        # j = (G-1) % 12, src = (G-1) - j*204 relative to stream end
        g1 = first_pk * RS_PACKET - 1
        j = g1 % 12
        src = n_halo_bytes - 1 - j * RS_PACKET         # offset into stream
        last_byte = bstream[src]
        coder_state = ((last_byte[None] >> jnp.arange(5, -1, -1)) & 1
                       ).astype(jnp.uint8)
        st = {
            "dispersal_phase": (first_pk % 8).astype(jnp.int32),
            "outer_tail": tail,
            "coder_state": coder_state,
        }
        if stream == "hp":       # frame counter rides the HP (top) state
            st["frame_idx"] = ((block_idx * mode.frames_per_block) % 4
                               ).astype(jnp.int32)
        return st

    return recompute


def make_rx_state_from_halo(mode: DvbtMode, demap: str = "hard"):
    """f(block_idx, halo_iq (H * symbol_len,)) -> RX carried-state pytree
    equal to the streaming receiver's state entering that block.

    halo_iq are the LAST H symbol periods of the previous block (symbol-
    aligned, equalizable); block_idx = 0 means stream start (zero state).
    ``demap`` must match the receiver the state feeds: the halo decode
    reproduces the streaming chain bit-for-bit, including the CSI-weighted
    soft metrics when demap="soft".
    """
    H = rx_halo_symbols(mode)
    Hd = H - CHAN_WARMUP          # symbols actually decoded for byte state
    L = mode.symbol_len
    n_blk_sym = mode.frames_per_block * SYMBOLS_PER_FRAME
    streams = ("hp", "lp") if mode.hierarchical else ("hp",)

    assert demap in ("hard", "soft"), demap
    bins = ofdm._bin_map(mode)
    chan_est = reference_signals.make_time_channel_estimator(mode)
    cell_dilv = reference_signals.make_cell_deinterleaver(mode)
    qdemap = mapper.make_demapper(mode)
    bit_dilv = bit_interleaver.make_bit_deinterleaver(mode)
    if demap == "soft":
        soft_demap = mapper.make_soft_demapper(mode)
        soft_bit_dilv = bit_interleaver.make_soft_bit_deinterleaver(mode)
    sdec = {}
    for s_ in streams:
        n_info_s = Hd * _info_bits_per_symbol(mode, s_)
        rate_s = _stream_rate(mode, s_)
        ov_s = viterbi.effective_overlap(rate_s)
        sdec[s_] = (
            inner_coder.make_depuncture(n_info_s, rate_s),
            viterbi.make_viterbi_decoder(n_info_s,
                                         body=min(1024, n_info_s),
                                         overlap=ov_s),
            ov_s,
        )

    # the halo symbols sit at frame positions (n_blk_sym - H .. n_blk_sym-1)
    # mod 68; the channel estimator / deinterleaver tables are phase-indexed
    # by row position, so embed the halo into a full 68-row frame and slice.
    # The first CHAN_WARMUP halo symbols only feed the time estimator's
    # pilot history — decoded symbols then see exactly the pilot window the
    # streaming receiver saw (the estimator state is a pure function of the
    # previous 3 symbols, so no recursion is needed).
    first_sym = (n_blk_sym - H) % SYMBOLS_PER_FRAME
    assert first_sym + H <= SYMBOLS_PER_FRAME

    def recompute(block_idx: jnp.ndarray, halo_iq: jnp.ndarray) -> dict:
        syms = halo_iq.reshape(H, L)[:, mode.guard_len:]
        spec = jnp.fft.fft(syms, axis=-1, norm="ortho")[:, jnp.asarray(bins)]
        # pad to a frame-aligned 68-symbol board for the phase-indexed ops
        board = jnp.zeros((SYMBOLS_PER_FRAME, mode.n_carriers), spec.dtype)
        board = jax.lax.dynamic_update_slice(board, spec, (first_sym, 0))
        # zeros tail + valid=False only affect board rows < first_sym + 3,
        # which are never decoded below; chan_tail comes out as the pilot
        # estimates of board rows 65..67 = the block's last 3 symbols.
        tail0, _ = reference_signals.init_time_channel_state(mode)
        chan_tail, Hh = chan_est(tail0, jnp.asarray(False), board)
        X = board / Hh
        if demap == "soft":
            # CSI-weighted metrics, value-identical to models/rx.py:
            # normalize CSI over the full carrier axis, then permute-first
            # and demap the payload cells only (the elementwise demap
            # commutes with the cell permutation — same r5 fold as rx.py)
            csi = jnp.abs(Hh) ** 2
            csi = csi / jnp.mean(csi, axis=-1, keepdims=True)
            sm = soft_demap(cell_dilv(X), cell_dilv(csi))  # (68, C, v)
            board_bits = soft_bit_dilv(sm)                 # (68, C*v) 0..15
            board_bits = jax.lax.dynamic_slice(
                board_bits, (first_sym + CHAN_WARMUP, 0),
                (Hd, board_bits.shape[-1]))
        else:
            cells = cell_dilv(qdemap(X))              # (68, n_payload)
            cells = jax.lax.dynamic_slice(
                cells, (first_sym + CHAN_WARMUP, 0), (Hd, mode.n_payload))
            board_bits = bit_dilv(cells) * np.uint8(15)    # -> {0,15}
        first = block_idx == 0

        def stream_state(s_, bits):
            depunct, vit, ov = sdec[s_]
            x, y, xm, ym = depunct(bits)
            xm = jnp.broadcast_to(xm, x.shape).astype(jnp.uint8)
            ym = jnp.broadcast_to(ym, y.shape).astype(jnp.uint8)
            vstate = {"x": x[-ov:], "y": y[-ov:],
                      "xm": xm[-ov:], "ym": ym[-ov:]}
            _, info = vit(viterbi.init_state(ov), x, y, xm, ym)
            # the halo covers the LAST n bits before a block boundary (a
            # byte multiple), so the stream's byte grid starts n % 8 bits
            # into the decoded halo — drop that prefix before packing
            # (hierarchical LP symbol-info counts need not be % 8)
            info = info[info.shape[0] % 8:]
            sbytes = bitutils.bits_to_bytes(info)
            tail = sbytes[-outer_interleaver.TAIL:]
            p_blk = mode.stream_packets_per_block(s_)
            return {
                "deint_tail": jnp.where(first, jnp.zeros_like(tail), tail),
                "viterbi": jax.tree.map(
                    lambda z, v_: jnp.where(first, z, v_),
                    viterbi.init_state(ov), vstate),
                # analytic scrambler group phase: the stream entering RS at
                # block b starts at TS packet b*P - 11 (outer delay), and
                # the streaming detector converges to exactly this phase
                "descr_phase": ((block_idx * p_blk - 11) % 8
                                ).astype(jnp.int32),
                "descr_locked": jnp.asarray(True),
            }

        if mode.hierarchical:
            grouped = board_bits.reshape(Hd, mode.n_payload, mode.v)
            st = stream_state("hp", grouped[..., :2].reshape(-1))
            st["lp"] = stream_state("lp", grouped[..., 2:].reshape(-1))
        else:
            st = stream_state("hp", board_bits.reshape(-1))
        st["chan_tail"] = jnp.where(first, jnp.zeros_like(chan_tail),
                                    chan_tail)
        st["chan_valid"] = ~first
        return st

    return recompute


def make_time_sharded_loopback(mode: DvbtMode, mesh: Mesh,
                               demap: str = "hard"):
    """Returns (step, n_pk_blk, carry0).

    step(carry, packets (D*P, 188) sharded over 'time')
      -> (carry', ts (D*P, 188) sharded, fleet metrics)

    Hierarchical modes carry TWO transport streams: packets and ts are
    then (hp, lp) pairs (each sharded over 'time'), n_pk_blk is the
    (n_hp, n_lp) pair, and the packet halo/TX-state recompute runs per
    stream while the sample halo and channel state are shared (r5 —
    closes the last capability gap between the mux-DP and time axes).

    Each device transmits and receives one super-block; TX packet halos and
    RX sample halos go to the next device by `ppermute`.  carry holds
    the host-side tail of the previous step for device 0 plus the global
    step count.  ``demap`` ("hard"/"soft") applies to both the receiver
    and the halo state recompute, so the soft chain is byte-identical to
    single-chip streaming too.
    """
    D = mesh.devices.size
    tx, n_pk, n_samp = txm.make_transmitter(mode)
    rx, _, _ = rxm.make_receiver(mode, demap=demap)
    # hierarchical modes carry TWO TS streams: packets/halos/TX state are
    # per-stream (HP + LP), the sample halo and channel state are shared
    tx_state_of = make_tx_state_from_halo(mode, "hp")
    tx_state_of_lp = (make_tx_state_from_halo(mode, "lp")
                      if mode.hierarchical else None)
    rx_state_of = make_rx_state_from_halo(mode, demap)
    H = rx_halo_symbols(mode)
    L = mode.symbol_len
    halo_samp = H * L

    ring = [(i, (i + 1) % D) for i in range(D)]

    def shift(v):
        return jax.lax.ppermute(v, "time", ring)

    hier = mode.hierarchical

    def local(carry, packets):
        # packets: (P, 188) on this shard; hierarchical: a (hp, lp) pair
        prev_pk, prev_iq, step_idx = carry
        d = jax.lax.axis_index("time")
        block_idx = step_idx * D + d

        # --- TX ---------------------------------------------------------
        def pk_halo(pk, prev):
            tail = pk[-HALO_PACKETS:]
            h = shift(tail)
            return tail, jnp.where(d == 0, prev, h)

        if hier:
            my_tail_hp, halo_hp = pk_halo(packets[0], prev_pk[0])
            my_tail_lp, halo_lp = pk_halo(packets[1], prev_pk[1])
            tstate = tx_state_of(block_idx, halo_hp)
            tstate["lp"] = tx_state_of_lp(block_idx, halo_lp)
        else:
            my_tail_hp, halo_hp = pk_halo(packets, prev_pk)
            tstate = tx_state_of(block_idx, halo_hp)
        tstate = jax.tree.map(
            lambda i, r: jnp.where(block_idx == 0, i, r),
            txm.init_tx_state(mode), tstate)
        _, iq = tx(tstate, packets)

        # --- RX (sample halo from the left neighbor's TX output) ---------
        my_tail_iq = iq[-halo_samp:]
        halo_iq = shift(my_tail_iq)
        halo_iq = jnp.where(d == 0, prev_iq, halo_iq)
        rstate = rx_state_of(block_idx, halo_iq)
        _, ts, metrics = rx(rstate, iq)

        fleet = {
            "rs_uncorrectable_total": jax.lax.psum(
                metrics["rs_uncorrectable"].sum(), "time"),
        }
        if hier:
            fleet["lp_rs_uncorrectable_total"] = jax.lax.psum(
                metrics["lp_rs_uncorrectable"].sum(), "time")
        # host carry for the next step: LAST device's tails, replicated
        def last(x):
            return jax.lax.all_gather(x, "time")[D - 1]

        last_pk = ((last(my_tail_hp), last(my_tail_lp)) if hier
                   else last(my_tail_hp))
        return (last_pk, last(my_tail_iq), step_idx + 1), ts, fleet

    pk_spec = (P("time"), P("time")) if hier else P("time")
    pk_rep = (P(), P()) if hier else P()
    ts_spec = (P("time"), P("time")) if hier else P("time")
    step = jax.jit(jax.shard_map(
        local,
        mesh=mesh,
        in_specs=((pk_rep, P(), P()), pk_spec),
        out_specs=((pk_rep, P(), P()), ts_spec, P()),
        check_vma=False,
    ))

    pk0 = jnp.zeros((HALO_PACKETS, 188), jnp.uint8)
    carry0 = ((pk0, jnp.zeros_like(pk0)) if hier else pk0,
              jnp.zeros((halo_samp,), jnp.complex64),
              jnp.int32(0))
    return step, n_pk, carry0
