"""The complete DVB-T transmit chain as ONE pure jitted function.

Reference: the TX flowgraph of SURVEY.md §3.1 (energy_dispersal →
reed_solomon_enc → convolutional_interleaver → inner_coder →
bit_inner_interleaver → symbol_inner_interleaver → dvbt_map →
reference_signals → IFFT+CP).  Where GNU Radio pipelines 10 blocks across
threads with circular buffers, XLA fuses the same dataflow into one compiled
program over a frame-aligned super-block; all streaming state is an explicit
carried pytree (SURVEY.md §7 design stance).

Hierarchical modes carry TWO transport streams (HP at ``code_rate``, LP at
``code_rate_lp``): each gets its own dispersal/RS/outer/inner chain and the
bit interleaver demultiplexes HP onto substreams b0,b1 and LP onto b2..b5
[EN300744 §4.3.4.1] — in this implementation the two coded streams are
zipped into v-bit slots, which is exactly the layout
tables.bit_interleaver_indices(v, hierarchical=True) encodes.
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
)

# frames per lax.map chunk for the symbol-domain TX stages (0 = one-shot
# full batch); A/B-measured on hardware before changing the default
import os as _os
_TX_CHUNK = int(_os.environ.get("DVBT_TX_CHUNK", "0"))


def _init_stream_state() -> dict:
    return {
        "dispersal_phase": jnp.int32(0),
        "outer_tail": outer_interleaver.init_state(),
        "coder_state": inner_coder.init_state(),
    }


def init_tx_state(mode: DvbtMode) -> dict:
    """Carried TX state pytree (SURVEY.md §5.4)."""
    state = _init_stream_state()
    state["frame_idx"] = jnp.int32(0)
    if mode.hierarchical:
        state["lp"] = _init_stream_state()
    return state


def _make_stream_pipeline(mode: DvbtMode, stream: str, n_blocks: int):
    """Per-stream bit pipeline: TS packets -> coded bits (T1..T4)."""
    n_packets = mode.stream_packets_per_block(stream) * n_blocks
    n_bytes = n_packets * RS_PACKET
    rate = mode.code_rate if stream == "hp" else mode.code_rate_lp

    disperse = energy.make_energy_dispersal(n_packets)
    rs_enc = reed_solomon.make_rs_encoder()
    out_ilv = outer_interleaver.make_outer_interleaver(n_bytes)
    coder = inner_coder.make_inner_coder(n_bytes, rate)

    def run(state: dict, packets: jnp.ndarray):
        with jax.named_scope("energy_dispersal"):
            phase, randomized = disperse(state["dispersal_phase"], packets)
        with jax.named_scope("rs_encode"):
            coded204 = rs_enc(randomized)
        with jax.named_scope("outer_interleave"):
            tail, interleaved = out_ilv(state["outer_tail"],
                                        coded204.reshape(-1))
        with jax.named_scope("inner_coder"):
            cstate, coded_bits = coder(state["coder_state"], interleaved)
        new_state = {
            "dispersal_phase": phase,
            "outer_tail": tail,
            "coder_state": cstate,
        }
        return new_state, coded_bits

    return run, n_packets


def make_transmitter(mode: DvbtMode, n_frames: int | None = None,
                     fft_impl: str | None = None):
    """Returns (tx, n_packets, n_samples).

    Non-hierarchical: tx(state, packets) with packets uint8 (n_packets, 188).
    Hierarchical: tx(state, (packets_hp, packets_lp)); n_packets is then the
    (hp, lp) pair.  Output: (state', iq complex64 (n_samples,)).
    fft_impl: None (DVBT_FFT env default) | "jnp" | "matmul".
    """
    if n_frames is None:
        n_frames = mode.frames_per_block
    assert n_frames % mode.frames_per_block == 0
    n_blocks = n_frames // mode.frames_per_block
    n_sym = n_frames * SYMBOLS_PER_FRAME

    hp_pipe, n_pk_hp = _make_stream_pipeline(mode, "hp", n_blocks)
    if mode.hierarchical:
        lp_pipe, n_pk_lp = _make_stream_pipeline(mode, "lp", n_blocks)
    bit_ilv = bit_interleaver.make_bit_interleaver(mode)
    qmap = mapper.make_mapper(mode)
    builder = reference_signals.make_frame_builder(mode)  # sym_ilv + T8 fused
    modulator = ofdm.make_ofdm_modulator(mode, fft_impl=fft_impl)
    n_samples = n_sym * mode.symbol_len
    slots = mode.n_payload

    def tx(state: dict, packets):
        if mode.hierarchical:
            pk_hp, pk_lp = packets
        else:
            pk_hp = packets
        hp_state, hp_bits = hp_pipe(
            {k: state[k] for k in
             ("dispersal_phase", "outer_tail", "coder_state")}, pk_hp)
        if mode.hierarchical:
            lp_state, lp_bits = lp_pipe(state["lp"], pk_lp)
            hp = hp_bits.reshape(n_frames, SYMBOLS_PER_FRAME, slots, 2)
            lp = lp_bits.reshape(n_frames, SYMBOLS_PER_FRAME, slots,
                                 mode.v - 2)
            per_sym = jnp.concatenate([hp, lp], axis=-1).reshape(
                n_frames, SYMBOLS_PER_FRAME, slots * mode.v)
        else:
            per_sym = hp_bits.reshape(n_frames, SYMBOLS_PER_FRAME,
                                      slots * mode.v)
        fidx = state["frame_idx"] + jnp.arange(n_frames, dtype=jnp.int32)

        def frame_chain(args):
            ps, fi = args
            with jax.named_scope("bit_interleave"):
                cells = bit_ilv(ps)                   # (f, 68, C)
            with jax.named_scope("qam_map"):
                points = qmap(cells)                  # (f, 68, C) complex
            with jax.named_scope("frame_build"):
                return jax.vmap(builder)(fi, points)  # (f, 68, K)

        # optional lax.map over frame chunks (DVBT_TX_CHUNK): full-batch
        # symbol processing anti-scaled on the chain's first platform; not
        # re-tuned on the GPU.  chunk = n_frames reproduces the
        # one-shot program exactly.
        chunk = _TX_CHUNK or n_frames
        if chunk >= n_frames:
            carriers = frame_chain((per_sym, fidx))
        else:
            assert n_frames % chunk == 0
            carriers = jax.lax.map(
                frame_chain,
                (per_sym.reshape(n_frames // chunk, chunk, *per_sym.shape[1:]),
                 fidx.reshape(-1, chunk))
            ).reshape(n_frames, SYMBOLS_PER_FRAME, -1)
        with jax.named_scope("ofdm_mod"):
            iq = modulator(carriers).reshape(-1)
        new_state = dict(hp_state)
        new_state["frame_idx"] = (state["frame_idx"] + n_frames) % 4
        if mode.hierarchical:
            new_state["lp"] = lp_state
        return new_state, iq

    n_packets = (n_pk_hp, n_pk_lp) if mode.hierarchical else n_pk_hp
    return jax.jit(tx), n_packets, n_samples
