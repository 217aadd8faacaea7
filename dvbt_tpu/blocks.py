"""Block registry: machine-readable descriptors of every public block.

The reference ships one GRC XML per block (SURVEY.md S6: `grc/dvbt_*.xml`)
so flowgraph tools can compose them; this registry is the same contract for
this framework — name, factory, parameter schema (with enums), port
signature, and the reference block it corresponds to.  ``python -m
dvbt_tpu.blocks`` regenerates the YAML descriptors under ``grc/``.
"""

from __future__ import annotations

import dataclasses

ENUMS = {
    "transmission": ["2k", "8k"],
    "constellation": ["qpsk", "16qam", "64qam"],
    "code_rate": ["1/2", "2/3", "3/4", "5/6", "7/8"],
    "guard": ["1/32", "1/16", "1/8", "1/4"],
    "alpha": [0, 1, 2, 4],
}

MODE_PARAMS = {
    "transmission": "enum:transmission",
    "constellation": "enum:constellation",
    "code_rate": "enum:code_rate (HP)",
    "code_rate_lp": "enum:code_rate (LP, hierarchical)",
    "guard": "enum:guard",
    "alpha": "enum:alpha (0 = non-hierarchical)",
    "cell_id": "int",
}


@dataclasses.dataclass(frozen=True)
class Block:
    name: str
    factory: str                 # python path of the make_* factory
    reference: str               # reference class (SURVEY.md §2 id)
    inputs: str
    outputs: str
    params: tuple = ()
    notes: str = ""


BLOCKS = (
    Block("energy_dispersal", "dvbt_tpu.ops.energy.make_energy_dispersal",
          "T1 energy_dispersal", "uint8 (P, 188) TS packets + group phase",
          "uint8 (P, 188) randomized + phase'", ("n_packets",)),
    Block("reed_solomon_enc", "dvbt_tpu.ops.reed_solomon.make_rs_encoder",
          "T2 reed_solomon_enc", "uint8 (..., P, 188)", "uint8 (..., P, 204)"),
    Block("convolutional_interleaver",
          "dvbt_tpu.ops.outer_interleaver.make_outer_interleaver",
          "T3 convolutional_interleaver",
          "uint8 (n,) byte stream + 2244-byte tail",
          "uint8 (n,) interleaved + tail'", ("n_bytes",),
          "n_bytes must be a multiple of 204 (whole RS packets)"),
    Block("inner_coder", "dvbt_tpu.ops.inner_coder.make_inner_coder",
          "T4 inner_coder", "uint8 (n,) info bytes + 6-bit state",
          "uint8 (8n/rate,) punctured coded bits + state'",
          ("n_bytes", "code_rate")),
    Block("bit_inner_interleaver",
          "dvbt_tpu.ops.bit_interleaver.make_bit_interleaver",
          "T5 bit_inner_interleaver",
          "uint8 (..., 68, n_payload*v) coded bits",
          "int32 (..., 68, n_payload) cells", ("mode",),
          "inverse: make_bit_deinterleaver"),
    Block("symbol_inner_interleaver",
          "dvbt_tpu.ops.symbol_interleaver.make_symbol_interleaver",
          "T6/R5 symbol_inner_interleaver",
          "(..., n_sym, n_payload) cells", "same, H(q)-permuted",
          ("mode", "n_sym", "deinterleave"),
          "fused into reference_signals.make_frame_builder / "
          "make_cell_deinterleaver on the hot path"),
    Block("dvbt_map", "dvbt_tpu.ops.mapper.make_mapper", "T7 dvbt_map",
          "int32 cells", "complex64 points (incl. hierarchical alpha)",
          ("mode",)),
    Block("reference_signals",
          "dvbt_tpu.ops.reference_signals.make_frame_builder",
          "T8 reference_signals",
          "(..., 68, n_payload) points + frame index",
          "(..., 68, K) carriers with pilots/TPS", ("mode",)),
    Block("ofdm_modulator", "dvbt_tpu.ops.ofdm.make_ofdm_modulator",
          "T9 (external fft_vcc + cyclic_prefixer)",
          "(..., n_sym, K) carriers", "complex64 baseband at 64/7 Msps",
          ("mode",)),
    Block("ofdm_sym_acquisition", "dvbt_tpu.ops.ofdm.make_symbol_acquisition",
          "R1 ofdm_sym_acquisition", "complex64 (n,) raw baseband",
          "(theta, cfo_frac)", ("mode", "n_samples")),
    Block("synchronizer", "dvbt_tpu.ops.sync.make_synchronizer",
          "R1+R3 acquisition & sync",
          "complex64 capture (unknown delay/CFO/frame phase)",
          "aligned CFO-corrected block + estimates",
          ("mode", "n_samples_in", "n_frames_out", "max_int_cfo")),
    Block("ofdm_demodulator", "dvbt_tpu.ops.ofdm.make_ofdm_demodulator",
          "R2 (external fft_vcc)", "complex64 symbol-aligned baseband",
          "(..., n_sym, K) carriers", ("mode", "n_sym")),
    Block("demod_reference_signals",
          "dvbt_tpu.ops.reference_signals.make_channel_estimator",
          "R3 demod_reference_signals (channel est/equalize half)",
          "(..., 68, K) carriers", "(..., 68, K) channel estimate",
          ("mode",),
          "payload extraction fused with R5: make_cell_deinterleaver; "
          "TPS decode: make_tps_decoder"),
    Block("dvbt_demap", "dvbt_tpu.ops.mapper.make_demapper", "R4 dvbt_demap",
          "complex64 equalized cells", "int32 hard-decision cell values",
          ("mode",)),
    Block("viterbi_decoder",
          "dvbt_tpu.kernels.viterbi_triton.make_viterbi_decoder_punctured",
          "R7 viterbi_decoder (SSE2 kernel)",
          "uint8 punctured soft stream (0..15) + warmup state",
          "uint8 decoded info bytes + state'",
          ("n_bits", "rate", "body", "overlap"),
          "Pallas (Triton) GPU kernel; pure-jnp reference impl in "
          "ops.viterbi (make_viterbi_decoder after "
          "ops.inner_coder.make_depuncture)"),
    Block("convolutional_deinterleaver",
          "dvbt_tpu.ops.outer_interleaver.make_outer_deinterleaver",
          "R8 convolutional_deinterleaver",
          "uint8 (n,) byte stream + tail", "uint8 (n,) MUX-aligned + tail'",
          ("n_bytes",),
          "n_bytes must be a multiple of 204 (whole RS packets)"),
    Block("reed_solomon_dec", "dvbt_tpu.ops.reed_solomon.make_rs_decoder",
          "R9 reed_solomon_dec", "uint8 (..., P, 204)",
          "(uint8 (..., P, 188), n_corrected, uncorrectable)"),
    Block("energy_descramble", "dvbt_tpu.ops.energy.make_energy_dispersal",
          "R10 energy_descramble",
          "uint8 (P, 188) + phase (detect: detect_dispersal_phase)",
          "uint8 (P, 188) clean TS + phase'", ("n_packets",),
          "scrambling is an involution; same op as T1"),
    Block("dvbt_tx", "dvbt_tpu.models.tx.make_transmitter",
          "TX flowgraph (apps/)", "TS packets (+ LP stream if hierarchical)",
          "complex64 baseband", ("mode", "n_frames")),
    Block("dvbt_rx", "dvbt_tpu.models.rx.make_receiver",
          "RX flowgraph (apps/)", "symbol-aligned baseband",
          "TS packets (+ LP) + metrics", ("mode", "n_frames")),
)


def to_yaml(b: Block) -> str:
    lines = [
        f"id: {b.name}",
        f"factory: {b.factory}",
        f"reference: {b.reference}",
        f"inputs: {b.inputs}",
        f"outputs: {b.outputs}",
    ]
    if b.params:
        lines.append("parameters:")
        for p in b.params:
            if p == "mode":
                lines.append("  mode:  # DvbtMode fields")
                for k, v in MODE_PARAMS.items():
                    lines.append(f"    {k}: {v}")
            else:
                lines.append(f"  {p}:")
    if b.notes:
        lines.append(f"notes: {b.notes}")
    return "\n".join(lines) + "\n"


def main():
    import os
    out = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "grc")
    os.makedirs(out, exist_ok=True)
    for b in BLOCKS:
        with open(os.path.join(out, f"dvbt_{b.name}.yml"), "w") as f:
            f.write(to_yaml(b))
    print(f"wrote {len(BLOCKS)} descriptors to {out}/")


if __name__ == "__main__":
    main()
