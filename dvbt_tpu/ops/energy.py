"""Energy dispersal / descrambling (T1 / R10 in SURVEY.md §2).

Reference behavior: `lib/energy_dispersal_impl.cc`, `lib/energy_descramble_impl.cc`
[unverified — mount empty]; spec: EN300744 §4.3.1.

Design: the streaming per-bit LFSR of the reference collapses into
a precomputed (8, 188) XOR pattern (one row per packet position within the
8-packet dispersal group).  A whole block of packets is scrambled with one
gather + XOR; the only carried state is the group phase (int32 scalar).
Scrambling is an involution, so the descrambler reuses the same pattern; its
extra job is phase acquisition from the inverted 0xB8 sync bytes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import tables


def make_energy_dispersal(n_packets: int):
    """Returns apply(phase, packets) -> (phase', packets') for uint8 (P, 188).

    ``phase`` is the dispersal-group index (0..7) of the first packet in the
    block.  Same function serves TX scrambling and RX descrambling.
    """
    pat = tables.dispersal_pattern()  # numpy: embedded at trace time
    offsets = np.arange(n_packets, dtype=np.int32)

    def apply(phase: jnp.ndarray, packets: jnp.ndarray):
        idx = (phase + offsets) % 8
        out = packets ^ jnp.asarray(pat)[idx]
        return (phase + n_packets) % 8, out

    return jax.jit(apply)


@jax.jit
def detect_dispersal_phase(packets: jnp.ndarray) -> jnp.ndarray:
    """Estimate the group phase from sync bytes of a scrambled packet block.

    Packet i carries the inverted sync 0xB8 iff (phase + i) % 8 == 0.  Returns
    the argmax-scoring phase (int32).  Mirrors the reference's 0xB8 search in
    `energy_descramble_impl` (SURVEY.md R10).
    """
    n = packets.shape[0]
    i = jnp.arange(n, dtype=jnp.int32)
    is_b8 = (packets[:, 0] == 0xB8).astype(jnp.int32)
    is_47 = (packets[:, 0] == 0x47).astype(jnp.int32)
    scores = []
    for q in range(8):
        sel = ((q + i) % 8 == 0).astype(jnp.int32)
        # reward 0xB8 where expected and 0x47 elsewhere
        scores.append(jnp.sum(sel * is_b8 + (1 - sel) * is_47))
    return jnp.argmax(jnp.stack(scores)).astype(jnp.int32)
