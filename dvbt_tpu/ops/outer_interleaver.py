"""Forney convolutional byte inter/deinterleaver I=12, M=17 (T3 / R8).

Reference behavior: `lib/convolutional_interleaver_impl.cc`,
`lib/convolutional_deinterleaver_impl.cc` [unverified — mount empty]; spec:
EN300744 §4.3.1 Fig 5.

Design: byte i of the stream passes through branch j = i mod 12
with delay j*17 branch-cells = j*204 stream bytes (204 = 12*17 = one RS
packet, so packet starts always hit branch 0 — the sync-alignment the
reference enforces by construction).  On the (packets, 204) board this
means column p of every packet is a pure PACKET-ROW delay of d(p mod 12)
rows: the whole op is 12 free major-axis row slices of the tail-extended
board blended by a static column mask — no gathers, no minor-axis strided
relayouts (this form is bandwidth-bound).  Carried state is the last 2244
bytes of input history (11 * 204 — SURVEY.md §5.4's "interleaver FIFO
tail" pytree leaf).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..mode import OUTER_I, RS_PACKET

TAIL = (OUTER_I - 1) * RS_PACKET  # 2244 bytes of carried history


def _make(n_bytes: int, deinterleave: bool):
    assert n_bytes % RS_PACKET == 0
    n_pk = n_bytes // RS_PACKET
    # column p's branch r = p mod 12; row shift into the tail-extended board
    # s = 11 - d(r), so output packet k column p reads board row k + s —
    # flat position i + TAIL - 204*d(i mod 12), the Forney delay line
    r = np.arange(RS_PACKET) % OUTER_I
    d = (OUTER_I - 1 - r) if deinterleave else r
    shift = (OUTER_I - 1) - d                      # (204,) in [0, 11]

    def apply(tail: jnp.ndarray, x: jnp.ndarray):
        """tail uint8 (2244,), x uint8 (n_bytes,) -> (tail', y)."""
        batch = x.shape[:-1]
        board = jnp.concatenate(
            [tail.reshape(*batch, OUTER_I - 1, RS_PACKET),
             x.reshape(*batch, n_pk, RS_PACKET)], axis=-2)
        out = jnp.zeros(batch + (n_pk, RS_PACKET), x.dtype)
        for s in range(OUTER_I):
            mask = jnp.asarray(shift == s)         # static (204,) plane
            sl = jax.lax.slice_in_dim(board, s, s + n_pk, axis=-2)
            out = jnp.where(mask, sl, out)
        y = out.reshape(*batch, n_bytes)
        new_tail = board[..., -(OUTER_I - 1):, :].reshape(*batch, TAIL)
        return new_tail, y

    return jax.jit(apply)


def make_outer_interleaver(n_bytes: int):
    """``n_bytes`` must be a multiple of 204 (whole RS packets): the packet-
    row formulation requires full (…, n_pk, 204) boards, and DVB-T's MUX
    framing guarantees packet alignment anyway (the reference enforces the
    same alignment via its sync-byte contract).  Feed partial packets by
    padding to the next 204-byte boundary and carrying the remainder."""
    return _make(n_bytes, deinterleave=False)


def make_outer_deinterleaver(n_bytes: int):
    """Inverse; interleaver∘deinterleaver is a pure 2244-byte (11-packet)
    delay.  Same packet-aligned contract: ``n_bytes % 204 == 0``."""
    return _make(n_bytes, deinterleave=True)


def init_state() -> jnp.ndarray:
    return jnp.zeros((TAIL,), dtype=jnp.uint8)
