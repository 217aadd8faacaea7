"""Punctured convolutional inner coder K=7 (T4) and RX depuncturing.

Reference behavior: `lib/inner_coder_impl.cc` and the depuncture half of
`lib/viterbi_decoder_impl.cc` [unverified — mount empty]; spec: EN300744
§4.3.3 (G1=171o, G2=133o, Table 3 puncturing).

Design: the bit-serial shift register becomes five XORs of byte-aligned
shifted views of the whole byte block (elementwise work that XLA fuses);
puncturing and depuncturing become static column slices of the periodic
Table 3 patterns.  Carried state: the last 6 input bits.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import tables


def make_inner_coder(n_bytes: int, rate: str):
    """Returns apply(state6, stream_bytes) -> (state6', coded_bits).

    stream_bytes: uint8 (n_bytes,) byte stream, serialized MSB-first.
    state6: uint8 (6,) the last 6 input bits, oldest first.
    coded_bits: uint8 {0,1} (n_bytes * 8 * den / num,) after rate num/den
    puncturing, in transmitted serial order.

    The mother code runs on PACKED bytes: tap d of the shift register is
    the byte-aligned shifted stream T_d = (prev << (8-d) | cur >> d) & 0xFF,
    so x = T0^T1^T2^T3^T6 and y = T0^T2^T3^T5^T6 (G1=171o, G2=133o); bits
    are expanded only for the puncture.  (Measured on an H100 against the
    bit-level form, which XOR'd shifted views of the unpacked bit stream:
    slightly faster in the fused TX+RX step, PERF.md.)
    """
    order = tables.puncture_serial_order(rate)
    period = len(tables.PUNCTURE[rate][0])
    n_bits = n_bytes * 8
    assert n_bits % period == 0, (n_bits, period)
    n_blk = n_bits // period
    w6 = np.asarray([32, 16, 8, 4, 2, 1], np.int32)
    sh = np.arange(7, -1, -1, dtype=np.int32)

    def apply(state: jnp.ndarray, stream: jnp.ndarray):
        cur = stream.astype(jnp.int32)
        hb = jnp.sum(state.astype(jnp.int32) * w6)[None]
        prev = jnp.concatenate([hb, cur[:-1]])

        def tap(d):
            return cur if d == 0 else ((prev << (8 - d)) | (cur >> d)) & 0xFF

        common = tap(0) ^ tap(2) ^ tap(3) ^ tap(6)
        xb = (((common ^ tap(1))[:, None] >> sh) & 1).reshape(n_blk, period)
        yb = (((common ^ tap(5))[:, None] >> sh) & 1).reshape(n_blk, period)
        cols = [xb[:, o // 2] if o % 2 == 0 else yb[:, o // 2]
                for o in order]
        coded = jnp.stack(cols, axis=-1).reshape(-1).astype(jnp.uint8)
        new_state = ((cur[-1] >> sh[2:]) & 1).astype(jnp.uint8)
        return new_state, coded

    return jax.jit(apply)


def make_depuncture(n_info_bits: int, rate: str):
    """Returns depuncture(coded) -> (x, y, x_known, y_known), each (n_info_bits,).

    Re-inserts erasures at punctured positions: *_known masks are 1 where the
    mother-code bit was actually transmitted.  Input dtype is preserved so the
    same map serves hard bits (uint8) and soft metrics (float).
    """
    order = tables.puncture_serial_order(rate)
    period = len(tables.PUNCTURE[rate][0])
    assert n_info_bits % period == 0
    n_blk = n_info_bits // period
    n_keep = len(order)
    # per-period known masks + inverse ranks (tiny constants)
    known_np = np.zeros(2 * period, dtype=np.uint8)
    known_np[np.asarray(order)] = 1
    rank_np = np.full(2 * period, -1, dtype=np.int64)
    rank_np[np.asarray(order)] = np.arange(n_keep)

    def depuncture(coded: jnp.ndarray):
        # column-slice formulation: the pattern is periodic, so reshape to
        # (n_blk, n_keep) and rebuild the mother columns from static strided
        # slices (no gather/scatter over the 2*n_info stream).
        c = coded.reshape(*coded.shape[:-1], n_blk, n_keep)
        zeros = jnp.zeros(c.shape[:-1], coded.dtype)
        cols = [zeros if rank_np[r] < 0 else c[..., rank_np[r]]
                for r in range(2 * period)]
        x = jnp.stack(cols[0::2], axis=-1).reshape(*coded.shape[:-1], -1)
        y = jnp.stack(cols[1::2], axis=-1).reshape(*coded.shape[:-1], -1)
        kx = jnp.tile(jnp.asarray(known_np[0::2]), n_blk)
        ky = jnp.tile(jnp.asarray(known_np[1::2]), n_blk)
        return x, y, kx, ky

    return jax.jit(depuncture)


def init_state() -> jnp.ndarray:
    return jnp.zeros((6,), dtype=jnp.uint8)
