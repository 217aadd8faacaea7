"""Viterbi decoder for the K=7 punctured mother code (R7 in SURVEY.md §2).

Reference behavior: `lib/viterbi_decoder_impl.cc` — Karn-style ACS with SSE2
intrinsics, the reference's only SIMD kernel [unverified — mount empty];
spec: EN300744 §4.3.3.

Design (SURVEY.md §7 hard part 1): the inherently sequential ACS
recursion is broken over the time axis by **overlapped block decoding** — the
stream is cut into independent windows of `body` steps padded by `overlap`
warmup steps on both sides; every window decodes in parallel (windows are a
batch dimension over the 64-state ACS), warmup regions are discarded.  With
overlap >= ~5..10 constraint lengths the result is BER-identical to a full
Viterbi (the PAPERS.md GPU-Viterbi literature pattern).  Depunctured
erasures contribute zero branch metric.  This module is the pure-jnp `scan`
implementation; `kernels/viterbi_triton.py` holds the Pallas (Triton) GPU
kernel with the same contract and bit-identical output.

Carried state: the last `overlap` (x, y, mask) steps of the previous block,
used as warmup prefix so block boundaries lose nothing.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import tables

N_STATES = 64
DEFAULT_OVERLAP = 128
DEFAULT_BODY = 1024


def effective_overlap(rate: str, overlap: int = DEFAULT_OVERLAP) -> int:
    """Overlap rounded up so the carried tail is both byte-aligned and
    puncture-phase-aligned (lcm of 8 and the Table-3 period).  Used by BOTH
    Viterbi implementations so the carried-state pytree shape is
    implementation-independent (jnp scan or the Pallas kernel)."""
    import math
    period = len(tables.PUNCTURE[rate][0])
    align = 8 * period // math.gcd(8, period)
    return -(-overlap // align) * align


@functools.lru_cache(maxsize=None)
def _trellis():
    t = tables.viterbi_tables()
    return (
        np.asarray(t["pred"], np.int32),          # (64, 2)
        np.asarray(t["pred_out_x"], np.int32),    # (64, 2)
        np.asarray(t["pred_out_y"], np.int32),    # (64, 2)
    )


SOFT_MAX = 15  # 4-bit soft scale; hard bits are fed as {0, 15}


def make_viterbi_decoder(n_bits: int, body: int | None = None,
                         overlap: int = DEFAULT_OVERLAP):
    """Returns decode(state, x, y, xm, ym) -> (state', bits).

    x, y   : uint8 (n_bits,) SOFT mother-code bit metrics in [0, 15]
             (confidence the bit is 1; hard decisions are 0/15, erasure
             positions arbitrary).  Branch metric for an expected bit e is
             x when e=0 and 15-x when e=1, so hard inputs reproduce the
             hard-decision Viterbi scaled by 15.
    xm, ym : uint8 (n_bits,) 1 where the bit was transmitted (depuncture
             masks)
    state  : dict with 'x','y','xm','ym' uint8 (overlap,) tails of the
             previous block (zeros/zero-mask at stream start = free warmup)
    bits   : uint8 (n_bits,) decoded info bits for THIS block's steps.

    The decode of the first `overlap` steps uses real context carried from
    the previous block; the final `overlap` steps have no lookahead (end of
    available data) which is the same boundary the reference's streaming
    traceback has at its buffer edge.
    """
    pred_np, pox_np, poy_np = _trellis()

    if body is None:
        body = DEFAULT_BODY
    n_win = -(-n_bits // body)
    padded = n_win * body

    def decode(state, x, y, xm, ym):
        def ext(name, arr):
            pad = jnp.zeros((padded - n_bits,), arr.dtype)
            return jnp.concatenate([state[name], arr, pad], axis=-1)

        pox, poy = jnp.asarray(pox_np), jnp.asarray(poy_np)
        fx, fy = ext("x", x), ext("y", y)
        fxm, fym = ext("xm", xm), ext("ym", ym)
        L = body + 2 * overlap

        # window w covers steps [w*body, w*body + L) of the extended stream
        # (extended stream position p = original position p - overlap);
        # indices from device iota, not embedded constants (compile time)
        widx = (jnp.arange(n_win, dtype=jnp.int32)[:, None] * body
                + jnp.arange(L, dtype=jnp.int32)[None, :])
        total = padded + overlap
        valid = widx < total
        widx_c = jnp.minimum(widx, total - 1)

        def win(arr):
            return jnp.where(valid, arr[widx_c], 0)

        wx, wy = win(fx).astype(jnp.int32), win(fy).astype(jnp.int32)
        wxm, wym = win(fxm).astype(jnp.int32), win(fym).astype(jnp.int32)

        # ACS forward pass over L steps, batched over windows.  The trellis
        # butterfly makes the predecessor lookup a pure reshape — NO gathers:
        # pred(s', d) = 2*(s' & 31) + d, so duplicating pm.reshape(32, 2)
        # along the state axis yields every candidate.  Path metrics are
        # bounded by 2*L << 2^31, so no per-step renormalization is needed.
        # Decisions are bit-packed into two uint32 lanes per window (8x less
        # HBM traffic than a (L, n_win, 64) byte tensor).
        pack_w = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))

        def step(pm, inputs):
            bx, by, bxm, bym = inputs  # (n_win,)
            # soft branch metric: cost(e, s) = s + e*(15 - 2s)
            sx, sy = bx[:, None, None], by[:, None, None]
            mx = bxm[:, None, None] * (sx + pox[None] * (SOFT_MAX - 2 * sx))
            my = bym[:, None, None] * (sy + poy[None] * (SOFT_MAX - 2 * sy))
            bm = (mx + my).astype(jnp.int32)              # (n_win, 64, 2)
            A = pm.reshape(n_win, 32, 2)                  # A[:, j, d]=pm[2j+d]
            cand = jnp.concatenate([A, A], axis=1) + bm   # (n_win, 64, 2)
            dec = (cand[:, :, 1] < cand[:, :, 0])
            new_pm = jnp.minimum(cand[:, :, 0], cand[:, :, 1])
            w0 = (dec[:, :32].astype(jnp.uint32) * pack_w).sum(axis=-1)
            w1 = (dec[:, 32:].astype(jnp.uint32) * pack_w).sum(axis=-1)
            return new_pm, (w0, w1)

        pm0 = jnp.zeros((n_win, N_STATES), jnp.int32)
        inputs = (wx.T, wy.T, wxm.T, wym.T)  # (L, n_win)
        pm_fin, (dw0, dw1) = jax.lax.scan(step, pm0, inputs)  # (L, n_win)

        # traceback from the best final state; decision lookup is a pair of
        # variable shifts on the packed words (again no gathers)
        s_end = jnp.argmin(pm_fin, axis=-1).astype(jnp.uint32)  # (n_win,)

        def tb(s, dec_t):
            w0, w1 = dec_t
            bit = (s >> 5).astype(jnp.uint8)
            d = jnp.where(s < 32, (w0 >> s) & 1, (w1 >> (s - 32)) & 1)
            s_prev = ((s & 31) << 1) | d
            return s_prev.astype(jnp.uint32), bit

        _, bits_rev = jax.lax.scan(tb, s_end, (dw0, dw1), reverse=True)
        bits_all = bits_rev  # (L, n_win): bit at step t of each window
        body_bits = bits_all[overlap: overlap + body]  # (body, n_win)
        out = body_bits.T.reshape(-1)[:n_bits].astype(jnp.uint8)

        # carry the last `overlap` REAL steps (extended position of original
        # step p is p + overlap, so the tail is f[n_bits : n_bits + overlap])
        new_state = {
            "x": fx[n_bits: n_bits + overlap],
            "y": fy[n_bits: n_bits + overlap],
            "xm": fxm[n_bits: n_bits + overlap],
            "ym": fym[n_bits: n_bits + overlap],
        }
        return new_state, out

    return jax.jit(decode)


def init_state(overlap: int = DEFAULT_OVERLAP):
    # four DISTINCT buffers: aliasing one zeros array into all leaves
    # breaks donate_argnums ("attempt to donate the same buffer twice")
    return {k: jnp.zeros((overlap,), jnp.uint8)
            for k in ("x", "y", "xm", "ym")}
