"""Pallas (Triton route) Viterbi kernel: overlapped-window ACS + traceback.

Reference behavior: `lib/viterbi_decoder_impl.cc` (SURVEY.md §2.2 R7); the
plain form with the same contract is the `lax.scan` pair in
:mod:`dvbt_tpu.ops.viterbi`.  That form runs 2 * L device-loop iterations
per decode (L = body + 2 * overlap trellis steps), each a handful of tiny
fused ops over the (n_win, 64) path metrics, so loop overhead and the
path-metric round trip through device memory set its time.

Here one GPU thread owns one window (the GPU-Viterbi pattern of
PAPERS.md, arXiv 1608.00066 / 2011.09337): a program of W windows keeps
its 64 x W int32 path metrics in registers for all L steps of one launch.

* The 64 states are 64 separate (W,) vectors, so the butterfly
  ``pred(s', d) = 2 * (s' & 31) + d`` is static Python indexing — no
  gather, no per-step layout change.
* Per step each thread loads ONE packed uint16 (soft x | soft y << 4 |
  x known << 8 | y known << 9); the four branch metrics follow from it.
* Decisions are packed 32 per uint32 word (exactly the w0/w1 words of
  ops.viterbi) into a per-window survivor buffer that the same thread reads
  back in the traceback; only the decoded bytes are kept.

Path metrics are bounded by 30 * L << 2^31, so no renormalization; ties
break exactly like ops.viterbi (strict ``<`` decisions, first-index argmin),
which makes the output bit-identical, not just BER-equivalent.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .. import tables
from ..ops import inner_coder, viterbi
from ..ops.viterbi import N_STATES, SOFT_MAX

WINDOWS_PER_PROGRAM = 32     # one warp: one window per thread
NUM_WARPS = WINDOWS_PER_PROGRAM // 32


@functools.lru_cache(maxsize=None)
def branch_table() -> tuple:
    """(pox, poy) per (s', d): the encoder outputs on the edge
    pred(s', d) -> s', as nested tuples of Python ints (static kernel
    indices)."""
    t = tables.viterbi_tables()
    pox = tuple(tuple(int(v) for v in row) for row in t["pred_out_x"])
    poy = tuple(tuple(int(v) for v in row) for row in t["pred_out_y"])
    return pox, poy


def pack_soft(x, y, xm, ym):
    """uint8 soft metrics + known masks -> one uint16 per trellis step."""
    u16 = jnp.uint16
    return (x.astype(u16) | (y.astype(u16) << 4) | (xm.astype(u16) << 8)
            | (ym.astype(u16) << 9))


def _acs_kernel(in_ref, out_ref, dec0_ref, dec1_ref, *, L, ov, body):
    """in_ref (L, W) uint16 packed steps; out_ref (body//8, W) uint8 bytes;
    dec*_ref (L, W) uint32 survivor words (written here, read back below)."""
    pox, poy = branch_table()

    def fwd(t, pm):
        v = in_ref[t, :].astype(jnp.int32)
        x, y = v & 15, (v >> 4) & 15
        xm, ym = (v >> 8) & 1, (v >> 9) & 1
        cx = (xm * x, xm * (SOFT_MAX - x))        # cost of expected bit 0/1
        cy = (ym * y, ym * (SOFT_MAX - y))
        bm = [[cx[ex] + cy[ey] for ey in (0, 1)] for ex in (0, 1)]
        new = []
        w = [jnp.zeros_like(v).astype(jnp.uint32) for _ in range(2)]
        for s in range(N_STATES):
            p = 2 * (s & 31)
            c0 = pm[p] + bm[pox[s][0]][poy[s][0]]
            c1 = pm[p + 1] + bm[pox[s][1]][poy[s][1]]
            dec = c1 < c0
            new.append(jnp.where(dec, c1, c0))
            w[s >> 5] = w[s >> 5] | (dec.astype(jnp.uint32) << (s & 31))
        dec0_ref[t, :] = w[0]
        dec1_ref[t, :] = w[1]
        return tuple(new)

    zero = jnp.zeros(in_ref.shape[1:], jnp.int32)
    pm = jax.lax.fori_loop(0, L, fwd, (zero,) * N_STATES)

    # best final state, first index on ties (== jnp.argmin)
    best, s = pm[0], zero
    for k in range(1, N_STATES):
        better = pm[k] < best
        best = jnp.where(better, pm[k], best)
        s = jnp.where(better, k, s)

    def back(t, s):
        w = jnp.where(s < 32, dec0_ref[t, :], dec1_ref[t, :])
        d = ((w >> (s & 31).astype(jnp.uint32)) & 1).astype(jnp.int32)
        return ((s & 31) << 1) | d

    # trailing overlap: no output, just walk the survivors back
    s = jax.lax.fori_loop(0, ov, lambda i, s: back(L - 1 - i, s), s)

    def out_byte(i, s):
        k = body // 8 - 1 - i
        byte = jnp.zeros_like(s)
        for j in range(7, -1, -1):            # step ov + 8k + j, LSB first
            byte = byte | ((s >> 5) << (7 - j))
            s = back(ov + 8 * k + j, s)
        out_ref[k, :] = byte.astype(jnp.uint8)
        return s

    jax.lax.fori_loop(0, body // 8, out_byte, s)


def make_viterbi_decoder_punctured(n_bits: int, rate: str,
                                   body: int | None = None,
                                   overlap: int = viterbi.DEFAULT_OVERLAP,
                                   interpret: bool = False):
    """Rate-specialized decoder: decode(state, coded) -> (state', bytes).

    coded : uint8 (n_coded,) punctured soft stream (0..15), straight out of
            the bit deinterleaver.
    state : the {'x','y','xm','ym'} (overlap,) pytree of ops.viterbi
            (implementation-independent checkpoints); overlap must equal
            ops.viterbi.effective_overlap(rate, ...).
    bytes : uint8 (n_bits // 8,) decoded info bytes (MSB-first), identical
            to bits_to_bytes of ops.viterbi.make_viterbi_decoder's output.
    interpret : run the kernel in the Pallas interpreter (CPU tests).
    """
    if body is None:
        body = viterbi.DEFAULT_BODY
    assert body % 8 == 0 and n_bits % 8 == 0, (body, n_bits)
    ov = overlap
    L = body + 2 * ov
    W = WINDOWS_PER_PROGRAM
    n_win = -(-n_bits // body)
    nw = -(-n_win // W) * W
    depunct = inner_coder.make_depuncture(n_bits, rate)

    call = pl.pallas_call(
        functools.partial(_acs_kernel, L=L, ov=ov, body=body),
        grid=(nw // W,),
        in_specs=[pl.BlockSpec((L, W), lambda i: (0, i))],
        out_specs=[pl.BlockSpec((body // 8, W), lambda i: (0, i)),
                   pl.BlockSpec((L, W), lambda i: (0, i)),
                   pl.BlockSpec((L, W), lambda i: (0, i))],
        out_shape=[jax.ShapeDtypeStruct((body // 8, nw), jnp.uint8),
                   jax.ShapeDtypeStruct((L, nw), jnp.uint32),
                   jax.ShapeDtypeStruct((L, nw), jnp.uint32)],
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        backend="triton",
        interpret=interpret,
        name="viterbi_acs",
    )

    def decode(state, coded):
        x, y, xm, ym = depunct(coded.astype(jnp.uint8))
        xm = jnp.broadcast_to(xm, x.shape).astype(jnp.uint8)
        ym = jnp.broadcast_to(ym, y.shape).astype(jnp.uint8)
        packed = pack_soft(x, y, xm, ym)
        tail = pack_soft(state["x"], state["y"], state["xm"], state["ym"])
        pad = jnp.zeros((nw * body + ov - n_bits,), jnp.uint16)
        f = jnp.concatenate([tail, packed, pad])          # (nw*body + 2ov,)
        # window w covers extended steps [w*body, w*body + L), time-major
        widx = (jnp.arange(L, dtype=jnp.int32)[:, None]
                + body * jnp.arange(nw, dtype=jnp.int32)[None, :])
        out, _, _ = call(f[widx])                          # (body//8, nw)
        out = out.T.reshape(-1)[: n_bits // 8]

        def carry(name, arr):
            return jnp.concatenate([state[name], arr])[n_bits: n_bits + ov]

        new_state = {"x": carry("x", x), "y": carry("y", y),
                     "xm": carry("xm", xm), "ym": carry("ym", ym)}
        return new_state, out

    return jax.jit(decode)
