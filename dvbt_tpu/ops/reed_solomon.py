"""Reed-Solomon RS(204,188,T=8) encode/decode (T2 / R9 in SURVEY.md §2).

Reference behavior: `lib/reed_solomon_enc_impl.cc`, `lib/reed_solomon_dec_impl.cc`,
shared GF core `lib/reed_solomon.cc` [unverified — mount empty]; spec:
EN300744 §4.3.2 (shortened RS(255,239), p(x)=0x11D, g(x)=prod(x+a^i), i<16).

Design (NOT a translation of the byte-serial LFSR/BM C++):

* Encode: RS parity is GF(2)-linear in the message bits, so the whole encoder
  is one binary matmul: ``parity = (msg_bits @ M) mod 2`` with the
  (1504, 128) matrix precomputed in tables.rs_encode_bitmatrix().  Batch of
  packets = batch dim of the matmul.
* Syndromes: same trick with a (1632, 128) matrix.
* Berlekamp-Massey: fixed 16-iteration masked form (data-dependent branches
  become jnp.where lane masks), batched over codewords — SURVEY.md §7 hard
  part 3.
* Chien + Forney: dense evaluation over all 204 positions as ONE mod-2
  matmul each (evaluation at fixed points is GF(2)-linear in the coefficient
  bits); Forney's division via bit-sliced Frobenius inversion.

All on-device GF(2^8) arithmetic is bit-sliced GF(2) linear algebra (see the
section below) instead of data-dependent log/exp table gathers, which were
slow on the chain's first platform (a table-gather form is an open A/B on
the GPU).  Every matmul here multiplies {0,1} operands and sums
far below 2^24 in f32, so it is exact at any precision, TF32 included.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import tables
from ..utils import bits as bitutils

RS_N, RS_K, RS_T = tables.RS_N, tables.RS_K, tables.RS_T


def _mod2_matmul(x_bits: jnp.ndarray, m: jnp.ndarray) -> jnp.ndarray:
    """(..., n) {0,1} @ (n, k) {0,1} -> (..., k) {0,1} via an f32 matmul."""
    acc = jnp.dot(
        x_bits.astype(jnp.bfloat16),
        m,
        preferred_element_type=jnp.float32,
    )
    return (acc.astype(jnp.int32) & 1).astype(jnp.uint8)


def make_rs_encoder():
    """Returns encode(msg) : uint8 (..., P, 188) -> (..., P, 204)."""
    M = tables.rs_encode_bitmatrix()  # numpy

    def encode(msg: jnp.ndarray) -> jnp.ndarray:
        msg_bits = bitutils.bytes_to_bits(msg)
        parity = bitutils.bits_to_bytes(
            _mod2_matmul(msg_bits, jnp.asarray(M, jnp.bfloat16)))
        return jnp.concatenate([msg, parity], axis=-1)

    return jax.jit(encode)


# --- bit-sliced GF(256) ------------------------------------------------------
#
# log/exp table lookups (the reference's GF core, SURVEY.md S3) are
# replaced by GF(2) linear algebra:
#   * mul by a CONSTANT is linear in the bits  -> (8, 8) matrix over GF(2)
#   * squaring is linear (Frobenius)           -> one fixed (8, 8) matrix
#   * general mul is bilinear                  -> (64, 8) matrix on the outer
#     product of the bit vectors
#   * inversion: x^254 = x^2 x^4 ... x^128     -> 7 squarings + 6 muls
# and polynomial evaluations at fixed points (Chien / Forney numerator /
# denominator) become ONE mod-2 matmul each.  XOR == sum mod 2,
# so every accumulation is an ordinary matmul followed by & 1.


def _gf_mul_int(a: int, b: int) -> int:
    exp_np, log_np = tables.gf_tables()
    if a == 0 or b == 0:
        return 0
    return int(exp_np[int(log_np[a]) + int(log_np[b])])


@functools.lru_cache(maxsize=None)
def _bit_matrices():
    """(SQ (8,8), BILIN (64,8)) uint8 over GF(2)."""
    sq = np.zeros((8, 8), np.uint8)
    bilin = np.zeros((8, 8, 8), np.uint8)
    for i in range(8):
        s = _gf_mul_int(1 << i, 1 << i)
        sq[i] = [(s >> k) & 1 for k in range(8)]
        for j in range(8):
            p = _gf_mul_int(1 << i, 1 << j)
            bilin[i, j] = [(p >> k) & 1 for k in range(8)]
    return sq, bilin.reshape(64, 8)


def _const_mul_matrix(c: int) -> np.ndarray:
    """(8, 8) M with bits(x) @ M = bits(c * x)."""
    m = np.zeros((8, 8), np.uint8)
    for i in range(8):
        p = _gf_mul_int(c, 1 << i)
        m[i] = [(p >> k) & 1 for k in range(8)]
    return m


_SH8 = np.arange(8, dtype=np.int32)


def _to_bits(x: jnp.ndarray) -> jnp.ndarray:
    """uint8/int32 bytes (...,) -> float32 bits (..., 8), LSB first."""
    return ((x[..., None].astype(jnp.int32) >> _SH8) & 1).astype(jnp.float32)


def _from_bits(b: jnp.ndarray) -> jnp.ndarray:
    """float32/int32 bits (..., 8) -> int32 bytes (...,)."""
    return (b.astype(jnp.int32) << _SH8).sum(axis=-1)


def _mod2(x: jnp.ndarray) -> jnp.ndarray:
    return (x.astype(jnp.int32) & 1).astype(jnp.float32)


def _bitmul(a_bits: jnp.ndarray, b_bits: jnp.ndarray) -> jnp.ndarray:
    """General GF(256) multiply on bit vectors: (..., 8) x (..., 8) -> (..., 8)."""
    _, bilin = _bit_matrices()
    shape = jnp.broadcast_shapes(a_bits.shape, b_bits.shape)
    outer = (a_bits[..., :, None] * b_bits[..., None, :]).reshape(
        *shape[:-1], 64)
    return _mod2(jnp.dot(outer, jnp.asarray(bilin, jnp.float32),
                         preferred_element_type=jnp.float32))


def _bitsq(a_bits: jnp.ndarray) -> jnp.ndarray:
    sq, _ = _bit_matrices()
    return _mod2(jnp.dot(a_bits, jnp.asarray(sq, jnp.float32),
                         preferred_element_type=jnp.float32))


def _bitinv(a_bits: jnp.ndarray) -> jnp.ndarray:
    """x^-1 = x^254 (maps 0 -> 0, which callers mask out)."""
    s = a_bits
    acc = None
    for _ in range(7):
        s = _bitsq(s)
        acc = s if acc is None else _bitmul(acc, s)
    return acc


# --- decoder ---------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _chien_power_tables():
    """Numpy power tables for dense Chien/Forney evaluation.

    Position i in the 204-byte packet corresponds to locator X_i = alpha^{203-i}.
      lam_pows[i, k]   = X_i^{-k}            (204, 9)   for Lambda(X^-1)
      omg_pows[i, k]   = X_i^{-k}            (204, 8)   for Omega(X^-1)
      dlam_pows[i, k]  = X_i^{-2k}           (204, 4)   for Lambda'(X^-1)
                         (odd-coeff formal derivative over GF(2))
      xk[i]            = X_i                  (204,)
    """
    exp, _ = tables.gf_tables()
    deg = 203 - np.arange(RS_N)
    lam = np.zeros((RS_N, RS_T + 1), dtype=np.int32)
    omg = np.zeros((RS_N, RS_T), dtype=np.int32)
    dlam = np.zeros((RS_N, 4), dtype=np.int32)
    for i in range(RS_N):
        d = int(deg[i])
        for k in range(RS_T + 1):
            lam[i, k] = exp[(-d * k) % 255]
        for k in range(RS_T):
            omg[i, k] = exp[(-d * k) % 255]
        for k in range(4):
            dlam[i, k] = exp[(-d * 2 * k) % 255]
    xk = np.array([exp[int(d) % 255] for d in deg], dtype=np.int32)
    return lam, omg, dlam, xk


def _shift1(p: jnp.ndarray) -> jnp.ndarray:
    """Multiply a bit-sliced polynomial (..., deg, 8) by x (static shift)."""
    z = jnp.zeros_like(p[..., :1, :])
    return jnp.concatenate([z, p[..., :-1, :]], axis=-2)


def _berlekamp_massey_bits(S_bits: jnp.ndarray):
    """Batched fixed-iteration BM, bit-sliced (no GF table gathers).

    S_bits (..., 16, 8) -> (Lambda bits (..., 9, 8), L (...,)).

    Instead of the textbook x^m * B shifted copy (a per-codeword dynamic
    shift = gather), the carried B is maintained ALREADY multiplied by x^m:
    every iteration shifts it once; a growth step restarts it from x * C.
    """
    batch = S_bits.shape[:-2]
    C = jnp.zeros(batch + (RS_T + 1, 8), jnp.float32).at[..., 0, 0].set(1)
    Bm = jnp.zeros_like(C).at[..., 1, 0].set(1)    # x^1 * B, B = 1
    binv = jnp.zeros(batch + (8,), jnp.float32).at[..., 0].set(1)  # 1/b, b=1
    L = jnp.zeros(batch, jnp.int32)
    zpad = jnp.zeros(batch + (RS_T, 8), jnp.float32)
    Spad = jnp.concatenate([zpad, S_bits], axis=-2)  # Spad[8 + t] = S_t
    Crev_axis = -2

    def step(carry, n):
        C, Bm, binv, L = carry
        # n is a python int (unrolled loop): the syndrome window is a
        # static slice and XLA fuses the whole straight-line iteration
        win = Spad[..., n: n + RS_T + 1, :]           # S_{n-8} .. S_n
        terms = _bitmul(jnp.flip(C, axis=Crev_axis), win)
        d = _mod2(terms.sum(axis=-2))                 # XOR = sum mod 2
        coef = _bitmul(d, binv)
        Cn = _mod2(C + _bitmul(coef[..., None, :], Bm))
        d_zero = d.sum(axis=-1) == 0
        grow = (~d_zero) & (2 * L <= n)
        C_out = jnp.where(d_zero[..., None, None], C, Cn)
        Bm_out = _shift1(jnp.where(grow[..., None, None], C, Bm))
        binv_out = jnp.where(grow[..., None], _bitinv(d), binv)
        L_out = jnp.where(grow, n + 1 - L, L)
        return C_out, Bm_out, binv_out, L_out

    carry = (C, Bm, binv, L)
    for n in range(2 * RS_T):
        carry = step(carry, n)
    C, Bm, binv, L = carry
    return C, L


@functools.lru_cache(maxsize=None)
def _eval_bitmatrices():
    """Mod-2 evaluation matrices over all 204 positions (uint8 numpy):

      M_lam (72, 1632):  bits(Lambda_0..8)     -> bits(Lambda(X_i^-1))
      M_xom (64, 1632):  bits(Omega_0..7)      -> bits(X_i * Omega(X_i^-1))
      M_dl  (32, 1632):  bits(Lambda_1,3,5,7)  -> bits(Lambda'(X_i^-1))

    Each 8x8 block is the linear map 'multiply by the fixed point power'
    (X_i factor folded into M_xom so Forney's numerator is one matmul).
    """
    lam_p, omg_p, dlam_p, xk = _chien_power_tables()
    m_lam = np.zeros(((RS_T + 1) * 8, RS_N * 8), np.uint8)
    m_xom = np.zeros((RS_T * 8, RS_N * 8), np.uint8)
    m_dl = np.zeros((4 * 8, RS_N * 8), np.uint8)
    for pos in range(RS_N):
        c = slice(8 * pos, 8 * pos + 8)
        for k in range(RS_T + 1):
            m_lam[8 * k: 8 * k + 8, c] = _const_mul_matrix(int(lam_p[pos, k]))
        for k in range(RS_T):
            m_xom[8 * k: 8 * k + 8, c] = _const_mul_matrix(
                _gf_mul_int(int(xk[pos]), int(omg_p[pos, k])))
        for k in range(4):
            m_dl[8 * k: 8 * k + 8, c] = _const_mul_matrix(int(dlam_p[pos, k]))
    return m_lam, m_xom, m_dl


def make_rs_decoder():
    """Returns decode(cw) for uint8 (..., P, 204):

    -> (msg (..., P, 188) uint8,
        n_corrected (..., P) int32,
        uncorrectable (..., P) bool)

    Observability outputs mirror SURVEY.md §5.5 (per-block counters).
    """
    Msyn_np = tables.rs_syndrome_bitmatrix()
    m_lam_np, m_xom_np, m_dl_np = _eval_bitmatrices()

    def _evalmat(coef_bits: jnp.ndarray, m_np: np.ndarray) -> jnp.ndarray:
        """bit-sliced coeffs (..., deg, 8) @ eval matrix -> (..., 204, 8)."""
        flat = coef_bits.reshape(*coef_bits.shape[:-2], -1)
        out = jnp.dot(flat, jnp.asarray(m_np, jnp.float32),
                      preferred_element_type=jnp.float32)
        return _mod2(out).reshape(*coef_bits.shape[:-2], RS_N, 8)

    def decode(cw: jnp.ndarray):
        Msyn = jnp.asarray(Msyn_np, jnp.bfloat16)
        cw_bits = bitutils.bytes_to_bits(cw)
        syn_bytes = bitutils.bits_to_bytes(_mod2_matmul(cw_bits, Msyn))
        S = syn_bytes.astype(jnp.int32)  # (..., 16), S[0]=r(alpha^0)
        no_err = jnp.all(S == 0, axis=-1)
        S_bits = _to_bits(S)             # (..., 16, 8)

        Lam_bits, L = _berlekamp_massey_bits(S_bits)  # (..., 9, 8)

        # Omega = S(x) * Lambda(x) mod x^8: 9 shifted bit-sliced muls
        om = jnp.zeros(S_bits.shape[:-2] + (RS_T, 8), jnp.float32)
        Shead = S_bits[..., :RS_T, :]
        for i in range(RS_T + 1):
            shifted = Shead if i == 0 else jnp.concatenate(
                [jnp.zeros_like(Shead[..., :i, :]), Shead[..., :RS_T - i, :]],
                axis=-2)
            om = _mod2(om + _bitmul(Lam_bits[..., i: i + 1, :], shifted))

        lam_at = _evalmat(Lam_bits, m_lam_np)          # (..., 204, 8)
        xom_at = _evalmat(om, m_xom_np)
        dl_at = _evalmat(Lam_bits[..., 1::2, :], m_dl_np)

        err_mask = lam_at.sum(axis=-1) == 0            # Chien roots
        dl_nz = dl_at.sum(axis=-1) > 0
        ev_bits = _bitmul(xom_at, _bitinv(dl_at))      # Forney
        ev = _from_bits(ev_bits)
        ev = jnp.where(err_mask & dl_nz, ev, 0)

        corrected = cw.astype(jnp.int32) ^ ev
        corrected = jnp.where(no_err[..., None], cw.astype(jnp.int32),
                              corrected)

        n_roots = jnp.sum(err_mask.astype(jnp.int32), axis=-1)
        n_corr = jnp.where(no_err, 0, n_roots)
        uncorrectable = (~no_err) & ((n_roots != L) | (L > RS_T))
        return corrected[..., :RS_K].astype(jnp.uint8), n_corr, uncorrectable

    return jax.jit(decode)
