"""Bit-wise inner interleaver (T5 / R6): demux to v substreams + 126-bit
block interleavers, fused with cell packing.

Reference behavior: `lib/bit_inner_interleaver_impl.cc` [unverified — mount
empty]; spec: EN300744 §4.3.4.1.

Design: demux, the six cyclic block interleavers, and the bits->cell
packing compose into ONE static permutation that is identical for every
126-cell block.  Rather than a minor-axis gather/scatter (slow on the
chain's first platform; not re-measured on the GPU), the per-block
permutation is materialized as a small one-hot matrix and applied as a
batched (..., 126v) @ (126v, ·) bf16 matmul; the cell packing weights
(2^(v-1-j)) fold into the same matrix, so interleave+pack is one matmul.
All values (bits, 4-bit soft metrics, weights up to 32) are exactly
representable in bf16 and accumulate in f32, so the result is exact at any
matmul precision (TF32 included).  Stateless.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from .. import tables
from ..mode import DvbtMode

# operand dtype for the permutation matmuls: bf16 (default) or int8 (every
# value here — bits, 4-bit soft metrics, pack weights <= 32, cells <= 63,
# scale 15 — is exactly representable in int8 with int32 accumulation).
# Resolved once at import; A/B-measured on the card before changing the
# default.
ILV_DTYPE = os.environ.get("DVBT_ILV", "bf16")


def _perm_matmul(x, M_np, dtype=None):
    """x (…, K) small exact ints -> x @ M, through the configured operand
    dtype; result float32/int32 per the path, exact either way."""
    d = ILV_DTYPE if dtype is None else dtype
    if d == "int8":
        lhs = x.astype(jnp.int8)
        rhs = jnp.asarray(M_np.astype(np.int8))
        return jnp.matmul(lhs, rhs, preferred_element_type=jnp.int32)
    lhs = x.astype(jnp.bfloat16)
    rhs = jnp.asarray(M_np.astype(np.float32), jnp.bfloat16)
    return jnp.matmul(lhs, rhs, preferred_element_type=jnp.float32)


def _symbol_indices(mode: DvbtMode) -> np.ndarray:
    """(n_payload, v) source bit index within one symbol's coded-bit block
    (the reference permutation; kept as the test oracle for the matmul
    forms below)."""
    blk = tables.bit_interleaver_indices(mode.v, mode.hierarchical)  # (126, v)
    n_blocks = mode.n_payload // tables.BIT_ILV_BLOCK
    per_block = tables.BIT_ILV_BLOCK * mode.v
    out = np.concatenate(
        [blk.astype(np.int64) + b * per_block for b in range(n_blocks)], axis=0
    )
    return out


def _block_dims(mode: DvbtMode):
    blk = tables.bit_interleaver_indices(mode.v, mode.hierarchical)
    n_blocks = mode.n_payload // tables.BIT_ILV_BLOCK
    nbb = tables.BIT_ILV_BLOCK * mode.v          # coded bits per block
    return blk, n_blocks, nbb


def make_bit_interleaver(mode: DvbtMode, dtype: str | None = None):
    """Returns interleave(bits) : uint8 (..., n_sym, n_payload*v)
    -> int32 cells (..., n_sym, n_payload) with y0 as cell MSB."""
    blk, n_blocks, nbb = _block_dims(mode)
    v = mode.v
    # M[k, c] = 2^(v-1-j) where the interleaver reads coded bit k into bit
    # j of cell c: interleave + pack as one (nbb, 126) matmul per block
    M = np.zeros((nbb, tables.BIT_ILV_BLOCK), np.float32)
    for c in range(tables.BIT_ILV_BLOCK):
        for j in range(v):
            M[blk[c, j], c] = float(1 << (v - 1 - j))

    def interleave(b: jnp.ndarray) -> jnp.ndarray:
        x = b.reshape(*b.shape[:-1], n_blocks, nbb)
        cells = _perm_matmul(x, M, dtype)
        return cells.astype(jnp.int32).reshape(
            *b.shape[:-1], mode.n_payload)

    return jax.jit(interleave)


def _deint_matrix(mode: DvbtMode, scale: int) -> np.ndarray:
    """(nbb, nbb) one-hot: row c*v+j (bit j of in-block cell c) -> column
    blk[c, j] (coded-stream position), times `scale`."""
    blk, _, nbb = _block_dims(mode)
    v = mode.v
    D = np.zeros((nbb, nbb), np.float32)
    for c in range(tables.BIT_ILV_BLOCK):
        for j in range(v):
            D[c * v + j, blk[c, j]] = float(scale)
    return D


def make_soft_bit_deinterleaver(mode: DvbtMode, dtype: str | None = None):
    """Soft-metric variant: (..., n_sym, n_payload, v) per-bit soft values
    (cell order, bit e = y_e) -> (..., n_sym, n_payload*v) coded-stream
    order — the same per-block permutation as the hard path, applied to
    values."""
    _, n_blocks, nbb = _block_dims(mode)
    D = _deint_matrix(mode, 1)
    n_bits = mode.n_payload * mode.v

    def deinterleave(soft: jnp.ndarray) -> jnp.ndarray:
        x = soft.reshape(*soft.shape[:-2], n_blocks, nbb)
        out = _perm_matmul(x, D, dtype)
        return out.astype(jnp.uint8).reshape(*soft.shape[:-2], n_bits)

    return jax.jit(deinterleave)


def make_bit_deinterleaver(mode: DvbtMode, scale: int = 1,
                           dtype: str | None = None):
    """Returns deinterleave(cells) : int32 (..., n_sym, n_payload)
    -> uint8 bits*scale (..., n_sym, n_payload*v).  `scale` folds the
    hard-decision -> saturated-soft-metric multiply ({0,1} -> {0,15}) into
    the permutation matmul for free."""
    sh = np.arange(mode.v - 1, -1, -1, dtype=np.int32)
    _, n_blocks, nbb = _block_dims(mode)
    D = _deint_matrix(mode, scale)
    n_bits = mode.n_payload * mode.v

    def deinterleave(cells: jnp.ndarray) -> jnp.ndarray:
        cell_bits = ((cells[..., :, None] >> sh) & 1)
        x = cell_bits.reshape(*cells.shape[:-1], n_blocks, nbb)
        out = _perm_matmul(x, D, dtype)
        return out.astype(jnp.uint8).reshape(*cells.shape[:-1], n_bits)

    return jax.jit(deinterleave)
