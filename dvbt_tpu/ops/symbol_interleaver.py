"""Symbol inner interleaver H(q) (T6 / R5).

Reference behavior: `lib/symbol_inner_interleaver_impl.cc` [unverified —
mount empty]; spec: EN300744 §4.3.4.2.

Design: the LFSR-generated H(q) permutation and its inverse are
precomputed; a frame of 68 symbols gets a static (68, n_payload) gather index
matrix (row parity selects H vs H^-1 per the even/odd symbol rule), so the
whole frame interleaves in one take_along_axis.  Stateless when processing
frame-aligned blocks (symbol parity is positional).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..mode import SYMBOLS_PER_FRAME, DvbtMode


def _perm_pair(mode: DvbtMode, deinterleave: bool) -> np.ndarray:
    """(2, n_payload) int32: row 0 = even-symbol gather, row 1 = odd."""
    h = mode.symbol_interleaver_perm().astype(np.int64)
    hinv = np.empty_like(h)
    hinv[h] = np.arange(len(h), dtype=np.int64)
    # TX even symbols: out[H[q]] = in[q]  -> gather with Hinv
    # TX odd  symbols: out[q]    = in[H[q]] -> gather with H
    even, odd = (h, hinv) if deinterleave else (hinv, h)
    return np.stack([even, odd]).astype(np.int32)


def make_symbol_interleaver(mode: DvbtMode, n_sym: int = SYMBOLS_PER_FRAME,
                            deinterleave: bool = False):
    """Returns apply(cells): (..., n_sym, n_payload) -> same shape.

    ``n_sym`` must cover frame-aligned data (row 0 = symbol l=0 of a frame)
    so that the even/odd rule lands on the right rows.
    """
    assert n_sym % 2 == 0 or n_sym == 1
    pair = _perm_pair(mode, deinterleave)

    def apply(cells: jnp.ndarray) -> jnp.ndarray:
        # (n_sym, C) index by tiling the tiny (2, C) parity pair on device
        p = jnp.asarray(pair)
        idx = jnp.tile(p, (max(n_sym // 2, 1), 1))[:n_sym]
        bidx = jnp.broadcast_to(idx, cells.shape)
        return jnp.take_along_axis(cells, bidx, axis=-1)

    return jax.jit(apply)
