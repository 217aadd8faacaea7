"""Static permutations along the carrier/cell axis as major-axis row takes.

A gather along the MAJOR axis (row take) is a plain vectorized copy, where a
minor-axis gather with per-row indices was scalar code on the chain's first
platform (not re-measured on the GPU).  DVB-T's per-symbol
permutations depend only on the symbol index mod 4 (scattered-pilot phase ×
even/odd interleave parity), so every (68, K) -> (68, P) permutation is done
phase-major: reshape to (17, 4, K), move the gathered axis to the front, do
4 row takes with per-phase indices, and move back.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

PHASES = 4


def make_row_take4(idx4: np.ndarray):
    """idx4 (4, P): returns f(x): (..., 68, K) -> (..., 68, P) with
    out[..., l, j] = x[..., l, idx4[l % 4, j]]."""
    idx4 = np.asarray(idx4)
    assert idx4.ndim == 2 and idx4.shape[0] == PHASES

    def take(x: jnp.ndarray) -> jnp.ndarray:
        *b, S, K = x.shape
        assert S % PHASES == 0
        rows = S // PHASES
        x4 = x.reshape(*b, rows, PHASES, K)
        # (4, K, *b, rows): gathered axis major
        xm = jnp.moveaxis(jnp.moveaxis(x4, -2, 0), -1, 1)
        outs = [xm[p][jnp.asarray(idx4[p])] for p in range(PHASES)]
        om = jnp.stack(outs, axis=0)              # (4, P, *b, rows)
        out = jnp.moveaxis(jnp.moveaxis(om, 1, -1), 0, -2)
        return out.reshape(*b, S, idx4.shape[1])

    return take
