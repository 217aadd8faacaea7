"""QAM mapper / hard demapper (T7 / R4).

Reference behavior: `lib/dvbt_map_impl.cc`, `lib/dvbt_demap_impl.cc`
[unverified — mount empty]; spec: EN300744 §4.3.5 Fig 9 + normalization
table (uniform and hierarchical alpha in {1,2,4}).

Design: mapping is a one-hot matmul against separable per-axis level tables
(2^v complex points indexed by cell value).  Hard demapping is per-axis
scaled rounding (make_demapper); the soft demapper scores every point with
the inner product 2*Re(y c̄) - |c|^2, ONE real (N,2)x(2,2^v) matmul.
Matches the reference's hard-decision nearest-point
rule exactly (SURVEY.md §7 hard part 6) and extends to the hierarchical
(non-square) constellations for free.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..mode import DvbtMode


def make_mapper(mode: DvbtMode):
    """Mapping as two tiny one-hot f32 matmuls (I and Q separately).

    DVB-T constellations are separable: the I coordinate depends only on the
    even-position bits and Q on the odd ones [EN300744 Fig 9], so the 2^v
    table splits into two 2^(v/2) level tables, applied as one-hot matmuls
    instead of a data-dependent table gather (slow on the chain's first
    platform; not re-measured on the GPU).
    """
    table = mode.constellation_table().astype(np.complex64)
    v = mode.v
    h = v // 2
    # split cell -> (i_idx, q_idx): i bits are y0,y2,... (MSB first)
    cells = np.arange(2 ** v)
    i_idx = np.zeros(2 ** v, np.int64)
    q_idx = np.zeros(2 ** v, np.int64)
    for b in range(h):
        i_idx |= ((cells >> (v - 1 - 2 * b)) & 1) << (h - 1 - b)
        q_idx |= ((cells >> (v - 2 - 2 * b)) & 1) << (h - 1 - b)
    i_levels = np.zeros(2 ** h, np.float32)
    q_levels = np.zeros(2 ** h, np.float32)
    i_levels[i_idx] = table.real
    q_levels[q_idx] = table.imag
    sep = (np.allclose(i_levels[i_idx], table.real)
           and np.allclose(q_levels[q_idx], table.imag))
    assert sep, "constellation not separable?"

    def qam_map(cells_in: jnp.ndarray) -> jnp.ndarray:
        """int32 cells (...,) -> complex64 points (...,)."""
        c = cells_in.astype(jnp.int32)
        ii = jnp.zeros_like(c)
        qq = jnp.zeros_like(c)
        for b in range(h):
            ii = ii | (((c >> (v - 1 - 2 * b)) & 1) << (h - 1 - b))
            qq = qq | (((c >> (v - 2 - 2 * b)) & 1) << (h - 1 - b))
        oh_i = (ii[..., None] == jnp.arange(2 ** h)).astype(jnp.float32)
        oh_q = (qq[..., None] == jnp.arange(2 ** h)).astype(jnp.float32)
        # HIGHEST: a GPU may run a float32 product in TF32, which would
        # round the constellation levels
        re = jnp.dot(oh_i, jnp.asarray(i_levels),
                     precision=jax.lax.Precision.HIGHEST,
                     preferred_element_type=jnp.float32)
        im = jnp.dot(oh_q, jnp.asarray(q_levels),
                     precision=jax.lax.Precision.HIGHEST,
                     preferred_element_type=jnp.float32)
        return (re + 1j * im).astype(jnp.complex64)

    return jax.jit(qam_map)


def make_soft_demapper(mode: DvbtMode):
    """Max-log-MAP per-bit soft demapper, 4-bit quantized, CSI-weighted.

    Returns soft_demap(y, csi=None): complex64 (...,) -> uint8 (..., v)
    soft metrics in [0, 15] (7/8 = erasure, 15 = confident 1) scaled so a
    clean hard decision saturates.  ``csi`` (optional, broadcastable
    float32) scales the LLRs BEFORE quantization: after zero-forcing
    equalization the noise on carrier k is amplified by 1/|H(k)|², so the
    true LLR is the equalized-domain one times |H(k)|² — without this
    weighting, faded carriers produce confident-wrong metrics and the
    soft chain measured ~1 dB WORSE than hard on the Rayleigh P1 profile
    (round 4).  csi=None (or 1) reproduces the unweighted metrics
    bit-exactly, so flat-channel byte-exactness is untouched.

    This is the beyond-parity option of SURVEY.md §7 hard part 6 (the
    reference chain is hard-decision only); feeding these to the soft
    Viterbi buys ~2 dB over the hard chain on AWGN and keeps a clear
    margin on fading profiles.
    """
    c = mode.constellation_table().astype(np.complex64)
    v = mode.v
    pts = np.stack([c.real, c.imag], axis=0).astype(np.float32)
    half_norm = (np.abs(c) ** 2 / 2).astype(np.float32)
    # min squared distance between points differing in bit b, for scaling
    d2 = np.abs(c[:, None] - c[None, :]) ** 2
    np.fill_diagonal(d2, np.inf)
    dmin2 = float(d2.min())
    bit_is1 = [((np.arange(1 << v) >> (v - 1 - b)) & 1).astype(bool)
               for b in range(v)]

    def soft_demap(y: jnp.ndarray, csi: jnp.ndarray | None = None
                   ) -> jnp.ndarray:
        yr = jnp.stack([y.real, y.imag], axis=-1).astype(jnp.float32)
        # score_c = 2*Re(y conj(c)) - |c|^2 = |y|^2 - |y - c|^2
        # HIGHEST: TF32 would perturb the LLRs (soft decode != CPU's)
        score = jnp.dot(yr, pts, precision=jax.lax.Precision.HIGHEST,
                        preferred_element_type=jnp.float32) \
            - half_norm                                    # (..., 2^v)
        outs = []
        for b in range(v):
            m1 = jnp.max(jnp.where(bit_is1[b], score, -jnp.inf), axis=-1)
            m0 = jnp.max(jnp.where(bit_is1[b], -jnp.inf, score), axis=-1)
            llr = m1 - m0  # = d0^2 - d1^2
            if csi is not None:
                llr = llr * csi
            s = jnp.clip(jnp.round(7.5 + 7.5 * llr / dmin2), 0.0, 15.0)
            outs.append(s.astype(jnp.uint8))
        return jnp.stack(outs, axis=-1)                    # (..., v)

    return jax.jit(soft_demap)


def make_demapper(mode: DvbtMode):
    """Hard demap by per-axis scaled rounding — the reference's own scheme
    (SURVEY.md R4 "scaled integer rounding per axis").

    DVB-T axis levels are ±(α + 2k), k = 0..2^(v/2-1)-1 [EN300744 §4.3.5],
    so the nearest level index is clip(round((|z| − α)/2)) after
    de-normalizing z = y·scale, and the Gray bit pattern per (sign, index)
    comes from a tiny host-derived table applied as a handful of selects.
    This replaces a 2^v-way score argmax whose (..., 2^v) f32 plane was the
    demap stage's HBM cost, and agrees with nearest-point on everything but
    exact decision-boundary midpoints (measure zero under noise).  Midpoint
    ties resolve DETERMINISTICALLY by jnp.round's half-to-even rule (toward
    the even level index, i.e. alternating inward/outward along the axis),
    so replays of the same capture are always bit-identical — but archived
    outputs of the old argmax demapper may differ at exactly those inputs
    (ADVICE r3; tests/test_fused_ops.py pins the tie-break).
    """
    c = mode.constellation_table().astype(np.complex64)
    v = mode.v
    h = v // 2
    m = 1 << (h - 1)                       # levels per half-axis
    alpha = mode.alpha_eff
    scale = (alpha + 2 * (m - 1)) / np.max(c.real)   # de-normalization
    # bit-index tables per axis (same split as make_mapper)
    cells = np.arange(2 ** v)
    i_idx = np.zeros(2 ** v, np.int64)
    q_idx = np.zeros(2 ** v, np.int64)
    for b in range(h):
        i_idx |= ((cells >> (v - 1 - 2 * b)) & 1) << (h - 1 - b)
        q_idx |= ((cells >> (v - 2 - 2 * b)) & 1) << (h - 1 - b)
    i_levels = np.zeros(2 ** h, np.float32)
    q_levels = np.zeros(2 ** h, np.float32)
    i_levels[i_idx] = c.real
    q_levels[q_idx] = c.imag
    # (sign, |level| rank) -> cell-value contribution of that axis' bits
    i_contrib = np.zeros(2 * m, np.int32)
    q_contrib = np.zeros(2 * m, np.int32)
    for s_, sign in ((0, 1.0), (1, -1.0)):
        for ka in range(m):
            lvl = sign * (alpha + 2 * ka) / scale
            bi = int(np.argmin(np.abs(i_levels - lvl)))
            bq = int(np.argmin(np.abs(q_levels - lvl)))
            assert abs(i_levels[bi] - lvl) < 1e-5 * max(1.0, abs(lvl))
            assert abs(q_levels[bq] - lvl) < 1e-5 * max(1.0, abs(lvl))
            for b in range(h):
                i_contrib[s_ * m + ka] |= (
                    (bi >> (h - 1 - b)) & 1) << (v - 1 - 2 * b)
                q_contrib[s_ * m + ka] |= (
                    (bq >> (h - 1 - b)) & 1) << (v - 2 - 2 * b)

    def _axis(z, contrib):
        if m == 1:
            k = (z < 0).astype(jnp.int32)
        else:
            ka = jnp.clip(jnp.round((jnp.abs(z) * scale - alpha) * 0.5),
                          0, m - 1).astype(jnp.int32)
            k = ka + m * (z < 0)
        out = jnp.zeros(z.shape, jnp.int32)
        for j in range(2 * m):
            if contrib[j]:
                out = jnp.where(k == j, jnp.int32(contrib[j]), out)
        return out

    def qam_demap(y: jnp.ndarray) -> jnp.ndarray:
        """complex64 (...,) -> int32 hard-decision cell values (...,)."""
        return _axis(y.real, i_contrib) | _axis(y.imag, q_contrib)

    return jax.jit(qam_demap)
