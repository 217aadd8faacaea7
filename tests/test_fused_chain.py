"""Whole-receiver parity of the Pallas Viterbi kernel (interpreter mode on
the CPU) against the jnp scan, through the real make_receiver graph: TS
bytes, RS counters and every piece of carried state must be identical.
The input is noisy and soft-demapped so that the decoder has errors to
correct, in a plain and a hierarchical (two-chain) mode."""

import jax
import numpy as np
import pytest

import jax.numpy as jnp

from dvbt_tpu.io import ts as tsio
from dvbt_tpu.mode import MODE_2K_QPSK, DvbtMode
from dvbt_tpu.models import channel, rx as rxm, tx as txm


def _same_state(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if np.issubdtype(a.dtype, np.integer) or a.dtype == np.bool_:
        np.testing.assert_array_equal(a, b)
    else:
        # float leaves (the channel estimator's pilot history): the two
        # programs may fuse the estimator differently -> last-ulp changes
        np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.mark.parametrize("mode,snr_db", [
    (MODE_2K_QPSK, 4.0),
    (DvbtMode("2k", "16qam", "3/4", "1/8", alpha=2, code_rate_lp="1/2"),
     9.0),
])
def test_receiver_kernel_matches_jnp(mode, snr_db):
    tx, n_pk, _ = txm.make_transmitter(mode)
    rx_j, _, _ = rxm.make_receiver(mode, viterbi_impl="jnp", demap="soft")
    rx_k, _, _ = rxm.make_receiver(mode, viterbi_impl="pallas-interpret",
                                   demap="soft")
    tst = txm.init_tx_state(mode)
    rst_j = rst_k = rxm.init_rx_state(mode)
    corrected = 0
    for blk in range(2):
        if mode.hierarchical:
            pk = tuple(jnp.asarray(tsio.make_ts_packets(n, seed=blk + 10 * s))
                       for s, n in enumerate(n_pk))
        else:
            pk = jnp.asarray(tsio.make_ts_packets(n_pk, seed=blk))
        tst, iq = tx(tst, pk)
        iq = channel.awgn(jax.random.PRNGKey(blk), iq, snr_db)
        rst_j, ts_j, m_j = rx_j(rst_j, iq)
        rst_k, ts_k, m_k = rx_k(rst_k, iq)
        for a, b in zip(jax.tree.leaves(ts_j), jax.tree.leaves(ts_k)):
            assert np.array_equal(np.asarray(a), np.asarray(b)), blk
        for key in m_j:
            if "rs_" in key:
                assert np.array_equal(np.asarray(m_j[key]),
                                      np.asarray(m_k[key])), (blk, key)
        corrected += int(np.asarray(m_j["rs_corrected"]).sum())
        jax.tree.map(_same_state, rst_j, rst_k)
    assert corrected > 0     # the SNR leaves work for the decoders
