"""TPS auto mode detection (VERDICT round-1 item 3; reference R3 capability).

Feeds IQ of a mode the receiver was NOT told (only '2k') and requires
byte-exact TS out, plus guard detection from raw samples.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dvbt_tpu.io import ts as tsio
from dvbt_tpu.mode import DvbtMode
from dvbt_tpu.models import channel, tx as txm
from dvbt_tpu.models.auto import (AutoStreamingReceiver, DetectionError,
                                  detect_guard, detect_mode)

DELAY = 11


def _tx_stream(mode, blocks, seed=3):
    tx, n_pk, _ = txm.make_transmitter(mode)
    st = txm.init_tx_state(mode)
    chunks = []
    if mode.hierarchical:
        hp = tsio.make_ts_packets(n_pk[0] * blocks, seed=seed)
        lp = tsio.make_ts_packets(n_pk[1] * blocks, seed=seed + 1)
        for b in range(blocks):
            st, iq = tx(st, (hp[b * n_pk[0]:(b + 1) * n_pk[0]],
                             lp[b * n_pk[1]:(b + 1) * n_pk[1]]))
            chunks.append(np.asarray(iq))
        return hp, n_pk[0], np.concatenate(chunks)
    packets = tsio.make_ts_packets(n_pk * blocks, seed=seed)
    for b in range(blocks):
        st, iq = tx(st, packets[b * n_pk:(b + 1) * n_pk])
        chunks.append(np.asarray(iq))
    return packets, n_pk, np.concatenate(chunks)


def test_auto_receiver_2k_64qam_23():
    mode = DvbtMode("2k", "64qam", "2/3", "1/32")
    packets, n_pk, stream = _tx_stream(mode, 6)
    dev = channel.apply_cfo(jnp.asarray(stream), 0.8, mode.fft_len)
    dev = channel.awgn(jax.random.PRNGKey(0), dev, 30.0)
    stream = np.asarray(dev)[777:]

    arx = AutoStreamingReceiver("2k")
    reports = arx.feed(stream)
    m = arx.detected_mode
    assert (m.constellation, m.code_rate, m.guard, m.alpha) == \
        ("64qam", "2/3", "1/32", 0)
    assert arx.detect_info["bch_ok"]

    out = np.concatenate([r.packets for r in reports])
    k0 = (reports[0].stream_offset + 777 + 8) // mode.samples_per_block
    want, got = packets[k0 * n_pk:], out[DELAY:]
    n = min(len(got), len(want))
    assert n > 2 * n_pk
    assert not (got[:n] != want[:n]).any()


def test_detect_guard_all():
    for guard in ("1/32", "1/8"):
        mode = DvbtMode("2k", "qpsk", "1/2", guard)
        _, _, stream = _tx_stream(mode, 1)
        best, scores = detect_guard(stream, "2k")
        assert best == guard, scores
        others = [v for k, v in scores.items() if k != guard]
        assert scores[guard] > 2 * max(others), scores


def test_detect_mode_hierarchical():
    mode = DvbtMode("2k", "16qam", "2/3", "1/16", alpha=2, code_rate_lp="3/4")
    _, _, stream = _tx_stream(mode, 2)
    det, info = detect_mode(stream, "2k")
    assert det == mode
    assert info["bch_ok"]


def test_detect_mode_rejects_noise():
    rng = np.random.default_rng(0)
    noise = (rng.standard_normal(600_000)
             + 1j * rng.standard_normal(600_000)).astype(np.complex64)
    with pytest.raises(DetectionError):
        detect_mode(noise, "2k", guard="1/32")
