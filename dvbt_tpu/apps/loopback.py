"""dvbt-loopback: TX -> impaired channel -> RX in one process; prints a JSON
report.  The analog of running the reference's TX and RX example
flowgraphs back-to-back (SURVEY.md §4 'integration tests = example apps')."""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ..io import ts as tsio
from ..models import channel, tx as txm
from ..models.loopback import StreamingReceiver
from . import common

DELAY_PACKETS = 11  # outer (de)interleaver stream delay


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    common.add_mode_args(p)
    p.add_argument("--blocks", type=int, default=8)
    p.add_argument("--snr", type=float, default=None, help="AWGN SNR in dB")
    p.add_argument("--cfo", type=float, default=0.0,
                   help="carrier offset in subcarrier spacings")
    p.add_argument("--offset", type=int, default=0,
                   help="drop this many leading samples (timing offset)")
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    mode = common.mode_from_args(a)

    import jax
    import jax.numpy as jnp

    tx, n_pk, n_samp = txm.make_transmitter(mode)
    packets = tsio.make_ts_packets(n_pk * a.blocks, seed=a.seed)
    state = txm.init_tx_state(mode)
    chunks = []
    t0 = time.time()
    for b in range(a.blocks):
        state, iq = tx(state, jnp.asarray(packets[b * n_pk:(b + 1) * n_pk]))
        chunks.append(np.asarray(iq))
    stream = np.concatenate(chunks)
    tx_s = time.time() - t0

    if a.cfo or a.snr is not None:
        dev = jnp.asarray(stream)
        if a.cfo:
            dev = channel.apply_cfo(dev, a.cfo, mode.fft_len)
        if a.snr is not None:
            dev = channel.awgn(jax.random.PRNGKey(a.seed), dev, a.snr)
        stream = np.asarray(dev)
    stream = stream[a.offset:]

    srx = StreamingReceiver(mode)
    t0 = time.time()
    reports = srx.feed(stream)
    rx_s = time.time() - t0

    out = np.concatenate([r.packets for r in reports]) if reports else \
        np.zeros((0, 188), np.uint8)
    # align decoded stream to TX packets via the header counter in bytes 1:3
    n_err_bytes = n_cmp = 0
    if len(out) > DELAY_PACKETS:
        from ..ops import sync as syncop
        k0 = ((reports[0].stream_offset + a.offset + syncop.DEFAULT_BACKOFF)
              // mode.samples_per_block)
        want = packets[k0 * n_pk:]
        got = out[DELAY_PACKETS:]
        n = min(len(got), len(want))
        n_err_bytes = int((got[:n] != want[:n]).sum())
        n_cmp = n * 188
    rs_bad = int(sum(r.rs_uncorrectable.sum() for r in reports))
    rs_corr = int(sum(r.rs_corrected.sum() for r in reports))
    report = {
        "mode": f"{mode.transmission}_{mode.constellation}_{mode.code_rate}"
                f"_gi{mode.guard}",
        "blocks_tx": a.blocks, "blocks_rx": len(reports),
        "snr_db": a.snr, "cfo": a.cfo,
        "packets": len(out), "rs_corrected": rs_corr,
        "rs_uncorrectable": rs_bad,
        "byte_errors": n_err_bytes, "bytes_compared": n_cmp,
        "byte_error_rate": n_err_bytes / n_cmp if n_cmp else None,
        "tx_msps": len(stream) / tx_s / 1e6,
        "rx_msps": len(stream) / rx_s / 1e6,
        "useful_bitrate_mbps": mode.useful_bitrate / 1e6,
    }
    print(json.dumps(report))
    return 0 if (n_cmp and n_err_bytes == 0) or a.snr is not None else 1


if __name__ == "__main__":
    raise SystemExit(main())
