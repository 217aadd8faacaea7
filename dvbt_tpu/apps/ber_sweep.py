"""dvbt-ber-sweep: BER / packet-error-rate vs SNR over the TX->AWGN->RX
chain — the integration metric of SURVEY.md §4 (BER parity vs the reference
at fixed SNR; the reference chain is hard-decision, and so is ours).

Prints one JSON line per SNR point:
  {"snr_db":..., "ber_post_viterbi":..., "ber_post_rs":..., "per":...}

post-Viterbi BER is measured on the 204-byte RS codewords (pre-RS bytes),
post-RS BER on the descrambled TS bytes.
"""

from __future__ import annotations

import argparse
import functools
import json

import numpy as np

from ..io import ts as tsio
from ..models import channel, rx as rxm, tx as txm
from . import common

DELAY_PACKETS = 11


@functools.lru_cache(maxsize=8)
def _build(mode, demap):
    """One compiled tx/rx pair per (mode, demap) — a sweep re-uses the jit
    cache across its SNR points instead of re-lowering per point."""
    tx, n_pk, _ = txm.make_transmitter(mode)
    rx, _, _ = rxm.make_receiver(mode, demap=demap, measure_pre_rs=True)
    return tx, rx, n_pk


def run_point(mode, snr_db: float, n_blocks: int, seed: int = 0,
              demap: str = "hard", profile: str | None = None):
    """One BER point over TX -> [Annex B profile] -> AWGN -> RX.

    profile: None (AWGN only), "F1" (fixed/Ricean) or "P1"
    (portable/Rayleigh) — channel.annex_b_taps.
    """
    import jax
    import jax.numpy as jnp

    tx, rx, n_pk = _build(mode, demap)
    hier = mode.hierarchical
    n_pk_hp, n_pk_lp = n_pk if hier else (n_pk, 0)
    packets = tsio.make_ts_packets(n_pk_hp * n_blocks, seed=seed)
    packets_lp = (tsio.make_ts_packets(n_pk_lp * n_blocks, seed=seed + 100)
                  if hier else None)
    tst, rst = txm.init_tx_state(mode), rxm.init_rx_state(mode)
    key = jax.random.PRNGKey(seed + 1)
    taps = channel.annex_b_taps(profile) if profile else None
    acc = {"hp": ([], [], []), "lp": ([], [], [])}
    for b in range(n_blocks):
        pk_hp = jnp.asarray(packets[b * n_pk_hp:(b + 1) * n_pk_hp])
        if hier:
            pk_lp = jnp.asarray(packets_lp[b * n_pk_lp:(b + 1) * n_pk_lp])
            tst, iq = tx(tst, (pk_hp, pk_lp))
        else:
            tst, iq = tx(tst, pk_hp)
        key, sub = jax.random.split(key)
        if taps is not None:
            iq = channel.multipath(iq, taps)
        rst, out, m = rx(rst, channel.awgn(sub, iq, snr_db))
        for name, ts_s, pre in (
            [("hp", out[0], "pre_rs_bit_errors"),
             ("lp", out[1], "lp_pre_rs_bit_errors")] if hier
                else [("hp", out, "pre_rs_bit_errors")]):
            bad_key = "rs_uncorrectable" if name == "hp" \
                else "lp_rs_uncorrectable"
            acc[name][0].append(np.asarray(ts_s))
            acc[name][1].append(np.asarray(m[bad_key]))
            acc[name][2].append(np.asarray(m[pre]))

    def stats(outs, bads, pres, want_pk):
        out = np.concatenate(outs)[DELAY_PACKETS:]
        bad = np.concatenate(bads)[DELAY_PACKETS:]
        pre = np.concatenate(pres)[DELAY_PACKETS:]
        want = want_pk[: len(out)]
        # post-RS: byte/bit errors on the recovered TS
        diff = out != want
        bit_err_rs = int(np.unpackbits(out ^ want).sum())
        n_bits = out.size * 8
        # post-Viterbi (pre-RS) BER: exact on correctable packets — the
        # receiver re-encodes each corrected RS message and XORs with its
        # received 204-B codeword (metrics[...pre_rs_bit_errors]);
        # uncorrectable packets are excluded (their true error count is
        # unknowable, >= 9 bytes).
        ok = bad == 0
        pre_rs_bits = int(ok.sum()) * 204 * 8
        return {
            "ber_post_viterbi": (float(pre[ok].sum()) / pre_rs_bits
                                 if pre_rs_bits else None),
            "ber_post_rs": bit_err_rs / n_bits if n_bits else None,
            "byte_err_post_rs": int(diff.sum()),
            "per": float(bad.mean()) if len(bad) else 0.0,
            "packets": int(len(out)),
        }

    result = {
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "snr_db": snr_db,
        **stats(*acc["hp"], packets),
    }
    if hier:
        result.update({f"lp_{k}": v for k, v in
                       stats(*acc["lp"], packets_lp).items()})
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    common.add_mode_args(p)
    p.add_argument("--snrs", default="2,4,6,8,10,12",
                   help="comma-separated SNR points in dB")
    p.add_argument("--blocks", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--demap", choices=["hard", "soft"], default="hard",
                   help="hard = reference parity; soft = 4-bit max-log "
                        "metrics into the soft Viterbi (~2 dB gain)")
    p.add_argument("--profile", choices=["none", "F1", "P1"], default="none",
                   help="EN300744 Annex B propagation profile before AWGN")
    a = p.parse_args(argv)
    mode = common.mode_from_args(a)
    profile = None if a.profile == "none" else a.profile
    for snr in [float(s) for s in a.snrs.split(",")]:
        print(json.dumps({**run_point(mode, snr, a.blocks, a.seed, a.demap,
                                      profile),
                          "demap": a.demap, "profile": a.profile}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
