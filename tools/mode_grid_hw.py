"""On-card validation sweep: byte-exact TX->RX loopback on the GPU for

  * the full 2K constellation x code-rate grid (15 modes),
  * a guard-interval sweep at 2K 64-QAM 2/3,
  * 8K spot modes incl. the UK profile and rate 7/8,
  * hierarchical modes (2K 16-QAM alpha=4, 8K 64-QAM alpha=2 HP 2/3 LP 3/4).

Each mode streams TWO carried-state blocks through the symbol-aligned
receiver and checks the recovered TS byte-exactly (11-packet Forney delay)
with zero RS corrections consumed — i.e. the decode is exact BEFORE the RS
safety net, so a kernel or convention regression cannot hide behind RS's
8-byte budget.

Writes docs/MODE_GRID_HW.json (tagged with platform and device_kind).
Run on the card:  python tools/mode_grid_hw.py   (one process per card;
compiles are cached by dvbt_tpu.utils.compile_cache).
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DELAY = 11  # outer-deinterleaver packet delay


def run_mode(mode, n_blocks: int = 2) -> dict:
    import jax.numpy as jnp
    import numpy as np

    from dvbt_tpu.io import ts as tsio
    from dvbt_tpu.models import rx as rxm, tx as txm

    tx, n_pk, _ = txm.make_transmitter(mode)
    rx, _, _ = rxm.make_receiver(mode)
    hier = mode.hierarchical
    if hier:
        n_hp, n_lp = n_pk
        pk_hp = tsio.make_ts_packets(n_hp * n_blocks, seed=3)
        pk_lp = tsio.make_ts_packets(n_lp * n_blocks, seed=4)
    else:
        pk_hp = tsio.make_ts_packets(n_pk * n_blocks, seed=3)

    tst, rst = txm.init_tx_state(mode), rxm.init_rx_state(mode)
    t0 = time.time()
    outs_hp, outs_lp, bad, corr = [], [], 0, 0
    for b in range(n_blocks):
        if hier:
            pk = (jnp.asarray(pk_hp[b * n_hp:(b + 1) * n_hp]),
                  jnp.asarray(pk_lp[b * n_lp:(b + 1) * n_lp]))
        else:
            pk = jnp.asarray(pk_hp[b * n_pk:(b + 1) * n_pk])
        tst, iq = tx(tst, pk)
        rst, ts, m = rx(rst, iq)
        outs_hp.append(np.asarray(ts[0] if hier else ts))
        bad += int(np.asarray(m["rs_uncorrectable"]).sum())
        corr += int(np.asarray(m["rs_corrected"]).sum())
        if hier:
            outs_lp.append(np.asarray(ts[1]))
            bad += int(np.asarray(m["lp_rs_uncorrectable"]).sum())
            corr += int(np.asarray(m["lp_rs_corrected"]).sum())
    wall = time.time() - t0

    def exact(outs, want):
        got = np.concatenate(outs)[DELAY:]
        return bool((got == want[: len(got)]).all())

    ok = exact(outs_hp, pk_hp) and bad == 0 and corr == 0
    if hier:
        ok = ok and exact(outs_lp, pk_lp)
    return {"byte_exact": ok, "rs_uncorrectable": bad,
            "rs_corrected": corr, "wall_s": round(wall, 1)}


def main():
    import jax

    from dvbt_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from dvbt_tpu.mode import DvbtMode

    grid: list[tuple[str, DvbtMode]] = []
    for c in ("qpsk", "16qam", "64qam"):
        for r in ("1/2", "2/3", "3/4", "5/6", "7/8"):
            grid.append((f"2k_{c}_{r.replace('/', '')}",
                         DvbtMode("2k", c, r, "1/4")))
    for g in ("1/4", "1/8", "1/16", "1/32"):
        grid.append((f"2k_64qam_23_g{g.replace('/', '')}",
                     DvbtMode("2k", "64qam", "2/3", g)))
    grid += [
        ("8k_qpsk_12", DvbtMode("8k", "qpsk", "1/2", "1/4")),
        ("8k_16qam_34", DvbtMode("8k", "16qam", "3/4", "1/8")),
        ("8k_64qam_23_uk", DvbtMode("8k", "64qam", "2/3", "1/32")),
        ("8k_64qam_78", DvbtMode("8k", "64qam", "7/8", "1/16")),
        ("2k_16qam_a4_hier", DvbtMode("2k", "16qam", "1/2", "1/8",
                                      alpha=4, code_rate_lp="3/4")),
        ("8k_64qam_a2_hier", DvbtMode("8k", "64qam", "2/3", "1/32",
                                      alpha=2, code_rate_lp="3/4")),
    ]

    results = {}
    t_all = time.time()
    for name, mode in grid:
        t0 = time.time()
        try:
            results[name] = run_mode(mode)
        except Exception as e:  # record, keep sweeping
            results[name] = {"byte_exact": False, "error": repr(e)[:200]}
        results[name]["total_s"] = round(time.time() - t0, 1)
        print(f"{name:24s} {json.dumps(results[name])}", flush=True)

    n_ok = sum(1 for r in results.values() if r.get("byte_exact"))
    artifact = {
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "modes_green": n_ok,
        "modes_total": len(results),
        "wall_s": round(time.time() - t_all, 1),
        "results": results,
    }
    out = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "docs", "MODE_GRID_HW.json")
    with open(out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(f"{n_ok}/{len(results)} modes green -> {out}", flush=True)
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
