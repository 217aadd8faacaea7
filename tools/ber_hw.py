"""On-card BER points: one point per waterfall, measured on the GPU, to
check the CPU-measured curves in docs/ against the card.  Appends
platform/device_kind-tagged JSONL lines next to the CPU curves.

Run on the card:  python tools/ber_hw.py    (one process per card)
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DOCS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "docs")

POINTS = [
    # (mode ctor args, snr_db, blocks, demap, profile, jsonl file the CPU
    #  curve lives in)
    (("2k", "qpsk", "1/2", "1/32"), 5.0, 8, "hard", None,
     "ber_2k_qpsk_12_hard.jsonl"),
    (("8k", "64qam", "2/3", "1/32"), 19.0, 4, "hard", None,
     "ber_8k_64qam_23_hard.jsonl"),
    # round-4 paths: Annex B multipath + CSI-weighted soft, on-device
    (("2k", "qpsk", "1/2", "1/32"), 7.0, 8, "hard", "F1",
     "ber_2k_qpsk_12_f1_hard.jsonl"),
    (("2k", "qpsk", "1/2", "1/32"), 8.0, 8, "soft", "P1",
     "ber_2k_qpsk_12_p1_soft.jsonl"),
]


def main():
    from dvbt_tpu.apps.ber_sweep import run_point
    from dvbt_tpu.mode import DvbtMode

    for args, snr, blocks, demap, profile, fname in POINTS:
        mode = DvbtMode(*args)
        t0 = time.time()
        r = {**run_point(mode, snr, blocks, seed=0, demap=demap,
                         profile=profile),
             "demap": demap, "profile": profile or "none"}
        r["wall_s"] = round(time.time() - t0, 1)
        line = json.dumps(r)
        print(f"{fname}: {line}", flush=True)
        if r.get("platform") == "gpu":
            with open(os.path.join(DOCS, fname), "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
