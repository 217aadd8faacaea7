"""Round-4 BER curve batch (VERDICT r3 items 5/6): multipath F1/P1 curves
for the two headline modes (hard + soft), plus AWGN waterfalls for 16-QAM
3/4, 64-QAM 7/8 and one hierarchical mode (HP + LP).

Writes docs/ber_*.jsonl (one JSON line per SNR point, same schema as the
round-3 AWGN files, plus "profile"/"demap" tags).  Runs on the forced-CPU
backend.

Usage: python tools/ber_r4.py [curve ...]   (default: all)
"""

from __future__ import annotations

import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

from dvbt_tpu.mode import MODE_2K_QPSK, MODE_8K_UK, DvbtMode  # noqa: E402
from dvbt_tpu.apps.ber_sweep import run_point  # noqa: E402

DOCS = os.path.join(_REPO, "docs")

MODE_16QAM_34 = DvbtMode("2k", "16qam", "3/4")
MODE_64QAM_78 = DvbtMode("2k", "64qam", "7/8")
# hierarchical 16-QAM alpha=2: HP 1/2 (robust), LP 3/4
MODE_HIER = DvbtMode("2k", "16qam", "1/2", alpha=2, code_rate_lp="3/4")

# (file stem, mode, demap, profile, snr list, blocks)
CURVES = [
    ("2k_qpsk_12_f1_hard", MODE_2K_QPSK, "hard", "F1",
     [3, 4, 5, 6, 7, 8, 9], 8),
    ("2k_qpsk_12_f1_soft", MODE_2K_QPSK, "soft", "F1",
     [2, 3, 4, 5, 6, 7], 8),
    ("2k_qpsk_12_p1_hard", MODE_2K_QPSK, "hard", "P1",
     [5, 6, 7, 8, 9, 10, 12, 14], 8),
    ("2k_qpsk_12_p1_soft", MODE_2K_QPSK, "soft", "P1",
     [4, 5, 6, 7, 8, 10], 8),   # CSI-weighted: QEF ~<8 dB
    ("8k_64qam_23_f1_hard", MODE_8K_UK, "hard", "F1",
     [17, 18, 19, 20, 21, 22], 4),
    ("8k_64qam_23_f1_soft", MODE_8K_UK, "soft", "F1",
     [16, 17, 18, 19], 4),
    ("8k_64qam_23_p1_hard", MODE_8K_UK, "hard", "P1",
     [19, 20, 21, 22, 23, 24, 26], 4),
    ("8k_64qam_23_p1_soft", MODE_8K_UK, "soft", "P1",
     [17, 18, 19, 20, 21, 22], 4),  # CSI-weighted
    ("2k_16qam_34_hard", MODE_16QAM_34, "hard", None,
     [11, 12, 13, 14, 15, 16, 17], 8),
    ("2k_16qam_34_soft", MODE_16QAM_34, "soft", None,
     [10, 11, 12, 13, 14], 8),
    ("2k_64qam_78_hard", MODE_64QAM_78, "hard", None,
     [19, 20, 21, 22, 23, 24, 25], 8),
    ("2k_64qam_78_soft", MODE_64QAM_78, "soft", None,
     [18, 19, 20, 21, 22], 8),
    # alpha=2 shrinks the inner (LP) distances: LP 3/4 hard needs ~21+ dB
    ("2k_16qam_hier_a2_hard", MODE_HIER, "hard", None,
     [6, 8, 10, 12, 14, 16, 18, 20, 22, 24], 8),
]


def main():
    want = set(sys.argv[1:])
    for stem, mode, demap, profile, snrs, blocks in CURVES:
        if want and stem not in want:
            continue
        path = os.path.join(DOCS, f"ber_{stem}.jsonl")
        t0 = time.time()
        with open(path, "w") as f:
            for snr in snrs:
                r = run_point(mode, float(snr), blocks, demap=demap,
                              profile=profile)
                r.update(demap=demap, profile=profile or "none")
                f.write(json.dumps(r) + "\n")
                f.flush()
                print(f"{stem} snr={snr}: per={r['per']:.3f} "
                      f"pre={r['ber_post_viterbi']}", flush=True)
        print(f"{stem} done in {time.time() - t0:.0f}s -> {path}",
              flush=True)


if __name__ == "__main__":
    main()
