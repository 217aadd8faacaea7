"""Round-5 BER curve batch (VERDICT r4 item 7): one 8K non-flagship AWGN
waterfall (8K 16-QAM 3/4, hard + soft) and the hierarchical LP SOFT dual
waterfall (the round-4 hierarchical curve was hard-only).

Writes docs/ber_*.jsonl in the same schema as the round-3/4 files.
Runs on the forced-CPU backend.

Usage: python tools/ber_r5.py [curve ...]   (default: all)
"""

from __future__ import annotations

import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

from dvbt_tpu.mode import DvbtMode  # noqa: E402
from dvbt_tpu.apps.ber_sweep import run_point  # noqa: E402

DOCS = os.path.join(_REPO, "docs")

MODE_8K_16QAM_34 = DvbtMode("8k", "16qam", "3/4")
# hierarchical 16-QAM alpha=2: HP 1/2 (robust), LP 3/4 — same mode as the
# round-4 hard curve so the soft/hard pair is directly comparable
MODE_HIER = DvbtMode("2k", "16qam", "1/2", alpha=2, code_rate_lp="3/4")

# (file stem, mode, demap, profile, snr list, blocks)
CURVES = [
    ("8k_16qam_34_hard", MODE_8K_16QAM_34, "hard", None,
     [11, 12, 13, 14, 15, 16], 4),
    ("8k_16qam_34_soft", MODE_8K_16QAM_34, "soft", None,
     [10, 11, 12, 13, 14], 4),
    # alpha=2 LP soft: the CSI-weighted max-log metrics cover the embedded
    # (non-uniform) constellation for free (mapper.make_soft_demapper)
    ("2k_16qam_hier_a2_soft", MODE_HIER, "soft", None,
     [4, 6, 8, 10, 12, 14, 16, 18, 20], 8),
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
                lp = (f" lp_per={r['lp_per']:.3f}"
                      if "lp_per" in r else "")
                print(f"{stem} snr={snr}: per={r['per']:.3f}{lp}",
                      flush=True)
        print(f"{stem} done in {time.time() - t0:.0f}s -> {path}",
              flush=True)


if __name__ == "__main__":
    main()
