"""dvbt-rx: DVB-T baseband IQ file (complex64) -> MPEG-TS file.

Replacement for the reference's RX flowgraph apps (SURVEY.md
§3.2), with full acquisition: unknown timing, CFO, and frame alignment are
recovered by the streaming front-end (ops/sync.py + models/loopback.py).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..io import ts as tsio
from ..io.source import open_source
from ..models.loopback import StreamingReceiver
from . import common


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    common.add_mode_args(p)
    p.add_argument("--in", dest="infile", required=True,
                   help="input IQ source: raw-complex64 file path, or an "
                        "SDR URL (usrp://…, rtlsdr://…) once a driver "
                        "implements io.source.SampleSource")
    p.add_argument("--out", dest="outfile", required=True,
                   help="output .ts file")
    p.add_argument("--out-lp", dest="outfile_lp",
                   help="LP-stream output .ts (hierarchical modes)")
    p.add_argument("--max-int-cfo", type=int, default=8,
                   help="integer CFO search range (subcarriers)")
    p.add_argument("--chunk", type=int, default=1 << 20,
                   help="file read chunk (samples)")
    a = p.parse_args(argv)
    mode = common.mode_from_args(a)

    srx = StreamingReceiver(mode, max_int_cfo=a.max_int_cfo)
    n_pk = srx.n_packets[0] if mode.hierarchical else srx.n_packets
    flp = open(a.outfile_lp, "wb") if (mode.hierarchical and a.outfile_lp) \
        else None
    t0 = time.time()
    n_blocks = n_corr = n_bad = n_samples = 0

    def emit(rep):
        nonlocal n_blocks, n_corr, n_bad
        n_blocks += 1
        n_corr += int(rep.rs_corrected.sum())
        n_bad += int(rep.rs_uncorrectable.sum())
        if rep.reacquired:
            print(f"rx: acquired at sample {rep.stream_offset} "
                  f"(cfo {float(rep.info['cfo_frac']) + float(rep.info['cfo_int']):+.3f} "
                  f"subcarriers)", file=sys.stderr)
        rep.packets.tofile(fo)
        if flp is not None:
            rep.packets_lp.tofile(flp)

    src = open_source(a.infile)
    with open(a.outfile, "wb") as fo:
        while True:
            chunk = src.read(a.chunk)
            if len(chunk) == 0:
                break
            n_samples += len(chunk)
            for rep in srx.feed(chunk):
                emit(rep)
        for rep in srx.flush():
            emit(rep)
    src.close()
    if flp is not None:
        flp.close()
    dt = time.time() - t0
    print(f"rx: {n_blocks} blocks, {n_blocks * n_pk} packets "
          f"(rs corrected bytes: {n_corr}, uncorrectable packets: {n_bad}) "
          f"from {n_samples} samples in {dt:.2f} s "
          f"[{n_samples / max(dt, 1e-9) / 1e6:.1f} Msps]", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
