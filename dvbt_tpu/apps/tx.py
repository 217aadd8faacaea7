"""dvbt-tx: MPEG-TS file -> DVB-T baseband IQ file (complex64, 64/7 Msps).

Replacement for the reference's TX flowgraph apps (SURVEY.md
§3.1): the whole chain runs as one jitted program per super-block.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..io import ts as tsio
from ..models import tx as txm
from . import common


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    common.add_mode_args(p)
    p.add_argument("--in", dest="infile",
                   help="input .ts file (default: synthesized test stream)")
    p.add_argument("--in-lp", dest="infile_lp",
                   help="LP-stream .ts file (hierarchical modes)")
    p.add_argument("--out", dest="outfile", required=True,
                   help="output IQ file (raw complex64)")
    p.add_argument("--packets", type=int, default=0,
                   help="limit / synthesize this many TS packets")
    p.add_argument("--blocks", type=int, default=0,
                   help="limit the number of super-blocks")
    a = p.parse_args(argv)
    mode = common.mode_from_args(a)

    import jax.numpy as jnp

    tx, n_pk, n_samp = txm.make_transmitter(mode)
    n_hp, n_lp = (n_pk if mode.hierarchical else (n_pk, 0))

    def load(path, per_block):
        if path:
            pk = tsio.read_ts_file(path)
            return pk[: a.packets] if a.packets else pk
        return tsio.make_ts_packets(a.packets or per_block * 8)

    packets = load(a.infile, n_hp)
    n_blocks = len(packets) // n_hp
    if mode.hierarchical:
        packets_lp = load(a.infile_lp, n_lp)
        n_blocks = min(n_blocks, len(packets_lp) // n_lp)
    if a.blocks:
        n_blocks = min(n_blocks, a.blocks)
    if n_blocks == 0:
        print(f"need at least {n_hp} packets per block", file=sys.stderr)
        return 2

    state = txm.init_tx_state(mode)
    t0 = time.time()
    from ..io import source as src
    with src.open_sink(a.outfile) as sink:   # file or (seam) SDR hardware
        for b in range(n_blocks):
            hp = jnp.asarray(packets[b * n_hp:(b + 1) * n_hp])
            arg = (hp, jnp.asarray(packets_lp[b * n_lp:(b + 1) * n_lp])) \
                if mode.hierarchical else hp
            state, iq = tx(state, arg)
            sink.write(np.asarray(iq))
    dt = time.time() - t0
    total = n_blocks * n_samp
    print(f"tx: {n_blocks} blocks, {n_blocks * n_hp} packets, "
          f"{total} samples ({total / mode.sample_rate:.2f} s of air time) "
          f"in {dt:.2f} s [{total / dt / 1e6:.1f} Msps]", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
