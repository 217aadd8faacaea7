"""A/B of the Viterbi implementations in the fused TX+RX step, on the card.

    python tools/viterbi_ab.py [--modes 8k64qam23,2kqpsk12] [--steps 10]

For each mode it compiles the bench-shape step (4 frames x 8 muxes,
vmapped TX then RX under one jit) once per Viterbi implementation, then
times them in turns (jnp, pallas, pallas, jnp) so that drift of the card
shows as a difference between the two jnp turns.  Each turn runs --steps
steps and ends in block_until_ready.  Prints one JSON line per mode with
ms/step and Msamples/s per turn, the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

MODES = {"8k64qam23": "MODE_8K_UK", "2kqpsk12": "MODE_2K_QPSK"}


def make_step(mode, n_frames, n_mux, viterbi_impl):
    import jax
    import jax.numpy as jnp

    from dvbt_tpu.models import rx as rxm, tx as txm

    tx, n_pk, n_samp = txm.make_transmitter(mode, n_frames)
    rx, _, _ = rxm.make_receiver(mode, n_frames, viterbi_impl=viterbi_impl,
                                 metrics="min")

    def txrx(ts_st, rx_st, pk):
        ts_st, iq = tx(ts_st, pk)
        rx_st, out, m = rx(rx_st, iq)
        return ts_st, rx_st, out, m["rs_uncorrectable"]

    def rep(s):
        return jax.tree.map(
            lambda x: jnp.broadcast_to(x, (n_mux,) + x.shape), s)

    step = jax.jit(jax.vmap(txrx), donate_argnums=(0, 1))
    return step, rep(txm.init_tx_state(mode)), rep(rxm.init_rx_state(mode)), \
        n_pk, n_samp * n_mux


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--modes", default="8k64qam23,2kqpsk12")
    ap.add_argument("--impls", default="jnp,pallas")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--mux", type=int, default=8)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    import dvbt_tpu.mode as dm
    from dvbt_tpu.io import ts as tsio
    from dvbt_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if jax.devices()[0].platform != "gpu":
        sys.exit("viterbi_ab: needs a GPU")
    import subprocess
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    impls = args.impls.split(",")
    for key in args.modes.split(","):
        mode = getattr(dm, MODES[key])
        n_frames = mode.frames_per_block * args.frames
        built, compile_s = {}, {}
        for v in impls:
            step, tst, rst, n_pk, n_samp = make_step(mode, n_frames,
                                                      args.mux, v)
            pk = jnp.asarray(np.stack([tsio.make_ts_packets(n_pk, seed=i)
                                       for i in range(args.mux)]))
            t0 = time.perf_counter()
            tst, rst, out, bad = step(tst, rst, pk)
            tst, rst, out, bad = jax.block_until_ready(step(tst, rst, pk))
            compile_s[v] = time.perf_counter() - t0
            assert int(np.sum(np.asarray(bad))) == 0, (key, v)
            built[v] = [step, tst, rst, pk]
        order = impls + impls[::-1]
        turns = []
        for v in order:
            step, tst, rst, pk = built[v]
            t0 = time.perf_counter()
            for _ in range(args.steps):
                tst, rst, out, bad = step(tst, rst, pk)
            jax.block_until_ready((tst, rst, out, bad))
            dt = (time.perf_counter() - t0) / args.steps
            built[v][1:3] = [tst, rst]
            turns.append({"viterbi_impl": v, "ms_per_step": dt * 1e3,
                          "msps": n_samp / dt / 1e6})
            print(f"[ab] {key} {v}: {dt * 1e3:.3f} ms/step "
                  f"{n_samp / dt / 1e6:.3f} Msps", flush=True)
        print(json.dumps({
            "mode": key, "n_frames": n_frames, "n_mux": args.mux,
            "samples_per_step": n_samp, "steps_per_turn": args.steps,
            "turns": turns, "compile_s": compile_s, "nvidia_smi": smi,
            "device_kind": jax.devices()[0].device_kind,
            "xla_flags": os.environ.get("XLA_FLAGS", "")}), flush=True)


if __name__ == "__main__":
    main()
