"""Benchmark: full 8K 64-QAM 2/3 (UK profile) TX+RX loopback throughput.

The last line of stdout is ONE JSON object (the Viterbi parity check
logs above it):
  {"metric": ..., "value": Msamples/s/card, "unit": ..., "vs_baseline": ...,
   "platform": ..., "device_kind": ..., ...}

vs_baseline is relative to the reference's implied real-time requirement of
64/7 ≈ 9.143 Msamples/s (BASELINE.md: the reference publishes no numbers;
real-time operation is its design target).  The BASELINE.json north star
is 100x real time per card.

Needs a GPU: on any other backend it exits non-zero and prints no result.

Env knobs: DVBT_BENCH_MODE (default 8k64qam23 | 2kqpsk12),
DVBT_BENCH_SECONDS (target measure time, default 10), DVBT_BENCH_FRAMES
(frames per step, x frames_per_block, default 4), DVBT_BENCH_MUX (muxes per
step, default 8), DVBT_BENCH_METRICS (min | full, default min),
DVBT_BENCH_TRACKED (1 | 0: also time the StreamingReceiver path).
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def tracked_bench(mode, n_blocks: int = 12) -> dict:
    """Deployable-receiver throughput: the FULL StreamingReceiver path —
    initial CP-correlation acquisition, then the locked track (NCO
    derotation + SCO loop) + decode chain per block — instead of the
    symbol-aligned rx the headline metric uses.

    The stream carries a fractional CFO so the tracker genuinely derotates.
    Host->device block transfers are part of the measured path (they are
    part of deploying this receiver); blocks carry DVBT_TRACKED_FRAMES
    frames (default 8, ~0.5 s of air time each).
    """
    import jax.numpy as jnp
    import numpy as np

    from dvbt_tpu.io import ts as tsio
    from dvbt_tpu.models import channel, tx as txm
    from dvbt_tpu.models.loopback import StreamingReceiver

    n_frames = mode.frames_per_block * int(os.environ.get(
        "DVBT_TRACKED_FRAMES", "8"))
    n_blocks = int(os.environ.get("DVBT_TRACKED_BLOCKS", n_blocks))
    tx, n_pk, n_samp = txm.make_transmitter(mode, n_frames)
    tst = txm.init_tx_state(mode)
    pk = tsio.make_ts_packets(n_pk * n_blocks, seed=7)
    blocks = []
    for b in range(n_blocks):
        tst, iq = tx(tst, jnp.asarray(pk[b * n_pk:(b + 1) * n_pk]))
        phase0 = 2.0 * np.pi * 0.31 * (b * n_samp) / mode.fft_len
        iq = channel.apply_cfo(iq, 0.31, mode.fft_len, phase0=phase0)
        blocks.append(np.asarray(iq))

    srx = StreamingReceiver(mode, n_frames, pipeline=4,
                            metrics=os.environ.get("DVBT_BENCH_METRICS",
                                                   "min"))
    # warmup: compiles sync + track programs and acquires lock (the
    # acquisition search needs ~2 blocks of capture before the first
    # report); bounded so a sync regression reports tracked_locked=false
    warm = 0
    reports: list = []
    while warm < n_blocks - 2 and not any(r.reacquired for r in reports):
        reports += srx.feed(blocks[warm])
        warm += 1
    if not any(r.reacquired for r in reports):
        return {"tracked_locked": False, "tracked_msps": None,
                "tracked_blocks": 0, "tracked_rs_uncorrectable": None}
    reports += srx.feed(blocks[warm])  # one locked block: track program
    reports += srx.flush()
    warm += 1
    t0 = time.perf_counter()
    n_bad = 0
    fed = 0
    for b in range(warm, n_blocks):
        for r in srx.feed(blocks[b]):
            n_bad += int(r.rs_uncorrectable.sum())
        fed += len(blocks[b])
    for r in srx.flush():    # in-flight blocks are part of the measurement
        n_bad += int(r.rs_uncorrectable.sum())
    elapsed = time.perf_counter() - t0   # flush() fetched every result
    return {
        "tracked_msps": fed / elapsed / 1e6,
        "tracked_blocks": n_blocks - warm,
        "tracked_rs_uncorrectable": n_bad,
        "tracked_locked": srx.locked,
    }


def main() -> int:
    import subprocess

    import jax
    import jax.numpy as jnp
    import numpy as np

    if jax.devices()[0].platform != "gpu":
        print(f"bench: needs a GPU, JAX found "
              f"{jax.devices()[0].platform!r}", file=sys.stderr)
        return 2

    from chip_smoke import parse_nvidia_smi, phase_kernel_parity
    from dvbt_tpu.io import ts as tsio
    from dvbt_tpu.mode import MODE_2K_QPSK, MODE_8K_UK
    from dvbt_tpu.models import rx as rxm, tx as txm
    from dvbt_tpu.ops import bit_interleaver, ofdm
    from dvbt_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    which = os.environ.get("DVBT_BENCH_MODE", "8k64qam23")
    mode = {"8k64qam23": MODE_8K_UK, "2kqpsk12": MODE_2K_QPSK}[which]
    target_s = float(os.environ.get("DVBT_BENCH_SECONDS", "10"))
    n_frames = mode.frames_per_block * int(os.environ.get(
        "DVBT_BENCH_FRAMES", "4"))
    n_mux = int(os.environ.get("DVBT_BENCH_MUX", "8"))
    bench_metrics = os.environ.get("DVBT_BENCH_METRICS", "min")

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    viterbi_impl = rxm._resolve_viterbi_impl("auto")
    if viterbi_impl == "pallas":
        log("bench: Viterbi kernel parity vs the jnp scan...")
        phase_kernel_parity(mode, frames=n_frames // mode.frames_per_block,
                            n_mux=n_mux, rates=(mode.code_rate,))

    tx, n_pk, n_samp_1 = txm.make_transmitter(mode, n_frames)
    rx, _, _ = rxm.make_receiver(mode, n_frames, metrics=bench_metrics)
    n_samp = n_samp_1 * n_mux

    def txrx(tx_state, rx_state, packets):
        tx_state, iq = tx(tx_state, packets)
        rx_state, ts, metrics = rx(rx_state, iq)
        return tx_state, rx_state, ts, metrics["rs_uncorrectable"]

    step = jax.jit(jax.vmap(txrx), donate_argnums=(0, 1))

    def rep(s):
        return jax.tree.map(
            lambda x: jnp.broadcast_to(x, (n_mux,) + x.shape), s)

    packets = jnp.asarray(np.stack([tsio.make_ts_packets(n_pk)] * n_mux))
    tst = rep(txm.init_tx_state(mode))
    rst = rep(rxm.init_rx_state(mode))

    log("bench: compiling...")
    t0 = time.perf_counter()
    step = step.lower(tst, rst, packets).compile()
    compile_s = time.perf_counter() - t0
    # warm-up: the first step also fills the carried state
    for _ in range(3):
        tst, rst, ts, bad = step(tst, rst, packets)
    jax.block_until_ready((tst, rst, ts, bad))
    t0 = time.perf_counter()
    tst, rst, ts, bad = jax.block_until_ready(step(tst, rst, packets))
    t1 = time.perf_counter() - t0
    iters = min(max(3, int(target_s / t1)), 2000)
    log(f"bench: compiled in {compile_s:.1f}s, step {t1 * 1e3:.2f} ms "
        f"-> {iters} iters")

    t0 = time.perf_counter()
    for _ in range(iters):
        tst, rst, ts, bad = step(tst, rst, packets)
    jax.block_until_ready((tst, rst, ts, bad))
    elapsed = time.perf_counter() - t0
    n_bad = int(jnp.sum(bad))
    msps = n_samp * iters / elapsed / 1e6
    realtime = 64e6 / 7 / 1e6  # 9.1428 Msps

    tracked = {}
    if os.environ.get("DVBT_BENCH_TRACKED", "1") == "1":
        log("bench: tracked-streaming variant...")
        tracked = tracked_bench(mode)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout
    card, power_w = parse_nvidia_smi(smi.strip().splitlines()[0])
    dev = jax.devices()[0]
    result = {
        "metric": f"tx_rx_loopback_throughput_{which}",
        "value": msps,
        "unit": "Msamples/s/card",
        "vs_baseline": msps / realtime,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card,
        "power_limit_w": power_w,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "iters": iters,
        "block_samples": n_samp, "n_mux": n_mux, "n_frames": n_frames,
        "compile_s": compile_s,
        "metrics_mode": bench_metrics,
        "fft_impl": ofdm.FFT_IMPL,
        "ilv_dtype": bit_interleaver.ILV_DTYPE,
        "viterbi_impl": viterbi_impl,
        "tx_chunk": int(os.environ.get("DVBT_TX_CHUNK", "0")),
        "rs_uncorrectable_last_block": n_bad,
        **tracked,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
