#!/usr/bin/env python3
"""Smoke test of the DVB-T TX -> RX chain on one NVIDIA GPU.

    python chip_smoke.py                # one card, every phase below
    python chip_smoke.py --four-cards   # mux-DP + time-axis sharding on 4

Phases (one process; any failure exits non-zero and prints no result):

0. device: JAX platform/kind/count, ``nvidia-smi`` name and power limit,
   JAX version, XLA_FLAGS, compile-cache directory.
1. kernel parity: the Pallas (Triton) Viterbi kernel against the ops.viterbi
   scan, both on the card, at the 8K 64-QAM bench width for all five code
   rates, hard {0,15} and noisy soft input; tolerance 0.
2. TX against the frozen snapshots tests/golden/tx_*.npz (atol 2e-5).
3. loopback: the fused TX+RX step vmapped over 8 muxes at 8K 64-QAM 2/3
   (4 frames per step) and a hierarchical 2K mode, hard and soft demap:
   TS byte-exact, no RS failures; the noisy soft decode must equal the
   receiver built with viterbi_impl="jnp" bit for bit.
4. StreamingReceiver at 8K with an unknown delay and a 0.31-subcarrier CFO,
   fed in ragged chunks: lock, byte-exact packets after the 11-packet
   outer-interleaver delay, no RS failures on tracked blocks.
5. the tests marked ``gpu`` (tests/test_gpu.py), run in this process.

The last line of stdout is ``{"ok": true, "device": {...}}``.  With no GPU
the script exits non-zero before any phase.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

DELAY_PACKETS = 11            # outer interleaver + deinterleaver delay
RATES = ("1/2", "2/3", "3/4", "5/6", "7/8")
BENCH_FRAMES = 4              # frames per step (x frames_per_block)
BENCH_MUX = 8
HIER_MODE_ARGS = dict(transmission="2k", constellation="16qam",
                      code_rate="3/4", guard="1/8", alpha=2,
                      code_rate_lp="1/2")


def log(msg: str) -> None:
    print(msg, flush=True)


def parse_nvidia_smi(line: str) -> tuple[str, float]:
    """'NVIDIA H100 80GB HBM3, 700.00 W' -> ('NVIDIA H100 80GB HBM3', 700.)"""
    name, power = (part.strip() for part in line.rsplit(",", 1))
    return name, float(power.split()[0])


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def _bench_frames(mode, frames: int | None) -> int:
    return mode.frames_per_block * (BENCH_FRAMES if frames is None
                                    else frames)


def _stack_states(state, n):
    import jax
    import jax.numpy as jnp
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + x.shape), state)


# --- phase 0 -----------------------------------------------------------------

def phase_device(n_cards: int = 1) -> dict:
    import jax

    from dvbt_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    devs = jax.devices()
    d = devs[0]
    log(f"[device] platform={d.platform} kind={d.device_kind} "
        f"count={len(devs)}")
    log(f"[device] jax={jax.__version__} "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} cache={cache}")
    if len(devs) < n_cards:
        raise RuntimeError(f"need {n_cards} devices, have {len(devs)}")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


# --- phase 1 -----------------------------------------------------------------

def phase_kernel_parity(mode=None, frames: int | None = None,
                        n_mux: int = BENCH_MUX, impl: str = "pallas",
                        rates=RATES) -> dict:
    """Kernel vs ops.viterbi on the same device, per rate, hard + soft."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from dvbt_tpu.kernels import viterbi_triton
    from dvbt_tpu.mode import MODE_8K_UK, RS_PACKET, DvbtMode
    from dvbt_tpu.ops import inner_coder, viterbi
    from dvbt_tpu.utils import bits as bitutils

    mode = mode or MODE_8K_UK
    out = {}
    for k, rate in enumerate(rates):
        m = DvbtMode(mode.transmission, mode.constellation, rate, mode.guard)
        n_bits = (m.stream_packets_per_block("hp") * RS_PACKET * 8
                  * _bench_frames(m, frames) // m.frames_per_block)
        ov = viterbi.effective_overlap(rate)
        coder = inner_coder.make_inner_coder(n_bits // 8, rate)
        depunct = inner_coder.make_depuncture(n_bits, rate)
        dec_j = viterbi.make_viterbi_decoder(n_bits, overlap=ov)
        dec_k = viterbi_triton.make_viterbi_decoder_punctured(
            n_bits, rate, overlap=ov, interpret=impl.endswith("-interpret"))

        def ref(state, coded):
            x, y, xm, ym = depunct(coded)
            xm = jnp.broadcast_to(xm, x.shape).astype(jnp.uint8)
            ym = jnp.broadcast_to(ym, y.shape).astype(jnp.uint8)
            state, bits = dec_j(state, x, y, xm, ym)
            return state, bitutils.bits_to_bytes(bits)

        def make_input(key):
            kb, kn = jax.random.split(key)
            stream = jax.random.randint(kb, (n_mux, n_bits // 8), 0, 256
                                        ).astype(jnp.uint8)
            _, coded = jax.vmap(coder, in_axes=(None, 0))(
                inner_coder.init_state(), stream)
            hard = coded * jnp.uint8(15)
            # soft: +-7.5 around the midpoint plus Gaussian noise (sigma 5)
            noisy = (7.5 + 7.5 * (2.0 * coded - 1.0)
                     + 5.0 * jax.random.normal(kn, coded.shape))
            soft = jnp.clip(jnp.round(noisy), 0, 15).astype(jnp.uint8)
            return hard, soft

        hard, soft = jax.jit(make_input)(jax.random.PRNGKey(k))
        state0 = _stack_states(viterbi.init_state(ov), n_mux)
        run_k = jax.jit(jax.vmap(dec_k))
        run_j = jax.jit(jax.vmap(ref))
        if k == 0 and not impl.endswith("-interpret"):
            mem = run_k.lower(state0, hard).compile().memory_analysis()
            log(f"[kernel] memory_analysis (rate {rate}, {n_mux} x "
                f"{n_bits} bits): {mem}")
        for name, coded in (("hard", hard), ("soft", soft)):
            # two blocks: the second starts from the carried state
            sk, sj = state0, state0
            for blk in range(2):      # blk 1 is timed: compiled, warm
                t0 = time.perf_counter()
                sk, bk = jax.block_until_ready(run_k(sk, coded))
                t1 = time.perf_counter()
                sj, bj = jax.block_until_ready(run_j(sj, coded))
                tk, tj = t1 - t0, time.perf_counter() - t1
                diff = int(jnp.sum(bk != bj))
                sdiff = sum(int(jnp.sum(sk[n] != sj[n])) for n in sj)
                if diff or sdiff:
                    raise AssertionError(
                        f"kernel != scan at rate {rate} {name} block {blk}: "
                        f"{diff} bytes, {sdiff} state entries differ")
            log(f"[kernel] rate {rate} {name}: {n_mux} x {n_bits} bits "
                f"identical; decode {tk * 1e3:.3f} ms kernel, "
                f"{tj * 1e3:.3f} ms jnp scan")
            out[f"{rate}/{name}"] = True
    return out


# --- phase 2 -----------------------------------------------------------------

def _load_golden():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "_golden", os.path.join(REPO, "tests", "test_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_tx_snapshots(names=None) -> dict:
    import numpy as np

    golden = _load_golden()
    out = {}
    for name in names or sorted(golden._SNAP_MODES):
        want = np.load(os.path.join(REPO, "tests", "golden",
                                    f"tx_{name}.npz"))
        got = golden._tx_artifacts(golden._SNAP_MODES[name])
        err = max(float(np.max(np.abs(got[k] - want[k])))
                  for k in ("iq_head", "iq2_head"))
        log(f"[tx] snapshot {name}: max abs err {err:.3e}")
        if not err <= 2e-5:
            raise AssertionError(f"TX snapshot {name}: max abs err {err}")
        out[name] = err
    return out


# --- phase 3 -----------------------------------------------------------------

def _split_streams(ts, hier):
    return tuple(ts) if hier else (ts,)


def _check_stream(name, packets, out, bad):
    """packets/out (n_mux, n_steps*P, 188); bad (n_mux, n_steps*P)."""
    import numpy as np
    d = DELAY_PACKETS
    if not np.array_equal(out[:, d:], packets[:, :-d]):
        n = int(np.sum(np.any(out[:, d:] != packets[:, :-d], axis=-1)))
        raise AssertionError(f"{name}: {n} packets differ from the input")
    n_bad = int(np.sum(bad[:, d:]))
    if n_bad:
        raise AssertionError(f"{name}: rs_uncorrectable = {n_bad}")


def phase_loopback(mode=None, frames: int | None = None,
                   n_mux: int = BENCH_MUX, impl: str = "auto",
                   snr_db: float = 16.0, n_steps: int = 2) -> dict:
    """Fused TX+RX step, vmapped over n_mux, hard and soft demap."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from dvbt_tpu.io import ts as tsio
    from dvbt_tpu.mode import MODE_8K_UK
    from dvbt_tpu.models import channel, rx as rxm, tx as txm

    mode = mode or MODE_8K_UK
    hier = mode.hierarchical
    n_frames = _bench_frames(mode, frames)
    tx, n_pk, _ = txm.make_transmitter(mode, n_frames)
    n_pks = n_pk if hier else (n_pk,)
    packets = [np.stack([tsio.make_ts_packets(p * n_steps, seed=100 * s + i)
                         for i in range(n_mux)])
               for s, p in enumerate(n_pks)]

    def step_packets(k):
        pk = tuple(jnp.asarray(p[:, k * n: (k + 1) * n])
                   for p, n in zip(packets, n_pks))
        return pk if hier else pk[0]

    tst0 = _stack_states(txm.init_tx_state(mode), n_mux)
    rst0 = _stack_states(rxm.init_rx_state(mode), n_mux)
    bad_keys = ("rs_uncorrectable", "lp_rs_uncorrectable")[:len(n_pks)]
    result = {}

    def collect(outs, metrics):
        got = [np.concatenate([np.asarray(_split_streams(o, hier)[s])
                               for o in outs], axis=1)
               for s in range(len(n_pks))]
        bad = [np.concatenate([np.asarray(m[k]) for m in metrics], axis=1)
               for k in bad_keys]
        return got, bad

    for demap in ("hard", "soft"):
        rx, _, _ = rxm.make_receiver(mode, n_frames, viterbi_impl=impl,
                                     demap=demap)

        def txrx(ts_st, rx_st, pk):
            ts_st, iq = tx(ts_st, pk)
            rx_st, out, m = rx(rx_st, iq)
            return ts_st, rx_st, out, m

        step = jax.jit(jax.vmap(txrx))
        t0 = time.perf_counter()
        step = step.lower(tst0, rst0, step_packets(0)).compile()
        compile_s = time.perf_counter() - t0
        tst, rst, outs, metrics = tst0, rst0, [], []
        for k in range(n_steps):
            tst, rst, out, m = step(tst, rst, step_packets(k))
            outs.append(out)
            metrics.append(m)
        got, bad = collect(outs, metrics)
        for s, name in enumerate(("hp", "lp")[:len(n_pks)]):
            _check_stream(f"loopback {demap} {name}", packets[s], got[s],
                          bad[s])
        log(f"[loopback] {mode.transmission} {mode.constellation} "
            f"{mode.code_rate} alpha={mode.alpha} {demap}: {n_mux} mux x "
            f"{n_steps} steps byte-exact, compile {compile_s:.1f} s")
        result[f"{demap}_compile_s"] = compile_s

    # noisy soft decode: the selected Viterbi against the jnp scan on the
    # SAME received samples (one TX program feeds both receivers)
    vtx = jax.jit(jax.vmap(tx))
    awgn = jax.jit(jax.vmap(lambda k, iq: channel.awgn(k, iq, snr_db)))
    rx_sel, _, _ = rxm.make_receiver(mode, n_frames, viterbi_impl=impl,
                                     demap="soft")
    rx_ref, _, _ = rxm.make_receiver(mode, n_frames, viterbi_impl="jnp",
                                     demap="soft")
    v_sel, v_ref = jax.jit(jax.vmap(rx_sel)), jax.jit(jax.vmap(rx_ref))
    tst, r_sel, r_ref = tst0, rst0, rst0
    corrected = 0
    for k in range(n_steps):
        tst, iq = vtx(tst, step_packets(k))
        iq = awgn(jax.random.split(jax.random.PRNGKey(k), n_mux), iq)
        r_sel, o_sel, m_sel = v_sel(r_sel, iq)
        r_ref, o_ref, m_ref = v_ref(r_ref, iq)
        for a, b in zip(jax.tree.leaves((o_sel, m_sel["rs_corrected"])),
                        jax.tree.leaves((o_ref, m_ref["rs_corrected"]))):
            if not np.array_equal(np.asarray(a), np.asarray(b)):
                raise AssertionError(
                    f"noisy soft decode differs from viterbi_impl='jnp' "
                    f"(step {k})")
        corrected += int(np.sum(np.asarray(m_sel["rs_corrected"])))
    log(f"[loopback] noisy soft ({snr_db} dB) == jnp receiver, "
        f"{corrected} RS-corrected bytes")
    result["noisy_rs_corrected"] = corrected
    return result


# --- phase 4 -----------------------------------------------------------------

def phase_streaming(mode=None, n_blocks: int = 6, delay: int = 23_456,
                    cfo: float = 0.31) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from dvbt_tpu.io import ts as tsio
    from dvbt_tpu.mode import MODE_8K_UK
    from dvbt_tpu.models import channel, tx as txm
    from dvbt_tpu.models.loopback import StreamingReceiver
    from dvbt_tpu.ops import sync as syncop

    mode = mode or MODE_8K_UK
    tx, n_pk, _ = txm.make_transmitter(mode)
    packets = tsio.make_ts_packets(n_pk * n_blocks, seed=11)
    tst = txm.init_tx_state(mode)
    chunks = [np.zeros(delay, np.complex64)]
    for b in range(n_blocks):
        tst, iq = tx(tst, jnp.asarray(packets[b * n_pk:(b + 1) * n_pk]))
        chunks.append(np.asarray(iq))
    stream = np.asarray(channel.apply_cfo(
        jnp.asarray(np.concatenate(chunks)), cfo, mode.fft_len))

    srx = StreamingReceiver(mode)
    reports = []
    pos, chunk = 0, 300_007
    while pos < len(stream):
        reports += srx.feed(stream[pos: pos + chunk])
        pos += chunk
        chunk = 177_777 if chunk != 177_777 else 300_007
    reports += srx.flush()
    if len(reports) < 2 or not reports[0].reacquired:
        raise AssertionError(f"no lock: {len(reports)} reports")
    blk = mode.samples_per_block
    start = reports[0].stream_offset + syncop.DEFAULT_BACKOFF - delay
    if start % blk:
        raise AssertionError(f"lock at sample {start}, not a block start")
    k0 = start // blk
    out = np.concatenate([r.packets for r in reports])
    want = packets[k0 * n_pk: k0 * n_pk + len(out) - DELAY_PACKETS]
    if not np.array_equal(out[DELAY_PACKETS:], want):
        raise AssertionError("streamed packets differ from the input")
    n_bad = sum(int(r.rs_uncorrectable.sum()) for r in reports[1:])
    if n_bad:
        raise AssertionError(f"tracked blocks: rs_uncorrectable = {n_bad}")
    log(f"[streaming] lock at block {k0}, cfo_int="
        f"{int(reports[0].info['cfo_int'])} cfo_frac="
        f"{float(reports[0].info['cfo_frac']):.3f}, {len(reports)} blocks, "
        f"{len(out) - DELAY_PACKETS} packets byte-exact")
    return {"blocks": len(reports), "lock_block": int(k0)}


# --- phase 5 -----------------------------------------------------------------

def phase_gpu_tests() -> dict:
    import pytest
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "--rootdir", REPO,
                      os.path.join(REPO, "tests", "test_gpu.py")])
    if rc != 0:
        raise AssertionError(f"gpu-marked tests failed (pytest rc={rc})")
    return {"rc": int(rc)}


# --- four cards ---------------------------------------------------------------

def phase_mux_dp(mode=None, n_dev: int = 4, muxes_per_device: int = 2,
                 n_steps: int = 2) -> dict:
    """sharding.make_sharded_loopback over n_dev cards vs per-mux loopback
    on one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dvbt_tpu.io import ts as tsio
    from dvbt_tpu.mode import MODE_8K_UK
    from dvbt_tpu.models import rx as rxm, tx as txm
    from dvbt_tpu.parallel import sharding

    mode = mode or MODE_8K_UK
    mesh = sharding.make_mux_mesh(jax.devices()[:n_dev])
    step, init_states, n_pk = sharding.make_sharded_loopback(
        mode, mesh, muxes_per_device)
    B = n_dev * muxes_per_device
    packets = np.stack([tsio.make_ts_packets(n_pk * n_steps, seed=i)
                        for i in range(B)])
    sh = NamedSharding(mesh, P("mux"))
    states = init_states()
    outs = []
    t0 = time.perf_counter()
    for k in range(n_steps):
        pk = jax.device_put(jnp.asarray(packets[:, k * n_pk:(k + 1) * n_pk]),
                            sh)
        states, out, fleet = step(states, pk)
        outs.append(np.asarray(out))
    sharded_s = time.perf_counter() - t0
    got = np.concatenate(outs, axis=1)

    dev0 = jax.devices()[0]
    tx, _, _ = txm.make_transmitter(mode)
    rx, _, _ = rxm.make_receiver(mode)
    with jax.default_device(dev0):
        for i in range(B):
            tst, rst = txm.init_tx_state(mode), rxm.init_rx_state(mode)
            ref = []
            for k in range(n_steps):
                tst, iq = tx(tst, jnp.asarray(
                    packets[i, k * n_pk:(k + 1) * n_pk]))
                rst, o, _ = rx(rst, iq)
                ref.append(np.asarray(o))
            if not np.array_equal(got[i], np.concatenate(ref)):
                raise AssertionError(f"mux-DP mux {i} differs from one card")
    _check_stream("mux-DP", packets, got, np.zeros(got.shape[:2], bool))
    log(f"[four-cards] mux-DP {n_dev} cards x {muxes_per_device} mux "
        f"byte-exact vs one card ({sharded_s:.1f} s incl. compile)")
    return {"mux_dp_s": sharded_s}


def phase_time_sharded(mode=None, n_dev: int = 4, n_steps: int = 2) -> dict:
    """time_sharding.make_time_sharded_loopback (ppermute halos) over n_dev
    cards vs single-card streaming TX -> RX."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from dvbt_tpu.io import ts as tsio
    from dvbt_tpu.mode import MODE_8K_UK
    from dvbt_tpu.models import rx as rxm, tx as txm
    from dvbt_tpu.parallel import time_sharding as tsh

    mode = mode or MODE_8K_UK
    mesh = Mesh(np.asarray(jax.devices()[:n_dev]), ("time",))
    step, n_pk, carry = tsh.make_time_sharded_loopback(mode, mesh)
    n_blocks = n_dev * n_steps
    packets = tsio.make_ts_packets(n_pk * n_blocks, seed=9)
    sh = NamedSharding(mesh, P("time"))
    outs = []
    t0 = time.perf_counter()
    for s in range(n_steps):
        chunk = jax.device_put(
            jnp.asarray(packets[s * n_dev * n_pk:(s + 1) * n_dev * n_pk]), sh)
        carry, ts, _ = step(carry, chunk)
        outs.append(np.asarray(ts))
    sharded_s = time.perf_counter() - t0
    got = np.concatenate(outs)

    tx, _, _ = txm.make_transmitter(mode)
    rx, _, _ = rxm.make_receiver(mode)
    with jax.default_device(jax.devices()[0]):
        tst, rst = txm.init_tx_state(mode), rxm.init_rx_state(mode)
        ref = []
        for b in range(n_blocks):
            tst, iq = tx(tst, jnp.asarray(packets[b * n_pk:(b + 1) * n_pk]))
            rst, o, _ = rx(rst, iq)
            ref.append(np.asarray(o))
    if not np.array_equal(got, np.concatenate(ref)):
        raise AssertionError("time-sharded output differs from one card")
    log(f"[four-cards] time-axis ppermute {n_dev} cards x {n_steps} steps "
        f"byte-exact vs single-card streaming ({sharded_s:.1f} s incl. "
        f"compile)")
    return {"time_sharded_s": sharded_s}


# --- main ---------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card mux-DP and time-axis phases")
    args = ap.parse_args(argv)

    import jax
    try:
        platform = jax.devices()[0].platform
    except RuntimeError as e:
        print(f"chip_smoke: no JAX device: {e}", file=sys.stderr)
        return 2
    if platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {platform!r}",
              file=sys.stderr)
        return 2

    n_cards = 4 if args.four_cards else 1
    device = phase_device(n_cards)
    log(f"[device] nvidia-smi: {nvidia_smi_line()}")
    if args.four_cards:
        phases = [("mux_dp", phase_mux_dp),
                  ("time_sharded", phase_time_sharded)]
    else:
        phases = [("kernel_parity", phase_kernel_parity),
                  ("tx_snapshots", phase_tx_snapshots),
                  ("loopback_8k", phase_loopback),
                  ("loopback_hier", lambda: phase_loopback(
                      _hier_mode(), snr_db=10.0)),
                  ("streaming", phase_streaming),
                  ("gpu_tests", phase_gpu_tests)]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
            log(f"[phase] {name} PASS ({time.perf_counter() - t0:.1f} s)")
        except Exception:  # noqa: BLE001 — report every phase, then fail
            traceback.print_exc()
            log(f"[phase] {name} FAIL ({time.perf_counter() - t0:.1f} s)")
            failed.append(name)
    peak = jax.devices()[0].memory_stats().get("peak_bytes_in_use")
    log(f"[device] peak_bytes_in_use={peak}")
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


def _hier_mode():
    from dvbt_tpu.mode import DvbtMode
    return DvbtMode(**HIER_MODE_ARGS)


if __name__ == "__main__":
    sys.exit(main())
