"""Multi-chip parallelism: mux-batch sharding over a device mesh.

The reference is single-process; its only parallelism is GNU Radio's
thread-per-block pipelining (SURVEY.md §2.4).  The multi-device scaling
axes:

* **mux batch (dp)** — independent DVB-T multiplexes (or independent time
  segments of one stream) sharded over a `('mux',)` mesh axis via shard_map;
  zero inter-device traffic on the data path, `psum` only for fleet
  metrics.
  This is the throughput axis for "N channels in real time".
* **time axis (sp)** — contiguous sample blocks of ONE stream across chips
  with carried-state neighbor exchange (`collective_permute`) — see
  time_sharding.py (SURVEY.md §5.7).

Per-mux carried state lives sharded next to its data, so a step is fully
local; scaling efficiency is bounded only by XLA dispatch overheads.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..mode import DvbtMode
from ..models import rx as rxm, tx as txm


def make_mux_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), ("mux",))


def make_sharded_loopback(mode: DvbtMode, mesh: Mesh,
                          muxes_per_device: int = 1):
    """Returns (step, init_states, n_packets_per_mux).

    step(states, packets): packets uint8 (B, P, 188) sharded over 'mux'
    -> (states', ts (B, P, 188), fleet_metrics) where B = mesh devices *
    muxes_per_device.  fleet_metrics are psum-reduced across the mesh
    (total RS corrections / failures — one small all-reduce).
    """
    n_dev = mesh.devices.size
    B = n_dev * muxes_per_device
    tx, n_pk, n_samp = txm.make_transmitter(mode)
    rx, _, _ = rxm.make_receiver(mode)

    def local_step(states, packets):
        # packets: (B/n_dev, P, 188) on this shard — hierarchical modes
        # carry an (hp, lp) pair of such arrays (vmap/shard_map treat the
        # tuple as a pytree, so the same specs apply per leaf)
        tstates, rstates = states

        def one(ts_st, rx_st, pk):
            ts_st, iq = tx(ts_st, pk)
            rx_st, out, m = rx(rx_st, iq)
            return ts_st, rx_st, out, m

        tstates, rstates, out, m = jax.vmap(one)(tstates, rstates, packets)
        fleet = {
            "rs_corrected_total": jax.lax.psum(
                m["rs_corrected"].sum(), "mux"),
            "rs_uncorrectable_total": jax.lax.psum(
                m["rs_uncorrectable"].sum(), "mux"),
        }
        if mode.hierarchical:
            fleet["lp_rs_uncorrectable_total"] = jax.lax.psum(
                m["lp_rs_uncorrectable"].sum(), "mux")
        return (tstates, rstates), out, fleet

    step = jax.jit(jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=((P("mux"), P("mux")), P("mux")),
        out_specs=((P("mux"), P("mux")), P("mux"), P()),
        check_vma=False,
    ))

    def init_states():
        def rep(s):
            return jax.tree.map(
                lambda x: jnp.broadcast_to(x, (B,) + x.shape), s)
        tstates = rep(txm.init_tx_state(mode))
        rstates = rep(rxm.init_rx_state(mode))
        sh = NamedSharding(mesh, P("mux"))
        return (jax.device_put(tstates, sh), jax.device_put(rstates, sh))

    return step, init_states, n_pk


def dryrun(mode: DvbtMode, n_devices: int, muxes_per_device: int = 1):
    """Compile + execute one sharded loopback step on the available devices.

    Used by __graft_entry__.dryrun_multichip and the multi-device tests:
    validates that the full chain, its carried-state pytrees, and the
    metric collectives all shard correctly.  Two stages, each logged
    start/pass so a non-zero exit is attributable from the output tail:

      1. mux-DP shard_map at `mode`, two steps.
      2. ppermute time-axis halo sharding at `mode`, one step.
    """
    import time

    def _log(msg):
        print(f"[dryrun] {msg}", flush=True)

    devices = jax.devices()
    assert len(devices) >= n_devices, (
        f"need {n_devices} devices, have {len(devices)}")
    from ..io import ts as tsio
    from . import time_sharding as tsh

    # --- stage 1: mux-DP ---------------------------------------------------
    t0 = time.monotonic()
    _log(f"stage 1/2 mux-dp start ({mode.transmission} {mode.constellation} "
         f"{mode.code_rate}, {n_devices} dev x {muxes_per_device} mux)")
    mesh = make_mux_mesh(devices[:n_devices])
    step, init_states, n_pk = make_sharded_loopback(
        mode, mesh, muxes_per_device)
    B = n_devices * muxes_per_device
    packets = np.stack([tsio.make_ts_packets(n_pk, seed=i) for i in range(B)])
    pk = jax.device_put(jnp.asarray(packets),
                        NamedSharding(mesh, P("mux")))
    states = init_states()
    states, out, fleet = step(states, pk)
    jax.block_until_ready(out)
    # second step re-uses the compiled program and the carried state
    states, out, fleet = step(states, pk)
    jax.block_until_ready(out)
    _log(f"stage 1/2 mux-dp PASS ({time.monotonic() - t0:.1f}s)")

    # --- stage 2: ppermute time-axis halo sharding -------------------------
    t0 = time.monotonic()
    _log("stage 2/2 time-ppermute start")
    tmesh = Mesh(np.asarray(devices[:n_devices]), ("time",))
    tstep, t_pk, carry = tsh.make_time_sharded_loopback(mode, tmesh)
    tpk = jax.device_put(
        jnp.asarray(tsio.make_ts_packets(t_pk * n_devices)),
        NamedSharding(tmesh, P("time")))
    carry, ts, tfleet = tstep(carry, tpk)
    jax.block_until_ready(ts)
    _log(f"stage 2/2 time-ppermute PASS ({time.monotonic() - t0:.1f}s)")
    return out, fleet
