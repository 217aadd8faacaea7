"""Multi-host / multi-process scaffolding (SURVEY.md §2.4, §5.8).

The reference is strictly single-process; scaling past one host is an
addition here: `jax.distributed` federates the processes, a
``('hosts', 'chips')`` mesh places the mux-batch data-parallel axis over
the inter-host network x the intra-host links, and the existing shard_map
programs (parallel.sharding / parallel.time_sharding) run unchanged — XLA
routes the metric psums within a host first and across hosts second.

No multi-host hardware has been exercised; the 2-process CPU smoke test
(tests/test_multihost.py) validates the entry point, global mesh
construction, cross-process data placement and a cross-process collective
end-to-end:

    JAX_PLATFORMS=cpu x 2 processes
    -> jax.distributed.initialize + gloo CPU collectives
    -> global ('hosts','chips') mesh over 2x2 devices
    -> sharded DVB-T loopback step with psum'd fleet metrics.
"""

from __future__ import annotations

import numpy as np


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, local_device_count: int | None = None):
    """Join (or create) a multi-process JAX cluster.

    On accelerators this is a thin wrapper over
    ``jax.distributed.initialize`` (device counts come from the runtime;
    coordinator address, process count and id must be given explicitly).
    On CPU, ``local_device_count`` forces N virtual devices per process and
    selects the gloo collectives backend so cross-process psum/ppermute
    work — the test fabric for inter-host behavior without hardware.
    """
    import jax

    if local_device_count is not None:
        jax.config.update("jax_num_cpu_devices", local_device_count)
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return jax.process_count(), jax.device_count()


def make_host_chip_mesh(axis_names=("hosts", "chips")):
    """Global ('hosts', 'chips') mesh: process-major device grid.

    jax.devices() is process-major in a federated cluster, so reshaping to
    (process_count, devices_per_process) puts each row on one host — the
    'chips' axis rides ICI, the 'hosts' axis rides DCN.
    """
    import jax
    from jax.sharding import Mesh

    n_proc = jax.process_count()
    n_dev = jax.device_count()
    assert n_dev % n_proc == 0, (n_dev, n_proc)
    grid = np.asarray(jax.devices()).reshape(n_proc, n_dev // n_proc)
    return Mesh(grid, axis_names)


def make_multihost_loopback(mode, mesh, muxes_per_device: int = 1):
    """Mux-DP loopback over a 2-D ('hosts','chips') mesh.

    Same program as parallel.sharding.make_sharded_loopback but with the
    mux batch sharded over BOTH axes and the fleet-metric psum reducing
    over the full mesh (ICI + DCN).  Returns (step, make_local_batch,
    n_packets_per_mux, B_global).
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..models import rx as rxm, tx as txm

    axes = mesh.axis_names
    n_dev = mesh.devices.size
    B = n_dev * muxes_per_device
    tx, n_pk, _ = txm.make_transmitter(mode)
    rx, _, _ = rxm.make_receiver(mode)
    spec = P(axes)  # mux batch over hosts x chips

    def local_step(states, packets):
        tstates, rstates = states

        def one(ts_st, rx_st, pk):
            ts_st, iq = tx(ts_st, pk)
            rx_st, out, m = rx(rx_st, iq)
            return ts_st, rx_st, out, m

        tstates, rstates, out, m = jax.vmap(one)(tstates, rstates, packets)
        fleet = {
            "rs_corrected_total": jax.lax.psum(
                m["rs_corrected"].sum(), axes),
            "rs_uncorrectable_total": jax.lax.psum(
                m["rs_uncorrectable"].sum(), axes),
        }
        return (tstates, rstates), out, fleet

    step = jax.jit(jax.shard_map(
        local_step, mesh=mesh,
        in_specs=((spec, spec), spec),
        out_specs=((spec, spec), spec, P()),
        check_vma=False,
    ))

    def init_states():
        def rep(s):
            return jax.tree.map(
                lambda x: jnp.broadcast_to(x, (B,) + x.shape), s)
        sh = NamedSharding(mesh, spec)
        return (jax.device_put(rep(txm.init_tx_state(mode)), sh),
                jax.device_put(rep(rxm.init_rx_state(mode)), sh))

    def make_global_batch(local_packets: np.ndarray):
        """Assemble a global (B, P, 188) array from per-process local data
        (each process passes its own (B_local, P, 188) slab)."""
        sh = NamedSharding(mesh, spec)
        return jax.make_array_from_process_local_data(
            sh, local_packets, (B,) + local_packets.shape[1:])

    return step, init_states, make_global_batch, n_pk, B
