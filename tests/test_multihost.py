"""2-process CPU smoke test of the multi-host scaffolding (SURVEY.md §5.8).

Spawns two worker processes that federate via jax.distributed (gloo CPU
collectives), build the global ('hosts','chips') mesh, and run one sharded
DVB-T loopback step whose fleet metric is a cross-process psum.  Each worker
checks byte-exactness of its local shard against the single-process chain.
"""

import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import sys
import numpy as np

pid = int(sys.argv[1])
port = sys.argv[2]

from dvbt_tpu.parallel import multihost

n_proc, n_dev = multihost.initialize(
    f"localhost:{port}", num_processes=2, process_id=pid,
    local_device_count=2)
assert (n_proc, n_dev) == (2, 4), (n_proc, n_dev)

import jax
import jax.numpy as jnp
from dvbt_tpu.io import ts as tsio
from dvbt_tpu.mode import MODE_2K_QPSK
from dvbt_tpu.models import rx as rxm, tx as txm

mode = MODE_2K_QPSK
mesh = multihost.make_host_chip_mesh()
assert mesh.devices.shape == (2, 2)
step, init_states, make_global_batch, n_pk, B = \
    multihost.make_multihost_loopback(mode, mesh)
assert B == 4

# per-process local muxes: process p owns global muxes [2p, 2p+1)
local = np.stack([tsio.make_ts_packets(n_pk, seed=2 * pid + i)
                  for i in range(2)])
packets = make_global_batch(local)
states = init_states()
states, out, fleet = step(states, packets)
states, out, fleet = step(states, packets)  # steady state (carried pytrees)
jax.block_until_ready(out)
bad = int(fleet["rs_uncorrectable_total"].addressable_data(0))
assert bad == 0, bad

# local shards must be byte-exact vs the single-process loopback.  Pair the
# input and output shards by their global index (no placement assumptions):
# rerun the reference chain on exactly the packet rows each device held.
tx, _, _ = txm.make_transmitter(mode)
rx, _, _ = rxm.make_receiver(mode)
in_by_index = {s.index[0].start or 0: np.asarray(s.data)
               for s in packets.addressable_shards}
checked = 0
for shard in out.addressable_shards:
    g0 = shard.index[0].start or 0
    got = np.asarray(shard.data)
    src = in_by_index[g0]
    for row in range(got.shape[0]):
        pk = jnp.asarray(src[row])
        tst, rst = txm.init_tx_state(mode), rxm.init_rx_state(mode)
        for _ in range(2):
            tst, iq = tx(tst, pk)
            rst, want, _ = rx(rst, iq)
        assert np.array_equal(got[row], np.asarray(want)), \
            f"global mux {g0 + row} mismatch"
        checked += 1
assert checked == 2

print(f"proc {pid} OK", flush=True)
"""


def test_two_process_cpu_cluster(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # the forced-8-device flag must not fight jax_num_cpu_devices
    env["PYTHONPATH"] = _REPO
    env.pop("XLA_FLAGS", None)
    port = "12861"
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(pid), port],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-4000:]}"
        assert f"proc {pid} OK" in out
