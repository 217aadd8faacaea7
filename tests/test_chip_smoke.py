"""chip_smoke.py rehearsed on the CPU: every phase function runs here at 2K
(the Viterbi kernel in the Pallas interpreter, the four-card phases on four
virtual CPU devices).  Only main() requires a GPU, and it refuses to run
without one."""

import os
import sys

import jax
import pytest

from dvbt_tpu.mode import MODE_2K_QPSK

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


@pytest.mark.parametrize("line,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", ("NVIDIA H100 80GB HBM3", 700.0)),
    ("NVIDIA H100 80GB HBM3, 400.00 W\n", ("NVIDIA H100 80GB HBM3", 400.0)),
    ("Some, Card, Name, 350 W", ("Some, Card, Name", 350.0)),
])
def test_parse_nvidia_smi(line, want):
    assert cs.parse_nvidia_smi(line) == want


def test_main_refuses_without_gpu(capsys):
    assert cs.main([]) != 0
    assert capsys.readouterr().out == ""


def test_bench_refuses_without_gpu(capsys):
    import bench
    assert bench.main() != 0
    assert capsys.readouterr().out == ""


def test_phase_device():
    dev = cs.phase_device()
    assert dev == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())}


@pytest.mark.parametrize("rate", cs.RATES)
def test_phase_kernel_parity(rate):
    out = cs.phase_kernel_parity(MODE_2K_QPSK, frames=1, n_mux=2,
                                 impl="pallas-interpret", rates=(rate,))
    assert out == {f"{rate}/hard": True, f"{rate}/soft": True}


def test_phase_tx_snapshots():
    out = cs.phase_tx_snapshots(["2k_qpsk_12"])
    assert out["2k_qpsk_12"] <= 2e-5


@pytest.mark.parametrize("hier", [False, True])
def test_phase_loopback(hier):
    mode = cs._hier_mode() if hier else MODE_2K_QPSK
    out = cs.phase_loopback(mode, frames=1, n_mux=2, impl="pallas-interpret",
                            snr_db=10.0 if hier else 4.0)
    assert out["noisy_rs_corrected"] > 0


def test_phase_streaming():
    out = cs.phase_streaming(MODE_2K_QPSK, n_blocks=6, delay=2345)
    assert out["blocks"] >= 3


def test_phase_mux_dp_four_devices():
    out = cs.phase_mux_dp(MODE_2K_QPSK, n_dev=4, muxes_per_device=2)
    assert out["mux_dp_s"] > 0


def test_phase_time_sharded_four_devices():
    out = cs.phase_time_sharded(MODE_2K_QPSK, n_dev=4)
    assert out["time_sharded_s"] > 0
