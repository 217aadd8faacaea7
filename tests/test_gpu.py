"""Card-only tests: the compiled (not interpreted) Pallas kernel and the
GPU numerics.  Marked ``gpu``; run them on the card with

    python -m pytest -m gpu tests/test_gpu.py

(chip_smoke.py runs them in its own process).  Elsewhere they skip: the
``gpu`` fixture decides at run time, never at import.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dvbt_tpu import tables
from dvbt_tpu.io import ts as tsio
from dvbt_tpu.mode import MODE_2K_QPSK, MODE_8K_UK
from dvbt_tpu.models import channel, rx as rxm, tx as txm
from dvbt_tpu.ops import inner_coder, mapper, viterbi as vj
from dvbt_tpu.utils import bits as bitutils

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX backend is "
                    f"{jax.default_backend()!r})")
    return jax.devices()[0]


@pytest.mark.parametrize("rate", ["1/2", "2/3", "3/4", "5/6", "7/8"])
def test_compiled_kernel_matches_jnp(gpu, rate):
    from dvbt_tpu.kernels import viterbi_triton as vt
    period = len(tables.PUNCTURE[rate][0])
    n_bits = 8 * period * 4000
    ov = vj.effective_overlap(rate)
    rng = np.random.default_rng(7)
    coder = inner_coder.make_inner_coder(n_bits // 8, rate)
    depunct = inner_coder.make_depuncture(n_bits, rate)
    dec_j = vj.make_viterbi_decoder(n_bits, overlap=ov)
    dec_k = vt.make_viterbi_decoder_punctured(n_bits, rate, overlap=ov)
    sj = sk = vj.init_state(ov)
    for blk in range(2):
        stream = jnp.asarray(rng.integers(0, 256, n_bits // 8, np.uint8))
        _, coded = coder(inner_coder.init_state(), stream)
        noisy = (7.5 + 7.5 * (2.0 * np.asarray(coded, np.float32) - 1.0)
                 + rng.normal(0, 5.0, coded.shape))
        soft = jnp.asarray(np.clip(np.round(noisy), 0, 15).astype(np.uint8))
        x, y, xm, ym = depunct(soft)
        xm = jnp.broadcast_to(xm, x.shape).astype(jnp.uint8)
        ym = jnp.broadcast_to(ym, y.shape).astype(jnp.uint8)
        sj, out_j = dec_j(sj, x, y, xm, ym)
        sk, out_k = dec_k(sk, soft)
        assert np.array_equal(np.asarray(out_k),
                              np.asarray(bitutils.bits_to_bytes(out_j)))
        for k in sj:
            assert np.array_equal(np.asarray(sj[k]), np.asarray(sk[k]))


def test_auto_receiver_uses_kernel_and_matches_jnp(gpu):
    assert rxm._resolve_viterbi_impl("auto") == "pallas"
    mode = MODE_2K_QPSK
    tx, n_pk, _ = txm.make_transmitter(mode)
    rx_a, _, _ = rxm.make_receiver(mode, demap="soft")
    rx_j, _, _ = rxm.make_receiver(mode, viterbi_impl="jnp", demap="soft")
    tst = txm.init_tx_state(mode)
    ra = rj = rxm.init_rx_state(mode)
    for blk in range(2):
        tst, iq = tx(tst, jnp.asarray(tsio.make_ts_packets(n_pk, seed=blk)))
        iq = channel.awgn(jax.random.PRNGKey(blk), iq, 4.0)
        ra, ts_a, m_a = rx_a(ra, iq)
        rj, ts_j, m_j = rx_j(rj, iq)
        assert np.array_equal(np.asarray(ts_a), np.asarray(ts_j))
        assert np.array_equal(np.asarray(m_a["rs_corrected"]),
                              np.asarray(m_j["rs_corrected"]))


def test_soft_demap_and_mapper_match_cpu(gpu):
    """The constellation and soft-demap products run at full float32
    precision on the card (no TF32), so they agree with the CPU."""
    mode = MODE_8K_UK
    cpu = jax.devices("cpu")[0]
    rng = np.random.default_rng(3)
    y = (rng.normal(size=4096) + 1j * rng.normal(size=4096)).astype(
        np.complex64)
    cells = rng.integers(0, 2 ** mode.v, 4096).astype(np.int32)
    demap, qmap = mapper.make_soft_demapper(mode), mapper.make_mapper(mode)
    on_gpu = (np.asarray(demap(jax.device_put(y, gpu))),
              np.asarray(qmap(jax.device_put(cells, gpu))))
    on_cpu = (np.asarray(demap(jax.device_put(y, cpu))),
              np.asarray(qmap(jax.device_put(cells, cpu))))
    assert np.array_equal(on_gpu[0], on_cpu[0])
    np.testing.assert_allclose(on_gpu[1], on_cpu[1], rtol=0, atol=1e-6)
