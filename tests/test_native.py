"""Native C++ host runtime: ring buffer semantics + TS framer (the GNU Radio
runtime-services equivalent, SURVEY.md layer map / R8+R10 sync search)."""

import numpy as np
import pytest

from dvbt_tpu import native


def test_native_library_builds():
    # the image ships g++; the native path must actually be in use
    assert native.available(), native._build_error


def test_ring_roundtrip_and_wrap():
    rb = native.RingBuffer(capacity=1000, max_read=256, dtype=np.uint8)
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, 10_000, dtype=np.uint8)
    out = []
    pos = 0
    while pos < len(data) or rb.readable:
        if pos < len(data):
            pos += rb.write(data[pos: pos + 333])
        while rb.readable >= 100:
            view = rb.peek(100)
            out.append(np.array(view))
            rb.consume(100)
    got = np.concatenate(out)
    assert np.array_equal(got, data[: len(got)])
    assert len(got) == 10_000


def test_ring_peek_contiguous_across_wrap():
    rb = native.RingBuffer(capacity=256, max_read=128, dtype=np.uint8)
    rb.write(np.arange(200, dtype=np.uint8))
    rb.consume(200)
    # next write wraps the power-of-two boundary (cap=256)
    rb.write(np.arange(100, dtype=np.uint8))
    v = rb.peek(100)
    assert v is not None and np.array_equal(v, np.arange(100, dtype=np.uint8))


def test_ring_complex_dtype():
    rb = native.RingBuffer(capacity=64, max_read=32, dtype=np.complex64)
    x = (np.arange(20) + 1j * np.arange(20)).astype(np.complex64)
    rb.write(x)
    v = rb.peek(20)
    assert np.array_equal(v, x)


def test_ts_find_sync_and_quality():
    rng = np.random.default_rng(1)
    pk = rng.integers(0, 256, (30, 188), dtype=np.uint8)
    pk[:, 0] = 0x47
    pk[7, 0] = 0xB8  # dispersal-inverted sync also counts
    stream = np.concatenate([rng.integers(0, 256, 101, dtype=np.uint8),
                             pk.reshape(-1)])
    off = native.ts_find_sync(stream, confirm=5)
    assert off == 101 or (stream[off] in (0x47, 0xB8)
                          and stream[off + 188] in (0x47, 0xB8))
    aligned = stream[101:]
    assert native.ts_sync_quality(aligned) == 1.0
    assert native.ts_sync_quality(stream[:101 + 188 * 3]) < 1.0


def test_library_path_is_keyed_on_source_and_flags(tmp_path, monkeypatch):
    """A checkout must never load a library built from other source: the
    build product's name carries a hash of ringbuffer.cc and the flags."""
    path = native.lib_path()
    assert path.startswith(native._BUILD_DIR)
    src = tmp_path / "ringbuffer.cc"
    src.write_bytes(open(native._SRC, "rb").read() + b"\n// edited\n")
    monkeypatch.setattr(native, "_SRC", str(src))
    assert native.lib_path() != path
    monkeypatch.undo()
    monkeypatch.setattr(native, "_FLAGS", native._FLAGS + ("-g",))
    assert native.lib_path() != path
