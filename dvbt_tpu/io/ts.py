"""MPEG-TS test-stream generation and validation.

The reference's integration tests feed a real MPEG-TS file through the TX
chain (SURVEY.md §4 "apps/ are the de-facto integration tests").  For
deterministic loopback tests and benchmarks we synthesize valid-looking TS:
0x47 sync, incrementing continuity pattern, seeded pseudo-random payload.
"""

from __future__ import annotations

import numpy as np

TS_PACKET = 188
SYNC = 0x47


def make_ts_packets(n_packets: int, seed: int = 0) -> np.ndarray:
    """(n_packets, 188) uint8 with valid sync bytes and seeded payload."""
    rng = np.random.default_rng(seed)
    pk = rng.integers(0, 256, size=(n_packets, TS_PACKET), dtype=np.uint8)
    pk[:, 0] = SYNC
    # put a recognizable header so byte slips are detectable in tests
    pk[:, 1] = (np.arange(n_packets) >> 8) & 0xFF
    pk[:, 2] = np.arange(n_packets) & 0xFF
    return pk


def read_ts_file(path: str) -> np.ndarray:
    """Load and packet-align a .ts file -> (n, 188) uint8 (truncates tail).

    Sync search runs in the native C++ framer (dvbt_tpu.native), mirroring
    the reference's R8/R10 sync-byte search."""
    from .. import native

    raw = np.fromfile(path, dtype=np.uint8)
    off = native.ts_find_sync(raw, confirm=2)
    if off < 0:
        raise ValueError("no MPEG-TS sync found")
    raw = raw[off:]
    n = len(raw) // TS_PACKET
    return raw[: n * TS_PACKET].reshape(n, TS_PACKET)


def write_ts_file(path: str, packets: np.ndarray) -> None:
    np.asarray(packets, dtype=np.uint8).tofile(path)
