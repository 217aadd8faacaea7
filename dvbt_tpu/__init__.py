"""dvbt_tpu — a DVB-T (ETSI EN 300 744) modem framework in JAX for an NVIDIA
H100.

A from-scratch re-design of the capability surface of BogdanDIA/gr-dvbt
(a GNU Radio out-of-tree module; see SURVEY.md) for accelerators: every DSP
block is a pure, statically-shaped, batched JAX function; the hot Viterbi
kernel is Pallas (Triton); the streaming runtime is replaced by super-block
processing with explicit carried-state pytrees; multi-device scaling uses
`shard_map` over a device mesh with XLA collectives.

Layout:
  mode.py / tables.py   — mode config + every EN300744 constant table
  ops/                  — the 15 DSP blocks (T1..T8, R1..R10 in SURVEY.md §2)
  kernels/              — Pallas GPU kernels (Viterbi ACS)
  models/               — composed TX / RX / loopback chains ("flowgraphs")
  parallel/             — meshes, sharding, halo/state exchange
  io/                   — MPEG-TS generation/validation, file IO
  utils/                — bit packing, metrics
"""

from .mode import DvbtMode, MODE_2K_QPSK, MODE_8K_UK  # noqa: F401

__version__ = "0.1.0"
