"""Streaming receiver: host-side lock FSM over the jitted sync/track/rx ops.

Reference behavior: the lock/re-acquire state machine of
`lib/ofdm_sym_acquisition_impl.cc` plus the sync-search of
`demod_reference_signals` (SURVEY.md R1/R3, §5.3 "signal-level fault
tolerance") [unverified — mount empty].

Design (SURVEY.md §7 design stance): all per-sample work happens
in two jitted programs — `sync` (full search, run only when unlocked) and
`track_rx` (NCO derotation fused with the symbol-aligned decode chain, the
locked steady state).  The FSM itself is a few dozen lines of host Python
that moves a stream offset forward and watches the RS uncorrectable counter
to decide when lock is lost; this mirrors the reference's acquisition FSM
but at super-block granularity instead of per-sample.

Deployable throughput (VERDICT r2 item 4): with ``pipeline=K`` the receiver
keeps up to K blocks in flight — the host dispatches the fused program for
block N+1 while block N is still computing, and only finalizes (device->host
fetch, credibility check, SCO nudge) K blocks behind.  Lock-loss detection
and SCO corrections therefore lag K blocks, which is fine for a control loop
whose plant drifts at ppm scale; ``pipeline=0`` (default) preserves the
fully synchronous semantics.
"""

from __future__ import annotations

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..mode import SYMBOLS_PER_FRAME, DvbtMode
from ..ops import sync as syncop
from ..utils.cplx import cis
from . import rx as rxm


@dataclasses.dataclass
class StreamReport:
    """One decoded block: packets + the metrics of SURVEY.md §5.5."""
    packets: np.ndarray          # uint8 (P, 188)
    stream_offset: int           # sample index of the block start
    reacquired: bool
    rs_corrected: np.ndarray
    rs_uncorrectable: np.ndarray
    info: dict                   # sync estimates (only fresh on reacquire)
    packets_lp: np.ndarray | None = None   # hierarchical LP stream
    lp_rs_uncorrectable: np.ndarray | None = None
    timing_tau: float | None = None        # median symbol-timing offset (samp)
    timing_adj: int = 0                    # SCO correction applied after block


class StreamingReceiver:
    """Feed raw baseband samples in arbitrary chunks; get decoded TS blocks.

    Not jitted itself — this is the thin host FSM; all math is in the three
    compiled programs it drives.
    """

    def __init__(self, mode: DvbtMode, n_frames: int | None = None,
                 max_int_cfo: int = syncop.DEFAULT_MAX_INT_CFO,
                 relock_threshold: float = 0.5,
                 sco_tracking: bool = True,
                 pipeline: int = 0,
                 metrics: str = "full"):
        self.mode = mode
        if n_frames is None:
            n_frames = mode.frames_per_block
        assert n_frames % mode.frames_per_block == 0
        self.n_frames = n_frames
        self.block_samples = n_frames * SYMBOLS_PER_FRAME * mode.symbol_len
        self.capture_samples = syncop.min_capture_samples(mode, n_frames)
        self.sync = syncop.make_synchronizer(
            mode, self.capture_samples, n_frames, max_int_cfo=max_int_cfo)
        # metrics="min" drops the TPS/MER observability stages from the
        # compiled decode (the lock/SCO FSM only consumes rs_* and
        # timing_tau) — the deployable-throughput configuration
        rx, self.n_packets, _ = rxm.make_receiver(mode, n_frames,
                                                  metrics=metrics)
        self.rx = rx
        # ONE fused locked-path program: continuous-NCO derotation with the
        # SCO skip folded into the entry phase, then the full decode chain
        # — 1 dispatch per block instead of 2
        N, n_out = mode.fft_len, self.block_samples

        from ..ops import reference_signals as refsig
        retime_tail = refsig.make_chan_tail_retimer(mode)

        def _track_rx(rx_state, iq, cfo_frac, cfo_int, phase, adj):
            cfo = cfo_frac + cfo_int.astype(jnp.float32)
            phase = phase - 2.0 * np.pi * cfo * adj.astype(jnp.float32) / N
            n = jnp.arange(n_out, dtype=jnp.float32)
            aligned = (iq * cis(-2.0 * np.pi * cfo * n / N + phase)
                       ).astype(jnp.complex64)
            phase1 = jnp.mod(phase - 2.0 * np.pi * cfo * n_out / N,
                             2.0 * np.pi).astype(jnp.float32)
            # an SCO skip is a known delay change: re-phase the carried
            # pilot history so the time channel estimator stays coherent
            rx_state = dict(rx_state)
            rx_state["chan_tail"] = retime_tail(rx_state["chan_tail"], adj)
            rx_state, ts, metrics = rx(rx_state, aligned)
            return rx_state, phase1, ts, metrics

        self.track_rx = jax.jit(_track_rx)
        self.pipeline = pipeline
        self._inflight: collections.deque = collections.deque()
        self._pending_adj = 0    # SCO samples to skip at the next dispatch
        self._applied_adj = 0    # skip applied between last two dispatches
        self.relock_threshold = relock_threshold
        # native SPSC ring (C++ when the toolchain is present) so feed() is
        # O(chunk) and block reads are zero-copy contiguous views
        from .. import native
        self._ring = native.RingBuffer(
            capacity=4 * self.capture_samples,
            max_read=self.capture_samples, dtype=np.complex64)
        self._stream_pos = 0      # absolute sample index of the ring head
        self.locked = False
        self.cfo_frac = jnp.float32(0.0)
        self.cfo_int = jnp.int32(0)
        self.phase = jnp.float32(0.0)
        self.rx_state = rxm.init_rx_state(mode)
        self.last_info: dict = {}
        # SCO / fine-timing loop (SURVEY.md §2.2 R1: the reference re-times
        # every symbol; here the per-block pilot-slope estimate nudges the
        # stream offset): tau_ref is the timing readout captured right after
        # (re)acquisition, the controller consumes round(tau - tau_ref)
        # extra/fewer samples after each credible block.
        self.sco_tracking = sco_tracking
        self._tau_ref: float | None = None
        self._max_adj = max(1, mode.guard_len // 4)

    @property
    def stream_position(self) -> int:
        """Absolute sample index of the next sample the receiver will
        consume (block boundaries of the locked stream fall at
        stream_position + k * block_samples)."""
        return self._stream_pos

    def _need(self) -> int:
        return self.block_samples if self.locked else self.capture_samples

    def feed(self, samples: np.ndarray) -> list[StreamReport]:
        """Append samples; decode as many blocks as the buffer allows.

        With ``pipeline > 0`` up to that many blocks stay in flight on the
        device; call :meth:`flush` at end-of-stream to collect them.
        """
        samples = np.asarray(samples, np.complex64)
        out: list[StreamReport] = []
        pos = 0
        while pos < len(samples):
            pos += self._ring.write(samples[pos:])
            while self._ring.readable >= self._need():
                out += self._step()
        while self._ring.readable >= self._need():
            out += self._step()
        return out

    def flush(self) -> list[StreamReport]:
        """Finalize every in-flight block (device->host fetch)."""
        out = []
        while self._inflight:
            out.append(self._finalize())
        return out

    def _peek(self, n: int) -> np.ndarray:
        view = self._ring.peek(n)
        assert view is not None
        return view

    def _consume(self, n: int):
        self._ring.consume(n)
        self._stream_pos += n

    def _step(self) -> list[StreamReport]:
        if self.locked:
            self._dispatch()
            out = []
            while len(self._inflight) > self.pipeline:
                out.append(self._finalize())
            return out
        # stale in-flight blocks (dispatched before lock loss was detected)
        # drain before the full search so reports stay in stream order
        out = self.flush()
        out.append(self._acquire())
        return out

    def _dispatch(self) -> None:
        """Locked steady state: enqueue one fused track+decode program."""
        dev = jnp.asarray(self._peek(self.block_samples))   # async H2D
        self.rx_state, self.phase, ts, metrics = self.track_rx(
            self.rx_state, dev, self.cfo_frac, self.cfo_int, self.phase,
            jnp.int32(self._applied_adj))
        block_off = self._stream_pos
        adj = self._pending_adj
        self._pending_adj = 0
        self._consume(self.block_samples + adj)
        self._applied_adj = adj   # folded into the NEXT dispatch's NCO phase
        self._inflight.append((block_off, False, ts, metrics))

    def _acquire(self) -> StreamReport:
        """Unlocked: full search, then decode the first block synchronously
        through the same fused program (zero rotation)."""
        capture = jnp.asarray(self._peek(self.capture_samples))
        aligned, info = self.sync(capture)
        self.cfo_frac = info["cfo_frac"]
        self.cfo_int = info["cfo_int"]
        start = int(info["start"])
        self.last_info = {k: np.asarray(v) for k, v in info.items()}
        # resume the NCO where the sync block's derotation ended.  sync
        # accumulates the FRACTIONAL rotation from the capture origin
        # (n = 0 at capture start) but the INTEGER rotation from the block
        # origin (m = 0 at `start`, ops/sync.py) — resuming both from the
        # capture origin used to leave a constant phase jump of
        # -2*pi*cfo_int*start/N at the acquire->track seam.  Invisible to
        # per-symbol channel estimation, but it rotated the time
        # estimator's carried pilot history out of frame (first tracked
        # block decoded dirty whenever cfo_int != 0 and start % N != 0).
        end = start + self.block_samples
        self.phase = jnp.float32(
            (-2.0 * np.pi * (float(self.cfo_frac) * end
                             + float(self.cfo_int) * self.block_samples)
             / self.mode.fft_len) % (2.0 * np.pi))
        block_off = self._stream_pos + start
        self._consume(end)
        self.rx_state = rxm.init_rx_state(self.mode)
        self.locked = True
        self._pending_adj = 0
        self._applied_adj = 0
        # `aligned` is already fully CFO-corrected: run it through track_rx
        # with zero rotation so the receiver compiles ONE decode program
        self.rx_state, _, ts, metrics = self.track_rx(
            self.rx_state, aligned,
            jnp.float32(0.0), jnp.int32(0), jnp.float32(0.0), jnp.int32(0))
        return self._make_report(block_off, True, ts, metrics)

    def _finalize(self) -> StreamReport:
        return self._make_report(*self._inflight.popleft())

    def _make_report(self, block_off, reacq, ts, metrics) -> StreamReport:
        bad = np.asarray(metrics["rs_uncorrectable"])
        credible = bad.mean() <= self.relock_threshold

        # --- SCO / fine-timing loop (VERDICT r1 item 4) --------------------
        # corrections accumulate into _pending_adj and take effect at the
        # next dispatch — `pipeline` blocks late at worst, fine for a loop
        # tracking ppm-scale clock drift
        tau_med = None
        adj = 0
        if "timing_tau" in metrics:
            tau_med = float(np.median(np.asarray(metrics["timing_tau"])))
        if tau_med is not None and credible:
            if reacq or self._tau_ref is None:
                self._tau_ref = tau_med
            elif self.sco_tracking:
                adj = int(round(tau_med - self._tau_ref))
                adj = max(-self._max_adj, min(self._max_adj, adj))
                self._pending_adj = max(-self._max_adj, min(
                    self._max_adj, self._pending_adj + adj))

        if not reacq and not credible:
            self.locked = False  # lock lost: next block does a full search
            self._tau_ref = None
        hier = isinstance(ts, tuple)
        return StreamReport(
            packets=np.asarray(ts[0] if hier else ts),
            stream_offset=block_off,
            reacquired=reacq,
            rs_corrected=np.asarray(metrics["rs_corrected"]),
            rs_uncorrectable=bad,
            info=self.last_info,
            packets_lp=np.asarray(ts[1]) if hier else None,
            lp_rs_uncorrectable=(np.asarray(metrics["lp_rs_uncorrectable"])
                                 if hier else None),
            timing_tau=tau_med,
            timing_adj=adj,
        )

    # --- checkpoint / resume (SURVEY.md §5.4) -----------------------------
    def save(self, path: str) -> None:
        """Serialize the full receiver state (carried pytree + lock FSM +
        sample buffer) for mid-stream resume."""
        from ..utils import checkpoint as ckpt
        self.flush()   # in-flight blocks must land in rx_state before saving
        # drain in <= max_read chunks (ring_peek returns NULL past max_read)
        # and write the samples straight back: content and readable count are
        # unchanged, only the internal head moves.
        chunks = []
        while self._ring.readable:
            chunk = np.array(self._ring.peek(
                min(self._ring.readable, self.capture_samples)))
            self._ring.consume(len(chunk))
            chunks.append(chunk)
        for chunk in chunks:
            wrote = self._ring.write(chunk)
            assert wrote == len(chunk)
        buf = (np.concatenate(chunks) if chunks
               else np.zeros((0,), np.complex64))
        ckpt.save_state(
            path, self.rx_state,
            buf=buf.view(np.float32),
            stream_pos=self._stream_pos,
            locked=self.locked,
            cfo_frac=np.asarray(self.cfo_frac),
            cfo_int=np.asarray(self.cfo_int),
            phase=np.asarray(self.phase),
        )

    def restore(self, path: str) -> None:
        from ..utils import checkpoint as ckpt
        state, extra = ckpt.load_state(path, rxm.init_rx_state(self.mode))
        self.rx_state = state
        from .. import native
        self._ring = native.RingBuffer(
            capacity=4 * self.capture_samples,
            max_read=self.capture_samples, dtype=np.complex64)
        self._ring.write(extra["buf"].view(np.complex64))
        self._stream_pos = int(extra["stream_pos"])
        self.locked = bool(extra["locked"])
        self.cfo_frac = jnp.float32(extra["cfo_frac"])
        self.cfo_int = jnp.int32(extra["cfo_int"])
        self.phase = jnp.float32(extra["phase"])
        self._inflight.clear()
        self._pending_adj = 0
        self._applied_adj = 0
