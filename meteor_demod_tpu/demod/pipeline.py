"""Host-side stream driver: blocks in, soft symbols out.

Feeds fixed-size sample blocks through the jitted block demodulator,
carries state across blocks, watches the safety flags, and falls back to the
exact scalar oracle for any flagged block (pathological inputs only) and for
the sub-block tail at EOF. The result is sample-exact regardless of block
size or how the input was chunked.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

import functools

from ..config import DemodConfig
from ..dsp.fir import f32_to_iq, iq_to_f32
from .state import DemodCarry, init_carry
from . import scalar

_SYM_DTYPE = [("re", np.float32), ("im", np.float32), ("locked_once", np.int32)]


@functools.lru_cache(maxsize=16)
def _jit_chained_single(cfg: DemodConfig, k: int, backend: str):
    """Jitted chain of k single-stream blocks per dispatch: one upload, one
    carry hand-off on device, one result fetch — amortizes the per-dispatch
    launch and host round trip."""
    from .backend import make_single_demod
    step = make_single_demod(cfg, backend)

    def run(carry, blocks):            # blocks: (k, L, 2)
        return jax.lax.scan(step, carry, blocks)

    return jax.jit(run)


def egress(tree):
    """Fetch a pytree of device arrays to numpy (one device_get)."""
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def numpy_carry_to_scalar_state(cfg: DemodConfig, c: dict) -> dict:
    """Already-egressed numpy carry leaves (unbatched) -> scalar oracle state."""
    return dict(
        t_phase=np.float32(c["t_phase"]), t_freq=np.float32(c["t_freq"]),
        t_prev=np.float32(c["t_prev"]),
        p_phase=np.float32(c["p_phase"]), p_freq=np.float32(c["p_freq"]),
        p_err=np.float32(c["p_err"]),
        locked=int(c["locked"]), locked_once=int(c["locked_once"]),
        updown=np.float32(c["updown"]),
        agc_gain=np.float32(c["agc_gain"]),
        agc_bias=np.complex64(complex(c["agc_bias_re"], c["agc_bias_im"])),
        inphase=np.float32(c["inphase"]), slot=int(c["slot"]),
        fir_tail=f32_to_iq(np.asarray(c["fir_tail"], dtype=np.float32)),
    )


def carry_to_scalar_state(cfg: DemodConfig, carry: DemodCarry) -> dict:
    return numpy_carry_to_scalar_state(cfg, egress(carry)._asdict())


def scalar_state_to_numpy_carry(cfg: DemodConfig, st: dict) -> dict:
    """Scalar oracle state -> dict of unbatched numpy DemodCarry leaves
    (tick reset, flags cleared — the oracle result is exact)."""
    bias = np.complex64(st["agc_bias"])
    return dict(
        t_phase=np.float32(st["t_phase"]), t_freq=np.float32(st["t_freq"]),
        t_prev=np.float32(st["t_prev"]),
        p_phase=np.float32(st["p_phase"]), p_freq=np.float32(st["p_freq"]),
        p_err=np.float32(st["p_err"]),
        locked=np.int32(st["locked"]), locked_once=np.int32(st["locked_once"]),
        updown=np.float32(st["updown"]), agc_gain=np.float32(st["agc_gain"]),
        agc_bias_re=np.float32(bias.real), agc_bias_im=np.float32(bias.imag),
        inphase=np.float32(st["inphase"]), slot=np.int32(st["slot"]),
        tick=np.int32(0),
        fir_tail=iq_to_f32(np.asarray(st["fir_tail"], dtype=np.complex64)),
        flags=np.int32(0),
    )


def scalar_state_to_carry(cfg: DemodConfig, st: dict) -> DemodCarry:
    base = init_carry(cfg)
    bias = np.complex64(st["agc_bias"])
    return base._replace(
        t_phase=jnp.float32(st["t_phase"]), t_freq=jnp.float32(st["t_freq"]),
        t_prev=jnp.float32(st["t_prev"]),
        p_phase=jnp.float32(st["p_phase"]), p_freq=jnp.float32(st["p_freq"]),
        p_err=jnp.float32(st["p_err"]),
        locked=jnp.int32(st["locked"]),
        locked_once=jnp.int32(st["locked_once"]),
        updown=jnp.float32(st["updown"]),
        agc_gain=jnp.float32(st["agc_gain"]),
        agc_bias_re=jnp.float32(bias.real),
        agc_bias_im=jnp.float32(bias.imag),
        inphase=jnp.float32(st["inphase"]), slot=jnp.int32(st["slot"]),
        fir_tail=jnp.asarray(iq_to_f32(np.asarray(st["fir_tail"],
                                                  dtype=np.complex64))),
    )


def _outputs_to_symbols(outs) -> np.ndarray:
    """outs: already-egressed numpy BlockOutput."""
    valid = np.asarray(outs.valid).astype(bool)
    re = np.asarray(outs.sym_re)[valid]
    im = np.asarray(outs.sym_im)[valid]
    lo = np.asarray(outs.locked_once)[valid]
    symbols = np.zeros(len(re), dtype=_SYM_DTYPE)
    symbols["re"] = re
    symbols["im"] = im
    symbols["locked_once"] = lo
    return symbols


class StreamDemodulator:
    """Stateful streaming demodulator over arbitrary-size input chunks.

    Mirrors the reference worker thread's contract (main.c:284-329): feed IQ
    samples in, get soft symbols out, with telemetry getters for the UI
    (pll.c:46-48, timing.c:29, agc.c:27-31).
    """

    def __init__(self, cfg: DemodConfig, backend: str = "auto",
                 span_turbo: bool = False, span_chunks: int = 32,
                 span_blocks: int = 16, sweep_rescue_s: float = 0.0):
        cfg.validate()
        self.cfg = cfg
        from .backend import jit_single_demod
        self._fn = jit_single_demod(cfg, backend)
        self._backend = backend
        # Speculative span mode: when a full span of input is buffered
        # (file-backed or bursty streams), demodulate it chunk-parallel
        # across span_chunks batch lanes with the gauge fixpoint
        # (demod/turbo.py demod_span_turbo) instead of the sequential
        # block chain — the strict-turbo acceptance contract (verified
        # lane prefix, decision-final by induction; OQPSK additionally
        # shrunk to an even-gauge boundary; anything unverified stays
        # buffered or falls to the sequential path). Opt-in: the CLI's -T
        # enables it for stdin/live inputs.
        self.span_turbo = bool(span_turbo)
        self.span_chunks = span_chunks
        self.span_blocks = span_blocks
        self.spans_run = 0
        self.span_fallbacks = 0
        self._prewarm = None
        self._carry = init_carry(cfg)
        self._pending = np.zeros(0, dtype=np.complex64)
        self.fallback_blocks = 0
        self.symbols_out = 0
        # Dispatch pipeline: up to `lookahead` blocks are in flight before
        # their results are fetched, hiding the device->host round trip
        # behind the next block's compute. Entries: (prev_carry, block_np,
        # carry, outs).
        self.lookahead = 2
        self._inflight = []
        self._backlog = []
        # When this many blocks are buffered, they are dispatched as ONE
        # chained device call (one upload, one fetch) — the fast path for
        # file inputs and bursty streams.
        self.chain_blocks = 8
        # Host-side telemetry snapshot, refreshed by the processing thread
        # after each block. UI threads read these plain floats — no
        # device->host transfers off the worker thread (PJRT clients need
        # not be re-entrant, and a UI read must never sync the stream).
        self._telemetry = dict(
            p_freq=0.0, t_freq=float(cfg.timing_freq), locked=False,
            locked_once=False, agc_gain=1.0)
        # Sweep rescue (opt-in; 0 = off = exact reference acquisition):
        # the reference's upward-first sweep has a measured dead zone for
        # small-negative carrier offsets (a stable false equilibrium near
        # 0 Hz that -195 Hz @ 25 dB never escapes — the C binary shares
        # the stall; pll.c:109-130, docs/PERF.md). After sweep_rescue_s
        # seconds of unlocked signal the carry is kicked host-side onto
        # the downward escape pass (p_freq=+fmax, updown=-1), which
        # captures every in-range carrier (~4 s transit). Same mechanism
        # as FleetDemodulator.sweep_rescue_s; CLI: --sweep-rescue.
        self.sweep_rescue_s = float(sweep_rescue_s)
        self._rescue_pending_samples = 0
        # Post-kick cooldown: a full downward pass takes 2*fmax/SWEEP_STEP
        # symbols; re-kicking before the pass completes would reset the
        # sweep forever. The counter goes negative after a kick so the
        # next one waits transit + budget.
        from ..constants import SWEEP_STEP
        self._rescue_transit_samples = int(
            2.0 * float(cfg.pll_fmax) / SWEEP_STEP
            * cfg.samplerate / cfg.symrate)

    def _set_telemetry(self, p_freq, t_freq, locked, locked_once,
                       agc_gain) -> None:
        self._telemetry = dict(
            p_freq=float(p_freq), t_freq=float(t_freq),
            locked=bool(locked), locked_once=bool(locked_once),
            agc_gain=float(agc_gain))

    def _publish_telemetry(self) -> None:
        c = self._carry
        vals = egress((c.p_freq, c.t_freq, c.locked, c.locked_once, c.agc_gain))
        self._set_telemetry(*vals)

    # -- telemetry (reference getter parity) --------------------------------
    @property
    def pll_freq(self) -> float:
        return self._telemetry["p_freq"]

    @property
    def pll_locked(self) -> bool:
        return self._telemetry["locked"]

    @property
    def pll_locked_once(self) -> bool:
        return self._telemetry["locked_once"]

    @property
    def mm_omega(self) -> float:
        return self._telemetry["t_freq"]

    @property
    def agc_gain(self) -> float:
        return self._telemetry["agc_gain"]

    def carrier_freq_hz(self) -> float:
        """Estimated carrier offset in Hz (main.c:231 conversion)."""
        mult = 2 if self.cfg.oqpsk else 1
        return self.pll_freq * self.cfg.symrate / (2 * np.pi) * mult

    def symbol_rate_hz(self) -> float:
        """Estimated symbol rate in Hz (main.c:232 conversion)."""
        return (self.mm_omega * self.cfg.samplerate * self.cfg.interp
                / (2 * np.pi))

    # -- processing ----------------------------------------------------------
    def process(self, samples: np.ndarray) -> np.ndarray:
        """Feed samples (any length, complex64); returns produced symbols.

        Span-turbo mode BUFFERS sub-span input instead of draining it
        through the sequential paths — per-chunk feeding (the CLI's stdin
        loop delivers ~8k-sample pieces) must still accumulate the
        span_chunks*span_blocks*block_len samples a span submission needs,
        so the drain loops only run in non-span mode (and in finish()).
        The cost is latency: span mode emits nothing until a full span has
        buffered (~18 s of live 230 ksps input at the CLI defaults) — the
        documented -T trade (cli.py). Also a device-access serialization
        point: until the first join_prewarm() below, span mode performs NO
        device operation on this thread, so the background prewarm thread
        (prewarm_span_async) is never concurrent with a dispatch."""
        self._pending = np.concatenate(
            [self._pending, np.asarray(samples, dtype=np.complex64)])
        L = self.cfg.block_len
        chunks, self._backlog = self._backlog, []
        if self.span_turbo:
            span_n = self.span_chunks * self.span_blocks * L
            # Pipelined spans: span k+1 is SUBMITTED from span k's exit
            # carry (final at submit time — demod/turbo.py SpanPending)
            # before span k's bulk symbol payload transfers and assembles,
            # overlapping the device->host link with the successor's
            # device compute.
            span_pend = None
            while len(self._pending) >= span_n:
                # The background prewarm compiled the span programs while
                # the input buffered; wait for it (normally already done)
                # so the first real span dispatches on a warm cache — and
                # so no two threads ever touch the device concurrently.
                self.join_prewarm()
                self.sync()
                chunks.extend(self._backlog)
                self._backlog = []
                pend = self._submit_span(self._pending[:span_n])
                if pend is None:
                    # Unverified span: bounded sequential progress (one
                    # chained dispatch) so the buffer cannot grow without
                    # bound, then retry the span path on the shifted
                    # buffer. Never wrong output, worst case one redundant
                    # pass over the consumed prefix.
                    seq = self._pending[:self.chain_blocks * L]
                    self._pending = self._pending[self.chain_blocks * L:]
                    chunks.append(self._run_chained(seq))
                    continue
                if span_pend is not None:
                    chunks.append(self._finish_span(span_pend))
                span_pend = pend
            if span_pend is not None:
                chunks.append(self._finish_span(span_pend))
        else:
            self._drain_blocks(chunks)
        if self.sweep_rescue_s > 0:
            self._maybe_sweep_kick(len(samples))
        if chunks:
            out = np.concatenate(chunks)
            self.symbols_out += len(out)
            return out
        return np.zeros(0, dtype=_SYM_DTYPE)

    def _maybe_sweep_kick(self, n_samples: int) -> None:
        """Count unlocked signal; kick the carry onto the downward escape
        sweep when the budget is exceeded (see __init__)."""
        if self.span_turbo:
            # Span mode buffers ~18 s before any device op: the budget
            # would count buffered (undemodulated) samples and kick a
            # carry that has seen no signal — and the egress below would
            # break the span path's single-thread device-access rule.
            return
        if self._telemetry["locked"]:
            self._rescue_pending_samples = 0
            return
        self._rescue_pending_samples += n_samples
        if (self._rescue_pending_samples
                < self.sweep_rescue_s * self.cfg.samplerate):
            return
        self.sync()
        leaves = {k: np.asarray(v)
                  for k, v in egress(self._carry)._asdict().items()}
        if int(leaves["locked"]):        # locked since the last refresh
            self._rescue_pending_samples = 0
            return
        leaves["p_freq"] = np.float32(self.cfg.pll_fmax)
        leaves["updown"] = np.float32(-1.0)
        from .state import DemodCarry
        self._carry = DemodCarry(**leaves)
        self._publish_telemetry()
        self._rescue_pending_samples = -self._rescue_transit_samples

    def _drain_blocks(self, chunks: list) -> None:
        """Drain _pending through the chained / single-block device paths
        down to a sub-block tail, appending symbol arrays to `chunks`."""
        L = self.cfg.block_len
        while len(self._pending) >= self.chain_blocks * L:
            # Drain in-flight singles first and FLUSH their symbols into the
            # output now — emitting them later would reorder the stream.
            self.sync()
            chunks.extend(self._backlog)
            self._backlog = []
            span = self._pending[:self.chain_blocks * L]
            self._pending = self._pending[self.chain_blocks * L:]
            chunks.append(self._run_chained(span))
        while len(self._pending) >= L:
            block, self._pending = self._pending[:L], self._pending[L:]
            chunks.append(self._run_block(block))

    def prewarm_span_async(self) -> None:
        """Compile + warm the span-turbo programs on a ZERO-signal span in
        a background thread (span mode only; idempotent).

        A real span needs span_chunks*span_blocks*block_len buffered
        samples (~18 s of live 230 ksps input at the defaults) before the
        first submission, but that first submission pays the span
        program's compile + first-dispatch cost. Starting the warmup at
        CLI start overlaps it with the buffering period, so the first
        REAL span's latency is data-dependent only. The warm span's
        blocks are jnp.zeros created ON device (nothing crosses the host
        link); its submission verifies nothing (consumed == 0, unlocked
        zero signal) and is discarded — only the compiled programs
        persist.

        Device-access serialization: PJRT clients need not be re-entrant,
        so the prewarm must never run concurrently with a dispatch. In
        span mode process() performs NO device operation
        until a full span has buffered, and joins this thread before its
        first dispatch (span, chained fallback, or finish-time drain
        alike) — the prewarm therefore has the device to itself for the
        whole buffering window."""
        if not self.span_turbo or self._prewarm is not None:
            return
        import threading
        # Capture the carry OBJECT here (immutable tree; process() only
        # rebinds self._carry) — every device op, including the snapshot
        # egress and the compile, happens on the BACKGROUND thread, never
        # the caller's.
        carry_ref = self._carry

        def work():
            from .turbo import (span_submit, span_finish,
                                default_warmup_blocks)
            carry0 = jax.tree_util.tree_map(np.asarray, egress(carry_ref))
            L, C, kb = self.cfg.block_len, self.span_chunks, self.span_blocks
            xf = np.zeros((C * kb * L, 2), np.float32)
            kb_w = min(default_warmup_blocks(L, kb), kb)
            bd = jnp.zeros((kb, C, L, 2), jnp.float32)
            wd = jnp.zeros((kb_w, C, L, 2), jnp.float32)
            pend = span_submit(self.cfg, carry0, xf, chunks=C,
                               backend=self._backend,
                               blocks_dev=bd, wblocks_dev=wd)
            span_finish(self.cfg, pend)

        self._prewarm = threading.Thread(target=work, daemon=True)
        self._prewarm.start()

    def join_prewarm(self) -> None:
        """Wait for a running span prewarm to finish (idempotent).

        MUST be called before process exit (finish() does; the CLI also
        joins on its shutdown path): the prewarm thread is a daemon, and a
        daemon killed mid-dispatch at interpreter exit can abort the
        process."""
        if self._prewarm is not None:
            self._prewarm.join()
            self._prewarm = None

    def _submit_span(self, span: np.ndarray):
        """Dispatch a buffered span chunk-parallel (turbo.span_submit).

        Consumes the verified prefix from _pending and installs its exit
        carry immediately (acceptance is decided by the small egress
        alone); returns the SpanPending whose symbols _finish_span
        retrieves, or None when nothing verified (the caller falls
        through to the sequential chained path — never wrong output,
        worst case one redundant pass over the span)."""
        from .turbo import span_submit
        pend = span_submit(self.cfg, egress(self._carry),
                           iq_to_f32(span), chunks=self.span_chunks,
                           backend=self._backend)
        self.spans_run += 1
        if pend.consumed == 0:
            self.span_fallbacks += 1
            return None
        self._pending = self._pending[pend.consumed:]
        self._carry = jax.tree_util.tree_map(jnp.asarray, pend.exit_carry)
        ec = pend.exit_carry
        self._set_telemetry(ec.p_freq, ec.t_freq, ec.locked,
                            ec.locked_once, ec.agc_gain)
        return pend

    def _finish_span(self, pend) -> np.ndarray:
        """Transfer + assemble a submitted span's symbols (turbo
        .span_finish)."""
        from .turbo import span_finish
        return span_finish(self.cfg, pend).symbols

    def _run_chained(self, span: np.ndarray) -> np.ndarray:
        """Demodulate chain_blocks consecutive blocks in one dispatch."""
        k = self.chain_blocks
        L = self.cfg.block_len
        fn = _jit_chained_single(self.cfg, k, self._backend)
        prev_carry = self._carry
        blocks = jnp.asarray(iq_to_f32(span).reshape(k, L, 2))
        carry, outs = fn(prev_carry, blocks)
        flags, p_freq, t_freq, locked, locked_once, agc_gain, outs_np = egress(
            (carry.flags, carry.p_freq, carry.t_freq, carry.locked,
             carry.locked_once, carry.agc_gain, outs))
        if int(flags) != 0:
            # Safety net: recompute the span with the scalar oracle, block by
            # block, so the timing-gate rounding at internal block boundaries
            # matches the per-block path (_drain_one) bit-for-bit.
            self.fallback_blocks += k
            st = carry_to_scalar_state(self.cfg, prev_carry)
            parts = []
            for i in range(k):
                sym, st = scalar.demod_stream_np(
                    self.cfg, span[i * L:(i + 1) * L], st)
                parts.append(sym)
            symbols = np.concatenate(parts)
            self._carry = scalar_state_to_carry(self.cfg, st)
            self._publish_telemetry()
            return symbols
        self._carry = carry
        self._set_telemetry(p_freq, t_freq, locked, locked_once, agc_gain)
        # outs leaves are (k, S); row-major flattening is chronological.
        return _outputs_to_symbols(outs_np)

    def _run_block(self, block: np.ndarray) -> np.ndarray:
        prev_carry = self._carry
        carry, outs = self._fn(prev_carry, jnp.asarray(iq_to_f32(block)))
        self._inflight.append((prev_carry, block, carry, outs))
        self._carry = carry
        if len(self._inflight) > self.lookahead:
            return self._drain_one()
        return np.zeros(0, dtype=_SYM_DTYPE)

    def _drain_one(self) -> np.ndarray:
        """Fetch the oldest in-flight block's results (flags, telemetry,
        symbols); on a safety flag, recompute it with the scalar oracle and
        replay every younger in-flight block from the corrected carry."""
        prev_carry, block, carry, outs = self._inflight.pop(0)
        flags, p_freq, t_freq, locked, locked_once, agc_gain, outs_np = egress(
            (carry.flags, carry.p_freq, carry.t_freq, carry.locked,
             carry.locked_once, carry.agc_gain, outs))
        if int(flags) != 0:
            # Safety net: the flagged block invalidates everything dispatched
            # after it. Recompute it exactly with the scalar oracle, then
            # re-dispatch the younger blocks from the corrected carry.
            self.fallback_blocks += 1
            st = carry_to_scalar_state(self.cfg, prev_carry)
            symbols, st = scalar.demod_stream_np(self.cfg, block, st)
            self._carry = scalar_state_to_carry(self.cfg, st)
            replay = [b for (_, b, _, _) in self._inflight]
            self._inflight = []
            for b in replay:
                pc = self._carry
                c2, o2 = self._fn(pc, jnp.asarray(iq_to_f32(b)))
                self._inflight.append((pc, b, c2, o2))
                self._carry = c2
            self._publish_telemetry()
            return symbols
        self._set_telemetry(p_freq, t_freq, locked, locked_once, agc_gain)
        return _outputs_to_symbols(outs_np)

    def sync(self) -> None:
        """Drain the dispatch pipeline, buffering its symbols for the next
        process()/finish() return. Leaves _carry/_pending authoritative —
        call before serializing state (io/checkpoint.py does)."""
        while self._inflight:
            self._backlog.append(self._drain_one())

    def finish(self) -> np.ndarray:
        """Drain the dispatch pipeline and any buffered full blocks (span
        mode can hold up to a whole span), then process the remaining
        sub-block tail via the exact oracle."""
        self.join_prewarm()     # never exit mid-compile/mid-dispatch
        self.sync()
        chunks, self._backlog = self._backlog, []
        self._drain_blocks(chunks)
        self.sync()
        chunks.extend(self._backlog)
        self._backlog = []
        if len(self._pending):
            st = carry_to_scalar_state(self.cfg, self._carry)
            symbols, st = scalar.demod_stream_np(self.cfg, self._pending, st)
            self._carry = scalar_state_to_carry(self.cfg, st)
            self._pending = np.zeros(0, dtype=np.complex64)
            self._publish_telemetry()
            chunks.append(symbols)
        out = (np.concatenate(chunks) if chunks
               else np.zeros(0, dtype=_SYM_DTYPE))
        self.symbols_out += len(out)
        return out


def demod_array(cfg: DemodConfig, x: np.ndarray) -> np.ndarray:
    """One-shot demodulation of a full array (tests / offline use)."""
    d = StreamDemodulator(cfg)
    out = [d.process(x), d.finish()]
    return np.concatenate(out)


def quantize_symbols(symbols: np.ndarray) -> np.ndarray:
    """Soft symbols -> interleaved int8 bytes (main.c:305-306 semantics:
    component/2, clamped to +-127, truncated toward zero). Native fast path
    in native/meteor_io.cc when built."""
    from ..io import native
    out = native.quantize_soft(symbols["re"], symbols["im"])
    if out is not None:
        return out
    out = np.empty(2 * len(symbols), dtype=np.int8)
    re = np.trunc(np.clip(symbols["re"] * np.float32(0.5), -127.0, 127.0))
    im = np.trunc(np.clip(symbols["im"] * np.float32(0.5), -127.0, 127.0))
    out[0::2] = re.astype(np.int8)
    out[1::2] = im.astype(np.int8)
    return out
