"""Static demodulator configuration and derived block geometry.

A DemodConfig is hashable and immutable: it is the jit-static half of the
demodulator. Everything data-dependent lives in DemodCarry (demod/state.py).

Geometry notes (the block restructuring): the reference processes one
sample at a time through stateful blocks (demod.c:23-48). Here a "block" is
L input samples. The polyphase FIR produces all L*interp interpolated
outputs ("ticks") of the block densely (one batched conv); the feedback loops
(timing NCO gate, AGC, Costas PLL, M&M retiming) all mutate state only when
the timing gate fires — once per symbol (QPSK) or twice (OQPSK, demod.c:62-87)
— so they run as a per-FIRE lax.scan of S steps, not a per-sample scan.
Window prematerialization: step k's FIR value is gathered once per block into
a (S, window) array of candidate ticks around the predicted fire position, so
the scan body contains no dynamic indexing at all.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from . import constants as C
from .dsp.loops import loop_gains

_F32 = np.float32


@dataclasses.dataclass(frozen=True)
class DemodConfig:
    samplerate: int
    symrate: float = C.SYM_RATE
    interp: int = C.INTERP_FACTOR
    rrc_order: int = C.RRC_ORDER
    rrc_alpha: float = C.RRC_ALPHA
    pll_bw: float = C.PLL_BW
    sym_bw: float = C.SYM_BW
    oqpsk: bool = False
    # Max carrier deviation in rad/sample at the symbol rate; negative means
    # "use the default 0.3" (pll.c:30-31). The CLI converts Hz via
    # 2*pi/symrate (main.c:136).
    freq_max: float = -1.0
    # Block length in input samples. Pure performance knob; output is
    # block-size invariant.
    block_len: int = 8192
    # LOCKED-mode envelope knobs (Pallas serving geometry only; the wide
    # acquisition program never uses them). Both trade window width — the
    # dominant per-step select cost, docs/PERF.md — against how far a
    # stream may stray before FLAG_WINDOW_MISS routes its block to the
    # exact oracle fallback. Decisions are bit-identical whenever the
    # stream stays inside the envelope, so these are pure perf knobs with
    # a correctness net, not accuracy knobs.
    #   locked_jitter_rad: per-symbol timing-phase jitter budget (rad).
    #     The steady-state M&M correction is a_t*err ~ 0.01 rad/symbol;
    #     1.0 is a ~100x envelope.
    #   locked_drift_frac: fraction of the worst-case timing-frequency
    #     clamp (2^-12 relative, timing.c:7 — ~244 ppm of sampler error,
    #     railed for the WHOLE block) budgeted for cumulative drift.
    #     1.0 covers a clamp-railed stream by construction; MEASURED
    #     (scripts/characterize_envelope.py, real chip, production block
    #     length): even 0.25 runs flag-free through the entire clamp
    #     range — the window's fixed margin terms absorb the worst-case
    #     drift — so the serving tier uses 0.25.
    locked_jitter_rad: float = 1.0
    locked_drift_frac: float = 1.0
    #   tau0_band: width (ticks) of the per-dispatch first-fire band the
    #     locked kernel window must cover, or None for the full
    #     ticks_per_fire fold. The stream-independent window pays a
    #     ceil(ticks_per_fire)+1-row "tau0 fold" for the worst-case
    #     per-stream first-fire offset spread (33 of W=72 rows at the
    #     hi-fi geometry — docs/PERF.md r4 attribution: the select is the
    #     dominant hi-fi cost and scales with W). When a serving host
    #     GROUPS streams by tau0 at wide->locked switch time (sorting is
    #     host-side and free at the switch; valid whenever the fleet
    #     spans several 128-lane dispatches), each dispatch's streams
    #     share a narrow tau0 band and the kernel anchors its window at
    #     the dispatch's own minimum predicted first-fire tick (computed
    #     from the carry at dispatch time — the base is a runtime scalar
    #     input). A stream that drifts out of its band fires outside
    #     [0, W) and trips FLAG_WINDOW_MISS -> exact oracle fallback +
    #     host re-sort, so this stays a pure perf knob with the same
    #     correctness net as the other envelope knobs. QPSK-geometry
    #     kernels only (validate()).
    tau0_band: int | None = None

    # ---- loop parameterization (demod.c:7-15, pll.c:24-44, timing.c:18-27)

    @property
    def taps(self) -> int:
        return 2 * self.rrc_order + 1

    @property
    def osf(self) -> float:
        """Oversampling factor, samples per symbol (demod.c:14)."""
        return float(self.samplerate) / float(self.symrate)

    @property
    def pll_bw_eff(self) -> np.float32:
        mult = 1 if self.oqpsk else 2
        return _F32(2 * math.pi * self.pll_bw / (mult * self.symrate))

    @property
    def pll_gains(self) -> tuple[np.float32, np.float32]:
        return loop_gains(C.DAMP_PLL, self.pll_bw_eff)

    @property
    def pll_fmax(self) -> np.float32:
        fm = self.freq_max
        fm = C.FREQ_MAX_DEFAULT if fm < 0 else min(1.0, fm)
        return _F32(fm / 2 if self.oqpsk else fm)

    @property
    def timing_freq(self) -> np.float32:
        """Timing NCO center frequency, rad per interpolated tick."""
        return _F32(2 * math.pi * self.symrate / (self.samplerate * self.interp))

    @property
    def timing_bw(self) -> np.float32:
        return _F32(self.sym_bw / self.interp)

    @property
    def timing_gains(self) -> tuple[np.float32, np.float32]:
        return loop_gains(C.DAMP_TIMING, self.timing_bw)

    @property
    def timing_dev_max(self) -> np.float32:
        return _F32(self.timing_freq / (1 << C.FREQ_DEV_EXP))

    # ---- block geometry

    @property
    def block_ticks(self) -> int:
        return self.block_len * self.interp

    @property
    def fire_spacing(self) -> float:
        """Nominal NCO phase between consecutive gate fires (rad)."""
        return math.pi if self.oqpsk else 2 * math.pi

    @property
    def ticks_per_fire(self) -> float:
        return self.fire_spacing / float(self.timing_freq)

    @property
    def fires_per_step(self) -> int:
        """Gate fires evaluated per scan step. QPSK: one (a symbol). OQPSK:
        two — the I half-fire and the Q fire of one symbol PAIRED into one
        step, so the serial scan runs per-SYMBOL for both modes instead of
        2.2x more steps for OQPSK. The M&M/Costas update block runs once
        per step either way (slot-1 fires never update, demod.c:62-87), so
        pairing removes the masked-discard update of every I step. Block
        boundaries can leave a symbol split across blocks (carry slot==2);
        a masked completion pre-fire at block entry re-aligns (scan.py)."""
        return 2 if self.oqpsk else 1

    @property
    def ticks_per_step(self) -> float:
        return self.ticks_per_fire * self.fires_per_step

    @property
    def max_ticks_per_step(self) -> int:
        """Static bound on ticks consumed per scan step.

        Sized for steady state plus a 1-rad M&M correction margin: the gate
        then fires every step in normal operation. Steps that hit the bound
        without firing simply continue in the next step — exactness is
        preserved — so a transient retard beyond the margin (the AGC
        transient can reach ~4.5 rad, tests/test_adversarial.py) merely
        costs one extra scan step out of steps_per_block's slack. Keeping
        the bound tight keeps the gate's (K, B) candidate tile — serial
        per-step work in every backend — small.
        """
        f_min = float(self.timing_freq) * (1 - 2.0 ** -C.FREQ_DEV_EXP)
        return int(math.ceil((self.fire_spacing + 1.0) / f_min)) + 2

    @property
    def gate_candidates(self) -> int:
        """Candidate tick count K of the closed-form timing gate.

        The gate fires at k* = min{k in [1, K] : fl(k*tf) >= fl(thresh - tp)}
        — a vectorized f32 multiply/compare with NO multiply-add pattern, so
        the result is bit-identical across numpy (scalar oracle), XLA (scan)
        and the GPU kernel regardless of FMA contraction. K is
        max_ticks_per_step rounded up to a multiple of 8."""
        return -(-self.max_ticks_per_step // 8) * 8

    @property
    def gate_offset_locked(self) -> int:
        """Static candidate offset k0 of the LOCKED-mode gate (Pallas
        kernel only; 0 disables).

        In locked steady state the fire lands at k* = ceil((fire_spacing -
        tp_residual)/tf) with |tp_residual| well under 1 rad (the M&M
        correction is a_t*err ~ 0.01 rad; 1 rad is a generous envelope), so
        candidates 1..k0 can be skipped and verified with ONE compare:
        fl(k0*tf) >= diff would mean the true fire is at k <= k0 — the
        kernel then flags (FLAG_WINDOW_MISS) and the block is recomputed
        exactly by the oracle fallback. With the non-fire consumption kept
        at min(rem, gate_candidates), the offset gate is BITWISE-equivalent
        to the full gate whenever the guard does not trip (monotonicity of
        fl(k*tf) in k). k0 is a multiple of 8 so the candidate tile stays
        sublane-aligned; OQPSK's half-symbol gate is already minimal (its
        K_eff would round back to the full K), so it keeps k0 = 0."""
        if self.oqpsk:
            return 0
        tf_max = float(self.timing_freq) * (1 + 2.0 ** -C.FREQ_DEV_EXP)
        k_lo = int(math.floor(
            (self.fire_spacing - self.locked_jitter_rad) / tf_max)) - 2
        k0 = max(0, min(k_lo - 1, self.gate_candidates - 8))
        return (k0 // 8) * 8

    @property
    def steps_always_fire(self) -> int:
        """Leading block steps guaranteed to FIRE for every in-envelope
        stream — the LOCKED-mode all-fire speculation bound (Pallas kernel;
        kernels/block_demod.py).

        Every step consumes one full symbol of gate phase (one 2*pi wrap
        for QPSK; the OQPSK paired step wraps twice at pi each, same
        total), so after n fired steps the consumed tick count satisfies
        t_n * tf_min <= n*2*pi + slack, where tf_min = timing_freq *
        (1 - 2^-12) (the clamp floor, timing.c:83-86) and slack bounds the
        block-entry residual plus the in-envelope timing-phase excursion
        (the 1 rad window_delta_locked envelope, doubled for margin).
        Hence every in-envelope stream has ticks left to fire at every
        step n < steps_always_fire; a stream that does NOT fire there is
        out of envelope, and the speculative step flags it into the exact
        oracle fallback instead of assuming."""
        tf_min = float(self.timing_freq) * (1 - 2.0 ** -C.FREQ_DEV_EXP)
        slack = 2.0 * max(1.0, self.locked_jitter_rad) + 2.0
        n = int(math.floor(
            (self.block_ticks * tf_min - slack) / (2 * math.pi))) - 2
        return max(0, min(n, self.steps_per_block))

    @property
    def steps_per_block(self) -> int:
        """Scan steps per block: nominal SYMBOL count (fires /
        fires_per_step) plus slack for timing frequency deviation (clamped
        to 2**-12 relative, timing.c:7) and the acquisition transient."""
        nominal = self.block_ticks / self.ticks_per_step
        return int(math.ceil(nominal * (1 + 2.0 ** -(C.FREQ_DEV_EXP - 1)))) + 8

    @property
    def _pair_extra(self) -> int:
        """Upper-side window extension covering a step's later fires
        (OQPSK pairing: the Q fire lands ~ticks_per_fire after the I fire
        the window is centered on)."""
        return ((self.fires_per_step - 1)
                * int(math.ceil(self.ticks_per_fire)))

    def _window_delta(self, jitter_rad: float,
                      drift_frac: float = 1.0) -> int:
        """Window half-width for a given per-symbol phase-jitter budget:
        cumulative timing-frequency drift over the block (the clamp allows
        +-2^-12 relative, timing.c:7 — real clock error, present locked or
        not; drift_frac budgets a fraction of that worst case) plus the
        jitter allowance plus safety margin."""
        drift = math.ceil(self.steps_per_block * self.ticks_per_step
                          * 2.0 ** -C.FREQ_DEV_EXP * drift_frac)
        jitter = math.ceil(jitter_rad / float(self.timing_freq))
        return int(drift + jitter + 8)

    @property
    def window_delta(self) -> int:
        """Half-width (in ticks) of the prematerialized FIR candidate window
        around each step's predicted FIRST fire tick. Must cover cumulative
        timing frequency drift over the block plus per-symbol phase
        jitter — 4 rad covers the acquisition/AGC transient
        (tests/test_adversarial.py)."""
        return self._window_delta(4.0)

    @property
    def window_delta_locked(self) -> int:
        """LOCKED-mode half-width: the steady-state M&M correction is
        a_t*err ~ 0.01 rad/symbol, so the default 1 rad jitter budget is a
        ~100x envelope; an excursion beyond it (lock loss, signal dropout)
        lands outside the window and trips FLAG_WINDOW_MISS -> exact oracle
        fallback, the same safety net the wide window uses. Budgets are the
        locked_jitter_rad / locked_drift_frac knobs (see their field
        comment)."""
        return self._window_delta(self.locked_jitter_rad,
                                  self.locked_drift_frac)

    @property
    def window(self) -> int:
        w = 2 * self.window_delta + self._pair_extra
        return (w + 7) // 8 * 8

    @property
    def window_delta_common(self) -> int:
        """Half-width of the stream-independent candidate window (the Pallas
        kernel path): the per-stream first-fire tick tau0 in
        [0, ticks_per_step] folds into the half-width, so one window base
        serves every lane and the host-side window extraction is a static
        row-gather."""
        return self.window_delta + int(math.ceil(self.ticks_per_fire)) + 1

    @property
    def window_common(self) -> int:
        w = 2 * self.window_delta_common + self._pair_extra
        return (w + 7) // 8 * 8

    @property
    def window_locked_asym(self) -> int:
        """LOCKED-mode kernel window width, ASYMMETRIC base (the kernel
        anchors window_delta_locked ticks BELOW each step's nominal fire
        tick — kernels/block_demod.py _geom).

        The stream-independent window must fold the per-stream first-fire
        offset tau0 into its coverage, but tau0 is ONE-SIDED: the block's
        first fire lands 1..ticks_per_fire(+locked jitter) ticks after
        entry, never before (offsets[] predicts the tau0 == 0 stream). A
        symmetric window (delta_common each side, the r2 geometry) wastes
        ~ticks_per_fire provably-dead rows on the low side — and the
        per-step window select cost scales with W (docs/PERF.md). Low
        side: delta_locked (drift + jitter + margin). High side:
        ticks_per_fire + delta_locked (tau0 plus the same envelope; the
        delta's +8 margin absorbs the gate's +1 rad late-fire allowance),
        plus _pair_extra for OQPSK's later half-symbol fire. An
        out-of-envelope fire lands outside [0, W) and trips
        FLAG_WINDOW_MISS -> exact oracle fallback, same as the symmetric
        geometry."""
        tau0_term = (self.tau0_band if self.tau0_band is not None
                     else int(math.ceil(self.ticks_per_fire)))
        w = (2 * self.window_delta_locked
             + tau0_term + 1 + self._pair_extra)
        return (w + 7) // 8 * 8

    @property
    def locked_pair_slices(self) -> tuple[int, int, int, int] | None:
        """Static sub-slices (oA, WA, oB, WB) of the asymmetric locked
        window (window_locked_asym) read by the OQPSK paired step's two
        selects; None unless oqpsk.

        The two half-symbol fires of a paired step land in distinct
        sub-ranges of the step window: the I fire at
        c in delta + [-(drift+jitter), tau0_max + drift+jitter] and the
        Q fire ticks_per_fire (within the +-1 rad locked envelope) above
        it — so each (W, B) one-hot select only needs its own slice, not
        the full union (which window_locked_asym must cover). Derivation
        mirrors _window_delta / window_locked_asym term for term; slices
        are 8-row aligned. A fire
        outside its slice trips
        FLAG_WINDOW_MISS -> exact oracle fallback, exactly like the full
        window's bounds check (the flag envelope is a few ticks tighter;
        still >= the locked envelope by the same slack margin)."""
        if not self.oqpsk:
            return None
        W = self.window_locked_asym
        delta = self.window_delta_locked
        jrad = self.locked_jitter_rad
        drift = math.ceil(self.steps_per_block * self.ticks_per_step
                          * 2.0 ** -C.FREQ_DEV_EXP * self.locked_drift_frac)
        jr = math.ceil(jrad / float(self.timing_freq))
        slack = 4
        tf_min = float(self.timing_freq) * (1 - 2.0 ** -C.FREQ_DEV_EXP)
        tf_max = float(self.timing_freq) * (1 + 2.0 ** -C.FREQ_DEV_EXP)
        tau0_max = int(math.ceil((self.fire_spacing + jrad) / tf_min)) - 1
        k_lo = int(math.floor((self.fire_spacing - jrad) / tf_max))
        k_hi = int(math.ceil((self.fire_spacing + jrad) / tf_min))
        a_lo = delta - (drift + jr) - slack
        a_hi = delta + tau0_max + drift + jr + slack
        oA = max(0, a_lo) // 8 * 8
        WA = min(W - oA, -(-(a_hi + 1 - oA) // 8) * 8)
        oB = max(0, a_lo + k_lo) // 8 * 8
        WB = min(W - oB, -(-(min(a_hi + k_hi, W - 1) + 1 - oB) // 8) * 8)
        return (oA, WA, oB, WB)

    @property
    def gate_spec_bounds(self) -> tuple[int, int]:
        """(k0s, Ks): the ALL-FIRE spec bodies' gate candidate range
        (kernels/block_demod.py; LOCKED program only).

        Every spec-region step follows a previous fire with |tp residual|
        <= locked_jitter_rad, so the fire candidate k* lies in
        [floor((fs-jr)/tf_max), ceil((fs+jr)/tf_min)] (+-2 margin taken).
        Candidates below k0s are skipped and VERIFIED in-step (one
        compare: fl(k0s*tf) >= diff would mean an earlier fire ->
        FLAG_WINDOW_MISS -> exact oracle fallback); candidates above the
        range cannot be the min when one in range fires (fl(k*tf)
        monotone in k), and a spec-region non-fire already flags. Bounds
        therefore affect flag frequency only, never correctness. The r4
        probe attributed 4.7-8.5% of the step to the gate's full
        candidate tile; this shrinks it ~2x (QPSK 16->8 rows, OQPSK
        16->7 per transaction, hi-fi 16->10). Unlike gate_offset_locked
        (whose non-fire consumption semantics need the k0+K_eff == K
        identity), the spec body fires unconditionally, so neither end
        needs sublane alignment."""
        K = self.gate_candidates
        jr = self.locked_jitter_rad
        tf_min = float(self.timing_freq) * (1 - 2.0 ** -C.FREQ_DEV_EXP)
        tf_max = float(self.timing_freq) * (1 + 2.0 ** -C.FREQ_DEV_EXP)
        k0s = max(0, int(math.floor(
            (self.fire_spacing - jr) / tf_max)) - 2)
        k_hi = min(K, int(math.ceil(
            (self.fire_spacing + jr) / tf_min)) + 2)
        k0s = min(k0s, max(0, k_hi - 1))
        return k0s, k_hi - k0s

    @property
    def pargate_bounds(self) -> tuple[int, int] | None:
        """Static kA-candidate range (k_loA, KA) of the OQPSK PARALLEL
        gate-B evaluation (kernels/block_demod.py, spec paired step):
        transaction B's gate is evaluated for every feasible transaction-A
        fire candidate kA in [k_loA, k_loA + KA) BEFORE A's gate resolves
        — (K, KA, B) tile work traded for the serial gate-A -> gate-B
        dependency (docs/PERF.md "Remaining levers"). In locked steady
        state the A fire satisfies fl(kA*tf) >= fire_spacing - tp with
        |tp residual| <= locked_jitter_rad, bounding kA to
        [floor((pi - jr)/tf_max), ceil((pi + jr)/tf_min)]; KA rounds that
        span up to a sublane tile, extending the margin downward. A
        resolved kA OUTSIDE the range flags FLAG_WINDOW_MISS -> exact
        oracle fallback, so the bound affects flag frequency only, never
        correctness. None unless oqpsk."""
        if not self.oqpsk:
            return None
        K = self.gate_candidates
        jrad = self.locked_jitter_rad
        tf_min = float(self.timing_freq) * (1 - 2.0 ** -C.FREQ_DEV_EXP)
        tf_max = float(self.timing_freq) * (1 + 2.0 ** -C.FREQ_DEV_EXP)
        # kA is a 0-based CANDIDATE INDEX (tick count k_idx = kA + 1, see
        # _make_paired_step_tiles), so the exact lower bound for the tick
        # count x = (fs - jr)/tf_max is ceil(x) - 1 as an index — floor(x)
        # is one too high exactly when x is integral, which would land a
        # feasible in-envelope kA below the bound and trip par_oob ->
        # FLAG_WINDOW_MISS on clean traffic (perf only; the oracle
        # fallback preserves exactness).
        k_lo = max(0, int(math.ceil((self.fire_spacing - jrad) / tf_max)) - 1)
        k_hi = min(K - 1,
                   int(math.ceil((self.fire_spacing + jrad) / tf_min)))
        span = k_hi - k_lo + 1
        ka = min(K, -(-span // 8) * 8)
        k_lo = max(0, min(k_lo - (ka - span), K - ka))
        return (k_lo, ka)

    @property
    def window_offsets(self) -> np.ndarray:
        """Static per-step predicted first-fire-tick offsets, shape (S,),
        int32.

        Step k's window covers ticks tau0_hat + offsets[k] - delta + [0, window).
        """
        k = np.arange(self.steps_per_block, dtype=np.float64)
        return np.round(k * self.ticks_per_step).astype(np.int32)

    def serving(self) -> "DemodConfig":
        """Replica with the SERVING-tier locked envelope (0.5 rad jitter /
        0.25 drift budget) — measured on chip (docs/PERF.md r4): +13-33%
        fleet throughput over the r3 geometry across QPSK/OQPSK/hi-fi,
        and ZERO flags through the ENTIRE M&M clamp range (0-244 ppm of
        sampler clock error, scripts/characterize_envelope.py, real chip,
        production block length) — every stream the timing loop can
        physically track runs flag-free on this tier. A 0.25 rad jitter
        budget was measured too tight (flags clean OQPSK signal); 0.5 rad
        is ~50x the steady-state M&M correction.

        Used by STEADY-STATE locked dispatch only (fleet/stream hosts
        switch programs after every stream reports carrier lock); an
        out-of-envelope excursion flags into the exact oracle fallback,
        same as the default envelope. Consumers that run a COLD
        acquisition through the locked program (the turbo warmup,
        demod/turbo.py) keep the roomy default — the acquisition
        transient's timing excursions exceed the serving budget. A
        non-default envelope set explicitly on this config is respected
        as-is."""
        if (self.locked_jitter_rad, self.locked_drift_frac) != (1.0, 1.0):
            return self
        return dataclasses.replace(self, locked_jitter_rad=0.5,
                                   locked_drift_frac=0.25)

    def validate(self) -> None:
        if self.samplerate <= 0:
            raise ValueError("samplerate must be positive")
        if self.symrate <= 0:
            raise ValueError("symrate must be positive")
        if self.osf < 1.0:
            raise ValueError(
                f"samplerate {self.samplerate} below symbol rate {self.symrate}")
        if self.interp < 1 or self.rrc_order < 1:
            raise ValueError("interp and rrc_order must be >= 1")
        if self.block_len < 4 * self.taps:
            raise ValueError("block_len too small for the FIR order")
        if self.tau0_band is not None:
            if self.oqpsk:
                raise ValueError(
                    "tau0_band grouping is QPSK-geometry only (the OQPSK "
                    "paired-select slices assume the full tau0 fold)")
            if not (0 <= self.tau0_band
                    <= int(math.ceil(self.ticks_per_fire))):
                raise ValueError(
                    f"tau0_band {self.tau0_band} outside "
                    f"[0, ceil(ticks_per_fire)]")
