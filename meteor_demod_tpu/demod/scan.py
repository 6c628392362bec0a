"""The per-symbol scan: timing gate, AGC, Costas PLL, and M&M retiming.

Vectorized restructuring of the reference's per-sample pull pipeline
(demod.c:23-91). Key observations that shape the design:

1. Every feedback state (AGC gain/bias, PLL phase/freq, timing freq, M&M
   prev) mutates ONLY when the timing gate fires — once per symbol for QPSK,
   twice for OQPSK. So the sequential recurrence runs per SYMBOL, ~16x
   sparser than per-sample-tick; OQPSK's two fires are PAIRED into one
   step (_make_paired_step) so its scan is per-symbol too.
2. The FIR outputs ("ticks") have no feedback, so a whole block of them is
   computed densely up front (dsp/fir.py).
3. Which tick a step consumes is data-dependent. The step reads the fired
   tick's FIR output through a `fetch(xs, tau, fired)` callback, so one
   definition of the step math serves two readers: this module's XLA scan
   prematerializes a small static window of candidate ticks per step (the
   timing NCO frequency is clamped to center*(1 +- 2**-12), timing.c:7, so
   fire k lands near tau0_hat + round(k * ticks_per_fire)) and selects the
   fired tick by compare-mask-sum; the GPU kernel (kernels/recurrence.py)
   loads it directly by index.
4. The timing gate is evaluated in closed form: fire at candidate
   k* = min{k in [1, K] : fl(k*tf) >= fl(thresh - tp)} and advance the phase
   by the SELECTED precomputed product fl(k* * tf) (see
   config.gate_candidates and demod/scalar.py's module docstring). Every op
   is a bare IEEE multiply/subtract/compare/add — no multiply-add pattern —
   so the fire ticks are bit-identical across the numpy oracle, this scan,
   and the GPU kernel regardless of FMA contraction. The C binary's
   per-tick accumulation (and double-precision retime) differs by bounded
   rounding; parity with the C program is within the SNR bound (golden
   tests), as for any float32 implementation.

The step math is written batch-polymorphic (state leaves of any leading
shape, candidate axes last), so the scan vmaps it over streams and the
kernel runs it on a whole tile of lanes at once.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp

from .. import constants as C
from ..config import DemodConfig
from ..dsp.fir import make_fir_banks, polyphase_fir_block
from ..dsp.sincos import fast_sin, fast_cos
from ..dsp.loops import costas_error, lut_tanh, mm_error
from .state import DemodCarry, BlockOutput, FLAG_WINDOW_MISS, FLAG_UNCONSUMED

_F32 = np.float32
_TWO_PI = _F32(2 * np.pi)
_PI = _F32(np.pi)


def window_fetch(xs, tau, fired):
    """The scan's fetch: select the fired tick from the step's candidate
    window xs = (w_re, w_im, w_idx), each (..., W). A fire outside the
    window is a miss (FLAG_WINDOW_MISS -> exact oracle fallback)."""
    w_re, w_im, w_idx = xs
    sel = jnp.logical_and(w_idx == tau[..., None], fired[..., None])
    z_re = jnp.sum(jnp.where(sel, w_re, jnp.zeros_like(w_re)), axis=-1)
    z_im = jnp.sum(jnp.where(sel, w_im, jnp.zeros_like(w_im)), axis=-1)
    miss = jnp.logical_and(fired, ~jnp.any(sel, axis=-1))
    return z_re, z_im, miss


def _make_gate(cfg: DemodConfig, n_cand: int | None = None) -> Callable:
    """Closed-form timing gate (module docstring item 4) over the K =
    cfg.gate_candidates candidates, evaluated on an n_cand-wide candidate
    axis (>= K; the extra candidates are masked off — the GPU kernel pads
    to a power of two). Returns gate(tp, tf, thresh, t) ->
    (fired, k_idx, prod_sel, defer)."""
    block_ticks = cfg.block_ticks
    K = cfg.gate_candidates
    n = K if n_cand is None else n_cand

    def gate(tp, tf, thresh, t):
        kiota = jax.lax.iota(jnp.int32, n)
        ks = (kiota + 1).astype(jnp.float32)
        diff = thresh - tp
        rem = block_ticks - t
        prod = ks * tf[..., None]                          # (..., n)
        ok = jnp.logical_and(prod >= diff[..., None],
                             ks <= rem.astype(jnp.float32)[..., None])
        if n > K:
            ok = jnp.logical_and(ok, kiota < K)
        first = jnp.min(jnp.where(ok, kiota, n), axis=-1)
        fired = first < n
        k_idx = jnp.where(fired, first, jnp.minimum(rem, K) - 1)
        # Phase advances by the SELECTED product — never a fresh mul+add,
        # so no FMA can change the rounding.
        prod_sel = jnp.sum(
            jnp.where(kiota == k_idx[..., None], prod, _F32(0.0)), axis=-1)
        defer = jnp.logical_and(~fired, rem > K)
        return fired, k_idx, prod_sel, defer

    return gate


def _make_symbol_step(cfg: DemodConfig, fetch: Callable = window_fetch,
                      tanh: Callable = lut_tanh,
                      n_cand: int | None = None) -> Callable:
    """Single-fire step (QPSK, and the OQPSK block-entry completion
    pre-fire). For OQPSK's per-symbol scan see _make_paired_step.

    fetch(xs, tau, fired) -> (z_re, z_im, miss) reads the fired tick's FIR
    output; tanh is the Costas detector's table lookup (dsp/loops.py)."""
    a_t, b_t = cfg.timing_gains
    a_p, b_p = cfg.pll_gains
    t_center = cfg.timing_freq
    t_dev = cfg.timing_dev_max
    fmax = cfg.pll_fmax
    oqpsk = cfg.oqpsk
    gate = _make_gate(cfg, n_cand)

    bias_keep = _F32(1.0 - C.AGC_BIAS_POLE)
    bias_pole = _F32(C.AGC_BIAS_POLE)
    gain_pole = _F32(C.AGC_GAIN_POLE)
    agc_target = _F32(C.AGC_TARGET)
    err_keep = _F32(1.0 - C.ERR_POLE)
    err_pole = _F32(C.ERR_POLE)
    sweep = _F32(C.SWEEP_STEP)

    def step(carry: DemodCarry, xs):
        # ---- closed-form timing gate (see module docstring item 4) ---------
        t = carry.tick
        if oqpsk:
            thresh = carry.slot.astype(jnp.float32) * _PI
        else:
            thresh = jnp.full_like(carry.t_phase, _TWO_PI)
        fired, k_idx, prod_sel, _ = gate(carry.t_phase, carry.t_freq,
                                         thresh, t)
        tau = t + k_idx
        tp = carry.t_phase + prod_sel
        tf = carry.t_freq
        t = t + k_idx + 1

        # ---- the fired tick's FIR output -----------------------------------
        z_re, z_im, miss = fetch(xs, tau, fired)

        # ---- AGC (agc.c:12-25) ---------------------------------------------
        bias_re = carry.agc_bias_re * bias_keep + bias_pole * z_re
        bias_im = carry.agc_bias_im * bias_keep + bias_pole * z_im
        zr = (z_re - bias_re) * carry.agc_gain
        zi = (z_im - bias_im) * carry.agc_gain
        mag = jnp.sqrt(zr * zr + zi * zi)
        gain = carry.agc_gain + gain_pole * (agc_target - mag)
        gain = jnp.maximum(_F32(0.0), gain)

        # ---- PLL mix (pll.c:50-97): NCO rotate, one phase advance per fire -
        s = fast_sin(-carry.p_phase)
        cs = fast_cos(-carry.p_phase)
        mre = zr * cs - zi * s
        mim = zr * s + zi * cs
        pp = carry.p_phase + carry.p_freq
        pp = jnp.where(pp >= _TWO_PI, pp - _TWO_PI, pp)

        # ---- assemble the symbol -------------------------------------------
        if oqpsk:
            # Slot 1 stores I at the half-symbol point; slot 2 completes the
            # symbol with Q and runs the loop updates (demod.c:62-87).
            is1 = carry.slot == 1
            fire1 = jnp.logical_and(fired, is1)
            do_update = jnp.logical_and(fired, ~is1)
            inphase = jnp.where(fire1, mre, carry.inphase)
            sym_re = carry.inphase
            sym_im = mim
            slot = jnp.where(fired,
                             jnp.where(is1, jnp.full_like(carry.slot, 2),
                                       jnp.ones_like(carry.slot)),
                             carry.slot)
        else:
            do_update = fired
            inphase = carry.inphase
            sym_re = mre
            sym_im = mim
            slot = carry.slot

        # ---- M&M retiming (timing.c:59-95) ----------------------------------
        err_t = mm_error(carry.t_prev, sym_im)
        prev_new = jnp.where(do_update, sym_im, carry.t_prev)
        tp_upd = tp - (_TWO_PI + a_t * err_t)
        fd = jnp.clip((tf - t_center) - b_t * err_t, -t_dev, t_dev)
        tf_upd = t_center + fd
        tp = jnp.where(do_update, tp_upd, tp)
        tf = jnp.where(do_update, tf_upd, tf)

        # ---- Costas update: loop filter, lock detect, sweep (pll.c:99-130) --
        e = costas_error(sym_re, sym_im, tanh)
        pp_upd = jnp.fmod(pp + a_p * e, _TWO_PI)
        pf = carry.p_freq + b_p * e
        err_upd = carry.p_err * err_keep + jnp.abs(e) * err_pole
        lock_now = jnp.logical_and(err_upd < _F32(C.LOCK_THRESH),
                                   carry.locked == 0)
        unlock_now = jnp.logical_and(err_upd > _F32(C.UNLOCK_THRESH),
                                     carry.locked == 1)
        locked_upd = jnp.where(lock_now, jnp.ones_like(carry.locked),
                               jnp.where(unlock_now,
                                         jnp.zeros_like(carry.locked),
                                         carry.locked))
        locked_once_upd = jnp.maximum(carry.locked_once,
                                      lock_now.astype(jnp.int32))
        pf = jnp.where(locked_upd == 0, pf + sweep * carry.updown, pf)
        updown_upd = jnp.where(pf >= fmax, _F32(-1.0),
                               jnp.where(pf <= -fmax, _F32(1.0), carry.updown))
        pf = jnp.clip(pf, -fmax, fmax)

        # ---- gate state writes ----------------------------------------------
        new = DemodCarry(
            t_phase=tp,
            t_freq=tf,
            t_prev=prev_new,
            p_phase=jnp.where(do_update, pp_upd,
                              jnp.where(fired, pp, carry.p_phase)),
            p_freq=jnp.where(do_update, pf, carry.p_freq),
            p_err=jnp.where(do_update, err_upd, carry.p_err),
            locked=jnp.where(do_update, locked_upd, carry.locked),
            locked_once=jnp.where(do_update, locked_once_upd,
                                  carry.locked_once),
            updown=jnp.where(do_update, updown_upd, carry.updown),
            agc_gain=jnp.where(fired, gain, carry.agc_gain),
            agc_bias_re=jnp.where(fired, bias_re, carry.agc_bias_re),
            agc_bias_im=jnp.where(fired, bias_im, carry.agc_bias_im),
            inphase=inphase,
            slot=slot,
            tick=t,
            fir_tail=carry.fir_tail,
            flags=carry.flags | jnp.where(miss, FLAG_WINDOW_MISS, 0),
        )
        out = BlockOutput(
            sym_re=sym_re,
            sym_im=sym_im,
            valid=do_update.astype(jnp.int32),
            locked_once=jnp.where(do_update, locked_once_upd,
                                  carry.locked_once),
        )
        return new, out

    return step


def _make_paired_step(cfg: DemodConfig, fetch: Callable = window_fetch,
                      tanh: Callable = lut_tanh,
                      n_cand: int | None = None) -> Callable:
    """OQPSK per-SYMBOL step: the I half-fire and the Q fire paired.

    The reference fires the timing gate twice per OQPSK symbol
    (timing.c:40-57, demod.c:62-87); a per-fire scan therefore runs ~2.2x
    more serial steps than QPSK with the M&M/Costas update block computed
    and discarded on every I fire. Pairing evaluates both gate
    transactions in one step — A (I, threshold slot*pi): select, AGC, mix,
    store inphase; B (Q, threshold 2*pi): select, AGC, mix — and runs the
    update block ONCE on the completed symbol. Float op order per fire is
    identical to the single-fire step, so decisions match the scalar
    oracle exactly.

    Alignment invariant: a step enters with slot==1 (the block-entry
    completion pre-fire, block_entry, re-aligns a symbol split across a
    block boundary). If B cannot fire before the block's ticks run out the
    carry leaves slot==2 and no later step of this block can fire either
    (the remaining ticks were insufficient for B, hence for any later
    gate), so misalignment never occurs unflagged mid-block; if B DEFERS
    with ticks to spare (a >5 rad retard — beyond the adversarial budget)
    the step flags and the exact oracle fallback recomputes the block.
    """
    a_t, b_t = cfg.timing_gains
    a_p, b_p = cfg.pll_gains
    t_center = cfg.timing_freq
    t_dev = cfg.timing_dev_max
    fmax = cfg.pll_fmax
    gate = _make_gate(cfg, n_cand)

    bias_keep = _F32(1.0 - C.AGC_BIAS_POLE)
    bias_pole = _F32(C.AGC_BIAS_POLE)
    gain_pole = _F32(C.AGC_GAIN_POLE)
    agc_target = _F32(C.AGC_TARGET)
    err_keep = _F32(1.0 - C.ERR_POLE)
    err_pole = _F32(C.ERR_POLE)
    sweep = _F32(C.SWEEP_STEP)

    def step(carry: DemodCarry, xs):
        # ---- transaction A: the I half-fire ------------------------------
        threshA = carry.slot.astype(jnp.float32) * _PI
        firedA, kA, prodA, _ = gate(carry.t_phase, carry.t_freq, threshA,
                                    carry.tick)
        tauA = carry.tick + kA
        tp1 = carry.t_phase + prodA
        t1 = carry.tick + kA + 1
        zAre, zAim, missA = fetch(xs, tauA, firedA)

        biasAre = carry.agc_bias_re * bias_keep + bias_pole * zAre
        biasAim = carry.agc_bias_im * bias_keep + bias_pole * zAim
        zrA = (zAre - biasAre) * carry.agc_gain
        ziA = (zAim - biasAim) * carry.agc_gain
        magA = jnp.sqrt(zrA * zrA + ziA * ziA)
        gainA = jnp.maximum(_F32(0.0),
                            carry.agc_gain + gain_pole * (agc_target - magA))
        snA = fast_sin(-carry.p_phase)
        csA = fast_cos(-carry.p_phase)
        mreA = zrA * csA - ziA * snA
        ppA = carry.p_phase + carry.p_freq
        ppA = jnp.where(ppA >= _TWO_PI, ppA - _TWO_PI, ppA)

        gain1 = jnp.where(firedA, gainA, carry.agc_gain)
        bre1 = jnp.where(firedA, biasAre, carry.agc_bias_re)
        bim1 = jnp.where(firedA, biasAim, carry.agc_bias_im)
        pp1 = jnp.where(firedA, ppA, carry.p_phase)
        is1A = carry.slot == 1
        inphase1 = jnp.where(jnp.logical_and(firedA, is1A), mreA,
                             carry.inphase)
        slotB = jnp.where(firedA,
                          jnp.where(is1A, jnp.full_like(carry.slot, 2),
                                    jnp.ones_like(carry.slot)),
                          carry.slot)

        # ---- transaction B: the Q fire (attempted only after A fired) ----
        threshB = slotB.astype(jnp.float32) * _PI
        firedB_raw, kB_raw, prodB_raw, deferB_raw = gate(
            tp1, carry.t_freq, threshB, t1)
        attemptB = firedA
        firedB = jnp.logical_and(firedB_raw, attemptB)
        kB = jnp.where(attemptB, kB_raw, -1)
        prodB = jnp.where(attemptB, prodB_raw, _F32(0.0))
        deferB = jnp.logical_and(deferB_raw, attemptB)
        tauB = t1 + kB
        tp2 = tp1 + prodB
        t2 = jnp.where(attemptB, t1 + kB + 1, t1)
        zBre, zBim, missB = fetch(xs, tauB, firedB)

        biasBre = bre1 * bias_keep + bias_pole * zBre
        biasBim = bim1 * bias_keep + bias_pole * zBim
        zrB = (zBre - biasBre) * gain1
        ziB = (zBim - biasBim) * gain1
        magB = jnp.sqrt(zrB * zrB + ziB * ziB)
        gainB = jnp.maximum(_F32(0.0),
                            gain1 + gain_pole * (agc_target - magB))
        snB = fast_sin(-pp1)
        csB = fast_cos(-pp1)
        mimB = zrB * snB + ziB * csB
        ppB = pp1 + carry.p_freq
        ppB = jnp.where(ppB >= _TWO_PI, ppB - _TWO_PI, ppB)

        gain2 = jnp.where(firedB, gainB, gain1)
        bre2 = jnp.where(firedB, biasBre, bre1)
        bim2 = jnp.where(firedB, biasBim, bim1)
        pp2 = jnp.where(firedB, ppB, pp1)
        slot_f = jnp.where(firedB,
                           jnp.where(slotB == 1,
                                     jnp.full_like(slotB, 2),
                                     jnp.ones_like(slotB)),
                           slotB)

        # ---- the symbol + ONE update block (Q fires only) ----------------
        do_update = jnp.logical_and(firedB, slotB == 2)
        sym_re = inphase1
        sym_im = mimB

        err_t = mm_error(carry.t_prev, sym_im)
        prev_new = jnp.where(do_update, sym_im, carry.t_prev)
        tp_upd = tp2 - (_TWO_PI + a_t * err_t)
        fd = jnp.clip((carry.t_freq - t_center) - b_t * err_t,
                      -t_dev, t_dev)
        tp_f = jnp.where(do_update, tp_upd, tp2)
        tf_f = jnp.where(do_update, t_center + fd, carry.t_freq)

        e = costas_error(sym_re, sym_im, tanh)
        pp_upd = jnp.fmod(pp2 + a_p * e, _TWO_PI)
        pf = carry.p_freq + b_p * e
        err_upd = carry.p_err * err_keep + jnp.abs(e) * err_pole
        lock_now = jnp.logical_and(err_upd < _F32(C.LOCK_THRESH),
                                   carry.locked == 0)
        unlock_now = jnp.logical_and(err_upd > _F32(C.UNLOCK_THRESH),
                                     carry.locked == 1)
        locked_upd = jnp.where(lock_now, jnp.ones_like(carry.locked),
                               jnp.where(unlock_now,
                                         jnp.zeros_like(carry.locked),
                                         carry.locked))
        locked_once_upd = jnp.maximum(carry.locked_once,
                                      lock_now.astype(jnp.int32))
        pf = jnp.where(locked_upd == 0, pf + sweep * carry.updown, pf)
        updown_upd = jnp.where(pf >= fmax, _F32(-1.0),
                               jnp.where(pf <= -fmax, _F32(1.0),
                                         carry.updown))
        pf = jnp.clip(pf, -fmax, fmax)

        miss = jnp.logical_or(jnp.logical_or(missA, missB), deferB)
        new = DemodCarry(
            t_phase=tp_f,
            t_freq=tf_f,
            t_prev=prev_new,
            p_phase=jnp.where(do_update, pp_upd, pp2),
            p_freq=jnp.where(do_update, pf, carry.p_freq),
            p_err=jnp.where(do_update, err_upd, carry.p_err),
            locked=jnp.where(do_update, locked_upd, carry.locked),
            locked_once=jnp.where(do_update, locked_once_upd,
                                  carry.locked_once),
            updown=jnp.where(do_update, updown_upd, carry.updown),
            agc_gain=gain2,
            agc_bias_re=bre2,
            agc_bias_im=bim2,
            inphase=inphase1,
            slot=slot_f,
            tick=t2,
            fir_tail=carry.fir_tail,
            flags=carry.flags | jnp.where(miss, FLAG_WINDOW_MISS, 0),
        )
        out = BlockOutput(
            sym_re=sym_re,
            sym_im=sym_im,
            valid=do_update.astype(jnp.int32),
            locked_once=jnp.where(do_update, locked_once_upd,
                                  carry.locked_once),
        )
        return new, out

    return step


def make_steps(cfg: DemodConfig, fetch: Callable = window_fetch,
               tanh: Callable = lut_tanh, n_cand: int | None = None):
    """(step, pre_step) for cfg: the per-symbol step and, for OQPSK, the
    single-fire block-entry completion pre-fire (None for QPSK)."""
    if cfg.oqpsk:
        return (_make_paired_step(cfg, fetch, tanh, n_cand),
                _make_symbol_step(cfg, fetch, tanh, n_cand))
    return _make_symbol_step(cfg, fetch, tanh, n_cand), None


def block_entry(carry: DemodCarry, pre_step, pre_xs):
    """Block-entry state: tick reset and, for OQPSK (pre_step given), the
    completion pre-fire. Returns (carry0, pre_out) with pre_out None for
    QPSK.

    A symbol split across the block boundary left slot==2; its Q fire is
    finished with single-fire semantics so the paired steps enter aligned.
    The fire lands within gate_candidates ticks of block entry."""
    carry0 = carry._replace(tick=jnp.zeros_like(carry.tick))
    if pre_step is None:
        return carry0, None
    pend = carry0.slot == 2
    stepped, pre_out = pre_step(carry0, pre_xs)
    carry0 = jax.tree_util.tree_map(lambda a, b: jnp.where(pend, a, b),
                                    stepped, carry0)
    # A deferred completion (>K-tick retard at block entry) leaves slot==2:
    # flag it — the paired steps' alignment invariant does not hold and
    # the oracle fallback must recompute.
    carry0 = carry0._replace(
        flags=carry0.flags | jnp.where(
            jnp.logical_and(pend, carry0.slot == 2), FLAG_WINDOW_MISS, 0))
    pre_out = BlockOutput(
        sym_re=pre_out.sym_re,
        sym_im=pre_out.sym_im,
        valid=pre_out.valid * pend.astype(jnp.int32),
        locked_once=jnp.where(pend, pre_out.locked_once,
                              carry.locked_once))
    return carry0, pre_out


def block_exit(cfg: DemodConfig, carry1: DemodCarry, new_tail) -> DemodCarry:
    """Block-exit state: tick reset, the FIR tail installed, and
    FLAG_UNCONSUMED where the steps ran out before the block's ticks."""
    unconsumed = carry1.tick < cfg.block_ticks
    return carry1._replace(
        tick=jnp.zeros_like(carry1.tick),
        fir_tail=new_tail,
        flags=carry1.flags | jnp.where(unconsumed, FLAG_UNCONSUMED, 0),
    )


def make_block_demod(cfg: DemodConfig) -> Callable:
    """Build demod_block(carry, x_block) -> (carry', BlockOutput).

    Single-stream; batch with jax.vmap. Pure function of (carry, block), so
    any block can be deterministically recomputed (free checkpoint/resume and
    retry semantics).
    """
    cfg.validate()
    # Closure constants stay numpy so trace-time embedding needs no
    # device->host copy.
    banks = make_fir_banks(cfg)
    oqpsk = cfg.oqpsk
    step, pre_step = make_steps(cfg)
    W = cfg.window
    delta = cfg.window_delta
    offsets = np.asarray(cfg.window_offsets)           # (S,)
    win_range = np.arange(W, dtype=np.int32)           # (W,)
    block_ticks = cfg.block_ticks
    if oqpsk:
        thresh0 = lambda slot: slot.astype(jnp.float32) * _PI
    else:
        thresh0 = lambda slot: jnp.full_like(slot, _TWO_PI, dtype=jnp.float32)

    def demod_block(carry: DemodCarry, x_block: jnp.ndarray):
        """x_block: (L, 2) float32 re/im pairs."""
        F, new_tail = polyphase_fir_block(x_block, carry.fir_tail, banks)
        F_flat = F.reshape(-1, 2)               # (ticks, 2) tick-ordered

        # The OQPSK pre-fire lands within gate_candidates ticks, so the
        # first W FIR rows cover it.
        carry0, pre_out = block_entry(
            carry, pre_step, (F_flat[:W, 0], F_flat[:W, 1], win_range))

        # Predicted first fire tick from the carried NCO state (tick is
        # nonzero when the pre-fire consumed some).
        th0 = thresh0(carry0.slot)
        tau0 = jnp.ceil((th0 - carry0.t_phase) / carry0.t_freq) - 1
        tau0 = carry0.tick + jnp.maximum(0, tau0).astype(jnp.int32)
        idx = tau0 + offsets[:, None] - delta + win_range[None, :]  # (S, W)
        cidx = jnp.clip(idx, 0, block_ticks - 1)
        w_re = jnp.take(F_flat[:, 0], cidx, axis=0)
        w_im = jnp.take(F_flat[:, 1], cidx, axis=0)

        carry1, outs = jax.lax.scan(step, carry0, (w_re, w_im, idx))
        if oqpsk:
            outs = jax.tree_util.tree_map(
                lambda p, o: jnp.concatenate([p[None], o]), pre_out, outs)
        return block_exit(cfg, carry1, new_tail), outs

    return demod_block


@functools.lru_cache(maxsize=16)
def jit_batch_block_demod(cfg: DemodConfig) -> Callable:
    """Cached batched (vmapped over leading axis) jitted block demodulator."""
    return jax.jit(jax.vmap(make_block_demod(cfg)))
