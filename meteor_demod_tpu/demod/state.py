"""Explicit demodulator state.

The reference keeps all DSP state in file-scope C statics (pll.c:16-22,
timing.c:13-16, agc.c:9-10, demod.c:54, filter delay line filter.h:5-11).
Here the same quantities form an explicit pytree carried through lax.scan —
which also makes a serialized carry a complete, free checkpoint of the
demodulator (see SURVEY.md section 5, checkpoint/resume).

All leaves are float32/int32 scalars (or the (taps-1, 2) float32 FIR tail);
IQ pairs are stored as separate re/im floats, never complex64 (see
dsp/fir.py on the IQ layout). A batched demodulator simply carries
(B,)-shaped leaves via vmap.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

# Flag bits (see scan.py): any nonzero flag means "this block must be
# recomputed by the exact scalar fallback" — a should-never-happen safety net.
FLAG_WINDOW_MISS = 1   # a gate fire landed outside the prematerialized window
FLAG_UNCONSUMED = 2    # scan steps exhausted before the block's ticks were


class DemodCarry(NamedTuple):
    # Timing recovery (timing.c:13-16)
    t_phase: jnp.ndarray   # f32, NCO phase accumulator
    t_freq: jnp.ndarray    # f32, NCO frequency (rad/tick)
    t_prev: jnp.ndarray    # f32, previous symbol Q for the M&M error
    # Carrier PLL (pll.c:16-22)
    p_phase: jnp.ndarray   # f32
    p_freq: jnp.ndarray    # f32
    p_err: jnp.ndarray     # f32, lock-detector EMA
    locked: jnp.ndarray    # int32 0/1
    locked_once: jnp.ndarray  # int32 0/1
    updown: jnp.ndarray    # f32 +-1, acquisition sweep direction (pll.c:111)
    # AGC (agc.c:9-10)
    agc_gain: jnp.ndarray  # f32
    agc_bias_re: jnp.ndarray  # f32, DC-bias tracker real part
    agc_bias_im: jnp.ndarray  # f32, DC-bias tracker imag part
    # OQPSK half-symbol state (demod.c:54, timing.c:42)
    inphase: jnp.ndarray   # f32
    slot: jnp.ndarray      # int32 1/2, dual-timeslot NCO state
    # Block plumbing
    tick: jnp.ndarray      # int32, ticks consumed within the current block
    fir_tail: jnp.ndarray  # f32 (taps-1, 2), FIR delay-line carry
    flags: jnp.ndarray     # int32 bitmask, sticky across blocks


def init_carry(cfg) -> DemodCarry:
    """Initial state, mirroring the reference init paths (pll.c:24-44,
    timing.c:18-27, agc.c:9-10, calloc'd filter memory filter.c:15)."""
    f32 = lambda v: jnp.asarray(v, dtype=jnp.float32)
    i32 = lambda v: jnp.asarray(v, dtype=jnp.int32)
    return DemodCarry(
        t_phase=f32(0.0),
        t_freq=f32(cfg.timing_freq),
        t_prev=f32(0.0),
        p_phase=f32(0.0),
        p_freq=f32(0.0),
        p_err=f32(1000.0),
        locked=i32(0),
        locked_once=i32(0),
        updown=f32(1.0),
        agc_gain=f32(1.0),
        agc_bias_re=f32(0.0),
        agc_bias_im=f32(0.0),
        inphase=f32(0.0),
        slot=i32(1),
        tick=i32(0),
        fir_tail=jnp.zeros((cfg.taps - 1, 2), dtype=jnp.float32),
        flags=i32(0),
    )


def batch_carry(cfg, batch: int) -> DemodCarry:
    """Initial carry with a leading batch axis on every leaf."""
    import jax
    c = init_carry(cfg)
    return jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (batch,) + x.shape).copy(), c)


def batch_carry_np(cfg, batch: int) -> DemodCarry:
    """batch_carry with NUMPY leaves — identical values, zero device
    traffic (constructing the jnp version and reading it back costs one
    host<->device round trip per leaf; demod/turbo.py builds warmup
    carries per span/recording)."""
    f32 = lambda v: np.full((batch,), v, dtype=np.float32)
    i32 = lambda v: np.full((batch,), v, dtype=np.int32)
    return DemodCarry(
        t_phase=f32(0.0),
        t_freq=f32(float(cfg.timing_freq)),
        t_prev=f32(0.0),
        p_phase=f32(0.0),
        p_freq=f32(0.0),
        p_err=f32(1000.0),
        locked=i32(0),
        locked_once=i32(0),
        updown=f32(1.0),
        agc_gain=f32(1.0),
        agc_bias_re=f32(0.0),
        agc_bias_im=f32(0.0),
        inphase=f32(0.0),
        slot=i32(1),
        tick=i32(0),
        fir_tail=np.zeros((batch, cfg.taps - 1, 2), np.float32),
        flags=i32(0),
    )


class BlockOutput(NamedTuple):
    """Per-scan-step outputs of one block, shapes (S,) (or (B, S) batched)."""
    sym_re: jnp.ndarray       # f32 soft symbol I (valid only where valid)
    sym_im: jnp.ndarray       # f32 soft symbol Q
    valid: jnp.ndarray        # int32 0/1, 1 where a symbol was produced
    locked_once: jnp.ndarray  # int32, locked_once state after this symbol


class PackedOutput(NamedTuple):
    """Device-QUANTIZED per-step outputs (fleet packed_output=True): the
    .s byte values computed on device — quantize_symbols' exact math
    (component/2, clamp +-127, trunc toward zero; main.c:305-306) — so
    the serving egress carries int8 end-to-end, ~4x less device->host
    traffic than the f32 BlockOutput."""
    sym_i: jnp.ndarray        # int8 quantized I
    sym_q: jnp.ndarray        # int8 quantized Q
    valid: jnp.ndarray        # int8 0/1
    locked_once: jnp.ndarray  # int8


def carry_to_numpy(carry: DemodCarry) -> dict:
    return {k: np.asarray(v) for k, v in carry._asdict().items()}
