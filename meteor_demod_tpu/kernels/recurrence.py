"""GPU kernel: the per-symbol demod recurrence for a batch of streams.

Why a kernel: the portable XLA path (demod/scan.py) runs one `lax.scan`
iteration per symbol — about 2,560 serial steps per 8,192-sample block,
each a few dozen scalar ops per stream — and on a GPU every iteration pays
the while-loop's own control and launch cost. This kernel runs the whole
block's recurrence inside one launch: each stream is one lane, a program
owns a power-of-two tile of lanes, every DemodCarry leaf lives in registers,
and a `fori_loop` walks the block's symbol steps.

The step math is NOT a copy: the kernel traces demod/scan.py's own
`_make_symbol_step` / `_make_paired_step` (and the OQPSK block-entry
pre-fire) with two substitutions — the fired tick's FIR output is read by a
per-lane gather load from the block's FIR output instead of from a
prebuilt candidate window, and the Costas tanh table is read from a kernel
input (a kernel cannot capture array constants). A direct load cannot miss,
so the kernel never raises FLAG_WINDOW_MISS for a fire; the OQPSK deferred-
completion and unconsumed-block flags are the scan's.

Route: Pallas through Triton (`backend="triton"`), whose interpret mode runs
the same kernel on the CPU for tests. The FIR stays in XLA
(dsp/fir.polyphase_fir_block, vmapped); its (B, L, interp, 2) output is the
kernel's gather source as it stands.

Numerics: in interpret mode (XLA:CPU) the kernel and the scan make the same
decisions. On the card the compiler contracts a*b+c into FMAs, which moves
loop-state values by ULPs; the closed-form gate keeps fire decisions
FMA-proof per step, but the drifted trajectory can move an occasional fire
by one tick relative to the numpy oracle. Product contracts that need
exactness (turbo fingerprints, flag replay) compare the kernel with itself,
which is deterministic.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import DemodConfig
from ..demod.scan import block_entry, block_exit, make_steps
from ..demod.state import BlockOutput, DemodCarry
from ..dsp.fir import make_fir_banks, polyphase_fir_block
from ..dsp.loops import TANH_TABLE

# Lanes (streams) per program. One warp per 32 lanes.
TILE = 32
_LEAVES = tuple(f for f in DemodCarry._fields if f != "fir_tail")
# Flat gather offsets are int32: lanes * 2 * block_ticks must stay below.
_MAX_FLAT = 2 ** 31 - 1


def _next_pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _make_kernel(cfg: DemodConfig, n_lanes: int, tile: int) -> Callable:
    T = cfg.block_ticks
    S = cfg.steps_per_block
    row0 = 1 if cfg.oqpsk else 0
    nl = len(_LEAVES)

    def kernel(f_ref, tanh_ref, *refs):
        carry_in = refs[:nl]
        sre_ref, sim_ref, val_ref, lo_ref = refs[nl:nl + 4]
        carry_out = refs[nl + 4:]
        lo = pl.program_id(0) * tile
        lanes = lo + jax.lax.iota(jnp.int32, tile)
        # Padding lanes read the last real lane's samples (discarded).
        base = jnp.minimum(lanes, n_lanes - 1) * (2 * T)

        def fetch(_, tau, fired):
            off = base + jnp.clip(tau, 0, T - 1) * 2
            z_re = jnp.where(fired, f_ref[off], jnp.float32(0.0))
            z_im = jnp.where(fired, f_ref[off + 1], jnp.float32(0.0))
            return z_re, z_im, jnp.zeros_like(fired)

        def tanh(v):
            idx = jnp.clip(jnp.trunc(v), -16.0, 15.0).astype(jnp.int32) + 16
            return tanh_ref[idx]

        step, pre_step = make_steps(cfg, fetch, tanh,
                                    _next_pow2(cfg.gate_candidates))
        lane_sl = pl.ds(lo, tile)

        def store(row, out):
            sre_ref[row, lane_sl] = out.sym_re
            sim_ref[row, lane_sl] = out.sym_im
            val_ref[row, lane_sl] = out.valid
            lo_ref[row, lane_sl] = out.locked_once

        carry = DemodCarry(fir_tail=None, **{
            k: r[lane_sl] for k, r in zip(_LEAVES, carry_in)})
        carry, pre_out = block_entry(carry, pre_step, None)
        if pre_out is not None:
            store(0, pre_out)

        def body(s, c):
            c, out = step(c, None)
            store(s + row0, out)
            return c

        carry = jax.lax.fori_loop(0, S, body, carry)
        for k, r in zip(_LEAVES, carry_out):
            r[lane_sl] = getattr(carry, k)

    return kernel


def _recurrence_call(cfg: DemodConfig, n_lanes: int, tile: int,
                     interpret: bool) -> Callable:
    """pallas_call over n_lanes streams: (F_flat, tanh, *leaves) ->
    (sym_re, sym_im, valid, locked_once (rows, B_pad), *leaves (B_pad,))."""
    b_pad = -(-n_lanes // tile) * tile
    rows = cfg.steps_per_block + (1 if cfg.oqpsk else 0)
    nl = len(_LEAVES)
    leaf_dtypes = [jnp.int32 if k in ("locked", "locked_once", "slot",
                                      "tick", "flags") else jnp.float32
                   for k in _LEAVES]
    out_shape = (
        [jax.ShapeDtypeStruct((rows, b_pad), jnp.float32)] * 2
        + [jax.ShapeDtypeStruct((rows, b_pad), jnp.int32)] * 2
        + [jax.ShapeDtypeStruct((b_pad,), d) for d in leaf_dtypes])
    return pl.pallas_call(
        _make_kernel(cfg, n_lanes, tile),
        out_shape=out_shape,
        grid=(b_pad // tile,),
        input_output_aliases={2 + i: 4 + i for i in range(nl)},
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=max(1, tile // 32), num_stages=1),
        interpret=interpret,
        name="demod_recurrence",
    )


def make_kernel_batch_demod(cfg: DemodConfig, batch: int, tile: int = TILE,
                            interpret: bool = False) -> Callable:
    """Batched block demodulator with the demod/backend.py contract:
    demod(carry, x) -> (carry', BlockOutput), x (batch, block_len, 2) f32,
    every carry leaf with a leading (batch,) axis.

    interpret=True runs the kernel through the Pallas interpreter (CPU
    tests); the product path never asks for it."""
    cfg.validate()
    banks = make_fir_banks(cfg)
    T = cfg.block_ticks
    tile = min(tile, _next_pow2(batch))
    # Split batches whose flat FIR offsets would overflow int32.
    per_call = max(tile, (_MAX_FLAT // (2 * T)) // tile * tile)
    spans = [(b, min(batch, b + per_call))
             for b in range(0, batch, per_call)]
    calls = {n: _recurrence_call(cfg, n, tile, interpret)
             for n in {hi - lo for lo, hi in spans}}
    tanh_tab = np.asarray(TANH_TABLE, np.float32)

    def demod(carry: DemodCarry, x: jnp.ndarray):
        F, new_tail = jax.vmap(
            lambda xs, ts: polyphase_fir_block(xs, ts, banks))(
                x, carry.fir_tail)                    # (B, L, interp, 2)
        f_flat = F.reshape(batch, -1)
        outs_parts, leaf_parts = [], []
        for lo, hi in spans:
            n = hi - lo
            b_pad = -(-n // tile) * tile
            leaves = [jnp.pad(jnp.asarray(getattr(carry, k))[lo:hi],
                              (0, b_pad - n), mode="edge")
                      for k in _LEAVES]
            res = calls[n](f_flat[lo:hi].reshape(-1), tanh_tab, *leaves)
            outs_parts.append([o[:, :n].T for o in res[:4]])
            leaf_parts.append([o[:n] for o in res[4:]])
        cat = lambda parts: [jnp.concatenate(p) if len(p) > 1 else p[0]
                             for p in zip(*parts)]
        sym_re, sym_im, valid, lonce = cat(outs_parts)
        carry1 = DemodCarry(fir_tail=new_tail,
                            **dict(zip(_LEAVES, cat(leaf_parts))))
        return (block_exit(cfg, carry1, new_tail),
                BlockOutput(sym_re=sym_re, sym_im=sym_im, valid=valid,
                            locked_once=lonce))

    return demod
