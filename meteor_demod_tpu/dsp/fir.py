"""Block polyphase RRC matched filter.

The reference evaluates one 65-tap complex-by-real dot product per symbol
from a circular delay line (filter.c:38-65) — its hot kernel. Here ALL
interpolated outputs of a block are computed densely as a 1-D correlation
with `interp` output channels (overlap-save, the previous block's taps-1
samples carried as a halo), which XLA lowers as a batched convolution. The
downstream recurrence then just reads the ticks the timing gate fires on.

IQ layout: float32 (..., 2) re/im pairs, never complex64, device-side:
complex ops lower to real-pair arithmetic anyway, and float32 pairs are
what the recurrence kernel gathers.

F[s, p, :] equals the reference's filter_get(phase=p) evaluated right after
sample s was pushed (filter.c:45-65): an oldest-first dot product of
x[s-taps+1 .. s] with polyphase bank factor-1-p.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .rrc import polyphase_rrc_banks


def make_fir_banks(cfg) -> np.ndarray:
    """(interp, taps) float32 bank matrix for cfg (demod.c:14 parameters)."""
    return polyphase_rrc_banks(cfg.rrc_order, cfg.osf, cfg.rrc_alpha, cfg.interp)


def polyphase_fir_block(x: jnp.ndarray, tail: jnp.ndarray,
                        banks: np.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Dense polyphase FIR over one block.

    Lowering: a 1-input-channel, `interp`-output-channel correlation
    (conv_general_dilated, which XLA hands to cuDNN on a GPU). HIGHEST
    precision keeps full f32 accuracy — without it a GPU may run the conv
    in TF32 (~3 decimal digits), and the FIR feeds the decision path:
    parity with the numpy oracle and the C binary needs ~1e-5 relative
    here. The conv is also bitwise shape-independent on the CPU, which the
    time-shard N-shard == 1-shard equality tests rely on.

    Args:
      x: (L, 2) float32 input samples (re, im).
      tail: (taps-1, 2) float32 — the last taps-1 samples of the previous
        block (zeros at stream start, matching the calloc'd delay line,
        filter.c:15).
      banks: (interp, taps) float32, oldest-first taps per phase.

    Returns:
      F: (L, interp, 2) float32 — all interpolated filter outputs;
        F[s, p] corresponds to tick s*interp + p.
      new_tail: (taps-1, 2) float32.
    """
    interp, taps = np.shape(banks)
    xin = jnp.concatenate([tail, x])                      # (L + taps - 1, 2)
    lhs = xin.T[:, None, :]                               # (2, 1, L+taps-1)
    rhs = jnp.asarray(banks)[:, None, :]                  # (interp, 1, taps)
    out = jax.lax.conv_general_dilated(
        lhs, rhs,
        window_strides=(1,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )                                                     # (2, interp, L)
    return out.transpose(2, 1, 0), xin[-(taps - 1):]


def iq_to_f32(x: np.ndarray) -> np.ndarray:
    """complex64 (host) -> (..., 2) float32 (device layout). Zero-copy view."""
    return np.ascontiguousarray(x, dtype=np.complex64).view(np.float32).reshape(
        x.shape + (2,))


def f32_to_iq(x: np.ndarray) -> np.ndarray:
    """(..., 2) float32 -> complex64."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    return x.view(np.complex64).reshape(x.shape[:-1])


def fir_reference_np(x: np.ndarray, tail: np.ndarray, banks: np.ndarray) -> np.ndarray:
    """Direct numpy evaluation of F (oldest-first dots) for testing.

    x, tail complex64; returns complex64 (L, interp)."""
    interp, taps = banks.shape
    xin = np.concatenate([tail.astype(np.complex64), x.astype(np.complex64)])
    L = len(x)
    F = np.empty((L, interp), dtype=np.complex64)
    for s in range(L):
        win = xin[s:s + taps]
        for p in range(interp):
            F[s, p] = np.dot(win, banks[p].astype(np.float32))
    return F
