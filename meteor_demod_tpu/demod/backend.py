"""Recurrence-backend selection: the one place that picks the device path.

Both backends share the contract
  demod(carry, x) -> (carry', BlockOutput)
with a leading (batch,) axis on every carry leaf and x of shape
(batch, block_len, 2) float32:

- "kernel": the GPU recurrence kernel (kernels/recurrence.py), compiled
  for the card. It has no CPU lowering.
- "scan": the portable XLA `lax.scan` (demod/scan.py), vmapped over the
  batch.
- "kernel_interpret": the same kernel through the Pallas interpreter, so
  CPU tests can drive every host path through it. `default_backend`
  never picks it.

`default_backend` picks the kernel on a GPU and the scan elsewhere;
callers can force one with `backend=`.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax

from ..config import DemodConfig
from .scan import make_block_demod

BACKENDS = ("scan", "kernel", "kernel_interpret")


def default_backend() -> str:
    """The measured-faster backend for this process's device (PERF.md,
    kernel vs scan on the H100)."""
    return "kernel" if jax.devices()[0].platform == "gpu" else "scan"


def resolve_backend(backend: str) -> str:
    if backend == "auto":
        return default_backend()
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    return backend


@functools.lru_cache(maxsize=32)
def make_batch_demod(cfg: DemodConfig, batch: int,
                     backend: str = "auto") -> Callable:
    """Batched block demodulator; backend in {'auto'} + BACKENDS."""
    backend = resolve_backend(backend)
    if backend == "scan":
        return jax.vmap(make_block_demod(cfg))
    from ..kernels.recurrence import make_kernel_batch_demod
    return make_kernel_batch_demod(
        cfg, batch, interpret=backend == "kernel_interpret")


@functools.lru_cache(maxsize=32)
def jit_batch_demod(cfg: DemodConfig, batch: int,
                    backend: str = "auto") -> Callable:
    return jax.jit(make_batch_demod(cfg, batch, resolve_backend(backend)))


def make_single_demod(cfg: DemodConfig, backend: str = "auto") -> Callable:
    """Single-stream (no batch axis) block demodulator, unjitted."""
    backend = resolve_backend(backend)
    if backend == "scan":
        return make_block_demod(cfg)
    batched = make_batch_demod(cfg, 1, backend)

    def single(carry, x):
        carry1, outs = batched(
            jax.tree_util.tree_map(lambda a: a[None], carry), x[None])
        return jax.tree_util.tree_map(lambda a: a[0], (carry1, outs))

    return single


@functools.lru_cache(maxsize=32)
def jit_single_demod(cfg: DemodConfig, backend: str = "auto") -> Callable:
    """Single-stream (no batch axis) jitted block demodulator."""
    return jax.jit(make_single_demod(cfg, resolve_backend(backend)))
