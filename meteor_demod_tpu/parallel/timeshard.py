"""Sequence (time-block) parallelism: one stream sharded across devices.

The reference is a strictly sequential per-sample recurrence (SURVEY.md §5,
"long-context / sequence parallelism"). The decomposition splits a long
IQ stream along time:

- **FIR (no feedback)**: each device filters its own time shard, importing a
  halo of the last `taps-1` samples from its left neighbor via
  `jax.lax.ppermute` between devices — the distributed form of the overlap-save
  delay-line carry (filter.c:41-42). N-shard output equals 1-device output
  exactly (tests/test_parallel.py).
- **Feedback loops (AGC/PLL/timing)**: sequential by construction; the carry
  hands off between consecutive time shards. `sharded_fir` + the per-device
  dense tick arrays let the recurrence run shard-by-shard while later
  shards' FIR is already computed — a pipeline where the FLOP-heavy half is
  fully parallel and only the tiny scalar recurrence serializes.

For throughput scaling the primary axis remains the stream fleet
(parallel/mesh.py); time sharding serves latency on a single long recording.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..config import DemodConfig
from ..dsp.fir import make_fir_banks, polyphase_fir_block


@functools.lru_cache(maxsize=8)
def make_sharded_fir(cfg: DemodConfig, mesh: Mesh,
                     axis_name: str = "time") -> Callable:
    """Build fir(x) -> F over a time-sharded stream.

    x: (n_dev * L, 2) float32, sharded along time. Returns
    F: (n_dev * L, interp, 2) with identical values to the single-device
    overlap-save FIR starting from a zero delay line.
    """
    banks = make_fir_banks(cfg)
    taps = cfg.taps
    n_dev = mesh.devices.size

    def local_fir(x_shard):
        # Import the last taps-1 samples of the LEFT neighbor as the halo;
        # device 0 keeps the zero delay line (calloc'd memory, filter.c:15).
        tail = x_shard[-(taps - 1):]
        perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
        halo = jax.lax.ppermute(tail, axis_name, perm)
        idx = jax.lax.axis_index(axis_name)
        halo = jnp.where(idx == 0, jnp.zeros_like(halo), halo)
        F, _ = polyphase_fir_block(x_shard, halo, banks)
        return F

    fn = shard_map(local_fir, mesh=mesh,
                   in_specs=P(axis_name),
                   out_specs=P(axis_name),
                   check_vma=False)
    return jax.jit(fn)


def time_mesh(devices=None, axis_name: str = "time") -> Mesh:
    devs = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devs), (axis_name,))
