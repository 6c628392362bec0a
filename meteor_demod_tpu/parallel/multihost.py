"""Multi-host fleet: the same shard_map demod on an N-process global mesh.

The reference is a single-process program; scaling it out means running N
copies (SURVEY.md §2, parallelism inventory). The equivalent here is ONE
logical fleet over the global device mesh of a multi-process job:

- `init_distributed` performs the jax.distributed rendezvous.
- `MultiHostFleet` is each process's view of the global FleetDemodulator:
  the carry and sample blocks are global arrays assembled from
  process-local rows (`jax.make_array_from_process_local_data`), the step
  is the same jitted shard_map program as parallel/mesh.py (SPMD: every
  process executes it over its local devices), per-stream outputs come back
  from the locally addressable shards, and the psum telemetry is replicated
  so every process sees fleet-global numbers.

Streams never move between hosts after input distribution: the demod hot
loop is host-local, only the (tiny) telemetry reduction crosses hosts.
Weak scaling is therefore bounded by input-feed bandwidth, not compute —
measured evidence in docs/SCALING.md and tests/test_multihost.py (a real
2-process CPU rendezvous whose fleet output is bit-identical to the
single-process run).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..config import DemodConfig
from ..demod.pipeline import egress
from ..demod.state import DemodCarry, init_carry
from ..dsp.fir import iq_to_f32
from .mesh import make_fleet_demod, make_mesh


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialize jax.distributed; a no-op if already initialized.

    Arguments default to JAX's env-based discovery (JAX_COORDINATOR_ADDRESS
    etc. / cluster runtime metadata). Initialization errors propagate —
    a failed rendezvous must not be silently ignored."""
    if jax.distributed.is_initialized():
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


@functools.lru_cache(maxsize=8)
def _telemetry_fn(mesh, axis_name: str):
    """Jitted fleet-global telemetry reduction over per-stream rows —
    the same psum fields as make_fleet_demod's step, recomputable after a
    host-side recovery splice (every process must call it collectively)."""
    from jax import shard_map
    import jax.numpy as jnp

    def stats(locked, lonce, gain, nvalid):
        return {
            "locked_streams": jax.lax.psum(jnp.sum(locked), axis_name),
            "locked_once_streams": jax.lax.psum(jnp.sum(lonce), axis_name),
            "symbols": jax.lax.psum(jnp.sum(nvalid), axis_name),
            "mean_agc_gain": jax.lax.pmean(jnp.mean(gain), axis_name),
        }

    sharded = shard_map(stats, mesh=mesh,
                        in_specs=(P(axis_name),) * 4,
                        out_specs=P(), check_vma=False)
    return jax.jit(sharded)


class MultiHostFleet:
    """Per-process handle on one global fleet across all hosts' devices.

    Each process feeds `process_local_blocks` the sample rows for ITS
    devices' streams (`local_stream_slice` says which global rows those
    are) and gets back those streams' BlockOutput plus the fleet-global
    telemetry. Global stream order follows `jax.devices()` order.
    """

    def __init__(self, cfg: DemodConfig, streams_per_device: int,
                 backend: str = "auto", axis_name: str = "streams",
                 recover_flagged: bool = True, telemetry_every: int = 1):
        cfg.validate()
        if telemetry_every < 1:
            raise ValueError("telemetry_every must be >= 1")
        self.cfg = cfg
        self.axis_name = axis_name
        self.mesh = make_mesh(jax.devices(), axis_name=axis_name)
        self.spd = streams_per_device
        self.n_streams = streams_per_device * len(jax.devices())
        self.n_local = streams_per_device * len(jax.local_devices())
        self._sharding = NamedSharding(self.mesh, P(axis_name))
        # Telemetry amortization (see make_fleet_demod / docs/SCALING.md):
        # the fleet-global psum — the step's ONLY collective, hence the
        # only lockstep barrier between hosts — runs every
        # telemetry_every-th block, mirroring the reference's UI-rate
        # getter polls (main.c:231-237). Between refresh ticks the
        # collective-free program runs and hosts proceed fully
        # independently; self.telemetry holds the last tick's values.
        # The block counter advances identically in every process (the
        # step is called in SPMD lockstep by construction), so all
        # processes always dispatch the same program.
        self.telemetry_every = telemetry_every
        self._block_idx = 0
        self._backend = backend
        self._fn = make_fleet_demod(cfg, self.mesh, axis_name, backend)
        self._fn_notel = (make_fleet_demod(cfg, self.mesh, axis_name,
                                           backend, telemetry=False)
                          if telemetry_every > 1 else None)
        c = init_carry(cfg)
        self.carry = jax.tree_util.tree_map(
            lambda x: jax.make_array_from_process_local_data(
                self._sharding,
                np.broadcast_to(np.asarray(x),
                                (self.n_local,) + x.shape).copy()),
            c)
        self.telemetry = None
        self.recover_flagged = recover_flagged
        self.recovered_streams = 0
        self.local_stream_flags = None

    def local_stream_slice(self) -> slice:
        """Global stream rows owned by this process (its devices' shards)."""
        devs = list(self.mesh.devices.flat)
        mine = [i for i, d in enumerate(devs)
                if d.process_index == jax.process_index()]
        lo, hi = min(mine), max(mine)
        assert mine == list(range(lo, hi + 1)), (
            "process devices are not contiguous in the mesh")
        return slice(lo * self.spd, (hi + 1) * self.spd)

    def process_local_blocks(self, local_blocks: np.ndarray):
        """local_blocks: (n_local, block_len) complex64 (or (..,2) float32)
        -> this process's rows of the fleet BlockOutput (numpy)."""
        if np.iscomplexobj(local_blocks):
            local_blocks = iq_to_f32(local_blocks)
        local_blocks = np.ascontiguousarray(local_blocks, dtype=np.float32)
        want = (self.n_local, self.cfg.block_len, 2)
        if local_blocks.shape != want:
            raise ValueError(f"expected {want}, got {local_blocks.shape}")
        prev_carry = self.carry
        x = jax.make_array_from_process_local_data(self._sharding,
                                                   local_blocks)
        tel_tick = (self._block_idx % self.telemetry_every) == 0
        self._block_idx += 1
        fn = self._fn if tel_tick else self._fn_notel
        self.carry, outs, telemetry = fn(self.carry, x)
        # Read back this process's shards of the outputs and safety flags,
        # and the replicated psum telemetry.
        outs_local = jax.tree_util.tree_map(self._local_rows, outs)
        self.local_stream_flags = self._local_rows(self.carry.flags)
        if tel_tick:
            self.telemetry = {
                k: np.asarray(next(iter(v.addressable_shards)).data)
                for k, v in telemetry.items()}
            # Collective recovery trigger: the psum'd flag count is
            # replicated, so EVERY process enters the rebuild whenever ANY
            # host flagged a stream; each recovers only its own rows (the
            # telemetry re-derivation inside is a collective psum). Same
            # always-exact contract as the single-host FleetDemodulator.
            if self.recover_flagged and int(self.telemetry["flags"]) != 0:
                outs_local = self._recover_local(prev_carry, local_blocks,
                                                 outs_local)
        elif self.recover_flagged and np.any(self.local_stream_flags):
            # Between refresh ticks the trigger is LOCAL (the per-stream
            # flags ride the per-block readback; no collective exists to
            # consult), so only flagging processes enter — the rebuild must
            # therefore skip the collective telemetry re-derivation
            # (collective=False): make_array_from_process_local_data is
            # metadata-only, and the corrected rows flow into the next
            # refresh tick's psum naturally.
            outs_local = self._recover_local(prev_carry, local_blocks,
                                             outs_local, collective=False)
        return outs_local

    def _recover_local(self, prev_carry: DemodCarry,
                       local_blocks: np.ndarray, outs_local,
                       collective: bool = True):
        """Re-demodulate this process's flagged streams with the exact
        scalar oracle (mirror of FleetDemodulator._recover, on local rows),
        then rebuild the global carry from this process's corrected local
        rows and — when `collective` (refresh-tick recovery, every process
        participating) — re-derive the fleet-global telemetry from the
        corrected state (one psum over the rebuilt rows — the same field
        semantics as FleetDemodulator._recover). collective=False is the
        between-ticks path: local-only rebuild, telemetry left at the last
        tick's values."""
        from ..demod import scalar
        from ..demod.pipeline import (numpy_carry_to_scalar_state,
                                      scalar_state_to_numpy_carry)
        from ..dsp.fir import f32_to_iq

        flagged = np.nonzero(np.asarray(self.local_stream_flags))[0]
        prev_np = jax.tree_util.tree_map(self._local_rows,
                                         prev_carry)._asdict()
        cur = {k: np.array(self._local_rows(v))
               for k, v in self.carry._asdict().items()}
        outs_local = outs_local.__class__(
            *(np.array(v) for v in outs_local))
        S = outs_local.sym_re.shape[1]
        for i in flagged:
            st = numpy_carry_to_scalar_state(
                self.cfg, {k: v[i] for k, v in prev_np.items()})
            sym, st = scalar.demod_stream_np(
                self.cfg, f32_to_iq(local_blocks[i]), st)
            n = len(sym)
            if n > S:
                raise RuntimeError(
                    f"local stream {i}: oracle produced {n} symbols > {S}")
            for k, v in scalar_state_to_numpy_carry(self.cfg, st).items():
                cur[k][i] = v
            outs_local.sym_re[i] = 0.0
            outs_local.sym_im[i] = 0.0
            outs_local.valid[i] = 0
            outs_local.sym_re[i, :n] = sym["re"]
            outs_local.sym_im[i, :n] = sym["im"]
            outs_local.valid[i, :n] = 1
            outs_local.locked_once[i, :n] = sym["locked_once"]
            outs_local.locked_once[i, n:] = st["locked_once"]
        self.recovered_streams += len(flagged)
        self.carry = DemodCarry(**{
            k: jax.make_array_from_process_local_data(self._sharding, v)
            for k, v in cur.items()})
        if not collective:
            return outs_local
        nvalid = jax.make_array_from_process_local_data(
            self._sharding,
            np.ascontiguousarray(outs_local.valid.sum(axis=1),
                                 dtype=np.int32))
        tel = _telemetry_fn(self.mesh, self.axis_name)(
            self.carry.locked, self.carry.locked_once,
            self.carry.agc_gain, nvalid)
        self.telemetry = {k: np.asarray(v) for k, v in egress(tel).items()}
        self.telemetry["flags"] = np.int32(0)
        return outs_local

    # -- checkpoint state (io/checkpoint.py wraps these in .npz files) --

    def state_dict(self) -> tuple[dict, dict]:
        """(json-able meta, numpy arrays) capturing THIS PROCESS's view:
        its local carry rows plus the replicated host-side counters. In a
        multi-host job every process saves its own file (same block
        index by SPMD construction); restore runs collectively with the
        same process count."""
        import dataclasses
        arrays = {f"carry_{k}": np.asarray(self._local_rows(v))
                  for k, v in self.carry._asdict().items()}
        if self.local_stream_flags is not None:
            arrays["local_stream_flags"] = np.asarray(
                self.local_stream_flags)
        meta = dict(
            cfg=dataclasses.asdict(self.cfg),
            streams_per_device=self.spd,
            axis_name=self.axis_name,
            backend=self._backend,
            telemetry_every=self.telemetry_every,
            recover_flagged=self.recover_flagged,
            block_idx=self._block_idx,
            recovered_streams=int(self.recovered_streams),
            n_local=self.n_local, n_streams=self.n_streams,
            telemetry=(None if self.telemetry is None else
                       {k: float(v) for k, v in self.telemetry.items()}))
        return meta, arrays

    def restore_state(self, meta: dict, z, prefix: str = "") -> None:
        """Overwrite this process's state from a state_dict capture. The
        job must have the same process count and local device count as at
        save time (checked via n_local/n_streams)."""
        p = prefix
        if (meta["n_local"] != self.n_local
                or meta["n_streams"] != self.n_streams):
            raise ValueError(
                f"checkpoint topology (n_local {meta['n_local']}, "
                f"n_streams {meta['n_streams']}) does not match this job "
                f"({self.n_local}, {self.n_streams})")
        self.telemetry_every = meta["telemetry_every"]
        if self.telemetry_every > 1 and self._fn_notel is None:
            self._fn_notel = make_fleet_demod(
                self.cfg, self.mesh, self.axis_name, self._backend,
                telemetry=False)
        self.recover_flagged = meta["recover_flagged"]
        self.carry = DemodCarry(**{
            k[len(p) + len("carry_"):]:
                jax.make_array_from_process_local_data(
                    self._sharding, np.ascontiguousarray(z[k]))
            for k in z.files
            if k.startswith(f"{p}carry_")})
        self._block_idx = int(meta["block_idx"])
        self.recovered_streams = int(meta["recovered_streams"])
        if f"{p}local_stream_flags" in z.files:
            self.local_stream_flags = np.asarray(
                z[f"{p}local_stream_flags"]).copy()
        if meta["telemetry"] is not None:
            self.telemetry = {
                k: (np.float32(v) if k == "mean_agc_gain"
                    else np.int32(v))
                for k, v in meta["telemetry"].items()}

    def flagged_local_streams(self) -> np.ndarray:
        """Local stream rows that tripped a safety flag in the last block
        (already recovered exactly when recover_flagged, the default)."""
        if self.local_stream_flags is None:
            return np.zeros(0, dtype=np.int64)
        return np.nonzero(np.asarray(self.local_stream_flags))[0]

    @staticmethod
    def _local_rows(arr) -> np.ndarray:
        """This process's shards of a global array, concatenated in global
        row order."""
        shards = sorted(arr.addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        return np.concatenate([np.asarray(s.data) for s in shards], axis=0)


def global_fleet(cfg: DemodConfig, streams_per_device: int = 128,
                 backend: str = "auto") -> MultiHostFleet:
    """MultiHostFleet over all devices of the (possibly multi-host) job."""
    return MultiHostFleet(cfg, streams_per_device, backend=backend)
