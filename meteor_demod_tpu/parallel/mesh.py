"""Device-mesh scale-out: fleet demodulation over `jax.sharding`.

The reference is a single-process, single-stream program (SURVEY.md §2,
"Parallelism & distribution inventory"); its only concurrency is a UI thread.
The scale story replaces that with:

- **Batch (fleet) parallelism**: many independent recordings/channels demodulate
  concurrently. Each stream's carry and sample blocks get a leading `streams`
  axis, sharded over the mesh with `shard_map`. Per-device work is the batched
  block demodulator (demod/backend.py); each stream is one lane. No
  cross-device traffic in the hot loop — collectives appear only in fleet
  telemetry reductions (psum over the device interconnect), mirroring how the
  reference's UI thread polls DSP getters (main.c:231-237) without touching
  the hot path.
- **Multi-host**: the same code runs under `jax.distributed` with a global mesh;
  streams shard across hosts, the telemetry psum spans them.

A mesh with a second `time` axis is reserved for sequence-parallel FIR
(overlap-save halo exchange via `collective_permute`) — see parallel/timeshard.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import DemodConfig
from ..demod.pipeline import egress

from ..demod.state import DemodCarry, PackedOutput, init_carry
from ..dsp.fir import iq_to_f32


def make_mesh(devices: Sequence[jax.Device] | None = None,
              axis_name: str = "streams") -> Mesh:
    """1-D fleet mesh over the given (default: all) devices."""
    devs = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devs), (axis_name,))


def fleet_carry(cfg: DemodConfig, n_streams: int, mesh: Mesh,
                axis_name: str = "streams") -> DemodCarry:
    """Initial per-stream carry, sharded over the mesh's stream axis."""
    c = init_carry(cfg)
    sharding = NamedSharding(mesh, P(axis_name))
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(
            np.broadcast_to(np.asarray(x), (n_streams,) + x.shape).copy(),
            sharding),
        c)


def shard_blocks(blocks: np.ndarray, mesh: Mesh,
                 axis_name: str = "streams") -> jax.Array:
    """Place a (n_streams, block_len, 2) f32 sample batch on the mesh."""
    return jax.device_put(blocks, NamedSharding(mesh, P(axis_name)))


@functools.lru_cache(maxsize=16)
def make_fleet_demod(cfg: DemodConfig, mesh: Mesh,
                     axis_name: str = "streams",
                     backend: str = "auto",
                     telemetry: bool = True,
                     chain: int = 1,
                     ingest: str = "f32",
                     packed: bool = False) -> Callable:
    """Build the jitted fleet step: (carry, blocks) -> (carry', outs, telemetry).

    carry leaves and blocks have a leading `streams` axis sharded over the
    mesh. telemetry is a small replicated dict reduced with psum — the only
    collective in the step, equivalent to the reference's cross-thread
    telemetry reads (main.c:231-237) but aggregated fleet-wide.

    telemetry=False builds the COLLECTIVE-FREE step (returns an empty
    telemetry dict): the reference polls its DSP getters at the UI refresh
    interval (main.c:231-237, -R 50/2000 ms), not per processed buffer —
    fleets mirror that by dispatching this program between refresh ticks
    (FleetDemodulator/MultiHostFleet telemetry_every), so the hot loop has
    ZERO cross-device traffic and no lockstep barrier (docs/SCALING.md,
    telemetry amortization).

    chain=K runs K consecutive blocks per dispatch through an in-program
    lax.scan — the shape every bench headline is measured in (one upload,
    one readback, one dispatch per K blocks; the per-dispatch host round
    trip is the serving host's dominant cost at K=1). blocks gain a block
    axis (B, K, L, 2) and the outputs come back step-concatenated
    (B, K*S) — consumers see one wider block. carry.flags is OR-sticky
    across the chain (demod/scan.py:198), so a mid-chain excursion
    surfaces in the post-chain readback and the oracle recovery replays
    the stream's whole K-block span."""
    from ..demod.backend import make_batch_demod

    def step(carry: DemodCarry, blocks: jnp.ndarray):
        # Inside shard_map the step sees the per-device shard; its leading
        # dim (n_streams / n_devices) picks the right batched builder.
        # Raw ingest (ingest != "f32"): samples arrive as the SDR's raw
        # integer format and decode ON DEVICE — bit-exactly io/wav.py
        # decode_iq's math (i16: float cast; u8: float - 128) — so the
        # host uploads 2x (i16) / 4x (u8) fewer bytes; XLA fuses the cast
        # into the chain program.
        if ingest == "i16":
            blocks = blocks.astype(jnp.float32)
        elif ingest == "u8":
            blocks = blocks.astype(jnp.float32) - jnp.float32(128.0)
        demod = make_batch_demod(cfg, blocks.shape[0], backend)
        if chain == 1:
            carry, outs = demod(carry, blocks)
        else:
            xs = jnp.swapaxes(blocks, 0, 1)          # (K, B, L, 2)
            carry, outs = jax.lax.scan(demod, carry, xs)
            outs = jax.tree_util.tree_map(           # (K,B,S) -> (B,K*S)
                lambda a: jnp.swapaxes(a, 0, 1).reshape(a.shape[1], -1),
                outs)
        if packed:
            # Device-side quantization (state.PackedOutput): the .s byte
            # math runs on device and the egress shrinks ~4x. Telemetry
            # still reduces over the pre-packed valid.
            packed_outs = PackedOutput(
                sym_i=jnp.trunc(jnp.clip(
                    outs.sym_re * jnp.float32(0.5),
                    -127.0, 127.0)).astype(jnp.int8),
                sym_q=jnp.trunc(jnp.clip(
                    outs.sym_im * jnp.float32(0.5),
                    -127.0, 127.0)).astype(jnp.int8),
                valid=outs.valid.astype(jnp.int8),
                locked_once=outs.locked_once.astype(jnp.int8))
        else:
            packed_outs = outs
        if not telemetry:
            return carry, packed_outs, {}
        tel = {
            "locked_streams": jax.lax.psum(
                jnp.sum(carry.locked), axis_name),
            "locked_once_streams": jax.lax.psum(
                jnp.sum(carry.locked_once), axis_name),
            "symbols": jax.lax.psum(
                jnp.sum(outs.valid.astype(jnp.int32)), axis_name),
            "mean_agc_gain": jax.lax.pmean(
                jnp.mean(carry.agc_gain), axis_name),
            "flags": jax.lax.psum(jnp.sum(carry.flags), axis_name),
        }
        return carry, packed_outs, tel

    sharded = shard_map(
        step, mesh=mesh,
        in_specs=(P(axis_name), P(axis_name)),
        out_specs=(P(axis_name), P(axis_name), P()),
        check_vma=False)
    return jax.jit(sharded)


class _ParkedStream:
    """Host-side state of one parked stream (see FleetDemodulator:
    straggler parking). `carry` holds unbatched numpy carry leaves —
    always the exact sequential state through the last processed block."""

    def __init__(self, carry_leaves: dict):
        self.carry = carry_leaves
        self.out_rows = []
        self.locked = bool(int(carry_leaves["locked"]))
        self.locked_streak = 0
        self.blocks_fed = 0
        self.blocks_done = 0
        # Sweep rescue (FleetDemodulator.sweep_rescue_s): the tick thread
        # requests a kick; the worker — the sole carry mutator — applies
        # it before the next step.
        self.kick_wanted = False
        self.last_kick_fed = 0


class FleetDemodulator:
    """Demodulate a fleet of independent IQ streams across a device mesh.

    The equivalent of running N reference processes (BASELINE.json
    configs[4]): feed aligned (n_streams, block_len) blocks, collect
    per-stream symbols + fleet telemetry.
    """

    def __init__(self, cfg: DemodConfig, n_streams: int,
                 mesh: Mesh | None = None, axis_name: str = "streams",
                 backend: str = "auto", recover_flagged: bool = True,
                 telemetry_every: int = 1, park: bool = True,
                 park_after: int = 6, unpark_after: int = 2,
                 park_max: int | None = None, flap_park: int = 6,
                 sweep_rescue_s: float = 0.0, chain_blocks: int = 1,
                 ingest: str = "f32", packed_output: bool = False):
        cfg.validate()
        self.cfg = cfg
        self.axis_name = axis_name
        self.mesh = mesh if mesh is not None else make_mesh(axis_name=axis_name)
        n_dev = self.mesh.devices.size
        if n_streams % n_dev != 0:
            raise ValueError(
                f"n_streams {n_streams} must be divisible by mesh size {n_dev}")
        if telemetry_every < 1:
            raise ValueError("telemetry_every must be >= 1")
        if chain_blocks < 1:
            raise ValueError("chain_blocks must be >= 1")
        if ingest not in ("f32", "i16", "u8"):
            raise ValueError(f"unsupported ingest {ingest!r}")
        # Raw integer ingest (see make_fleet_demod): blocks arrive as
        # int16 / uint8 (L, 2) sample pairs and decode on device —
        # 2x/4x less host->device traffic, the binding constraint for a
        # link-bound serving host. Host-side paths that need f32 (parked
        # worker feed, oracle recovery) decode lazily per stream.
        self.ingest = ingest
        # Device-side output quantization (state.PackedOutput): outputs
        # come back as the final .s int8 byte values — ~4x less
        # device->host traffic. The oracle recovery and parked paths
        # splice host-quantized values with the identical math.
        self.packed_output = bool(packed_output)
        self.n_streams = n_streams
        self._backend = backend
        # Chained dispatch (make_fleet_demod chain=K): K consecutive
        # blocks per device call. The bench headlines are measured in
        # this shape (CHAIN=16); at K=1 a serving host is dominated by
        # the per-dispatch host round trip. Policy ticks (telemetry,
        # parking, rescue) then advance once per K blocks.
        self.chain_blocks = int(chain_blocks)
        # Straggler parking: a dead antenna / never-locking input leaves
        # the fleet's lock accounting (which counts NON-PARKED streams
        # only) and the device hot path (the reference has no such
        # coupling — each process is one stream, main.c:284-329). A
        # stream unlocked for `park_after` consecutive
        # telemetry ticks while at least one other stream IS locked — or
        # one that FLAPS its lock bit >= `flap_park` transitions between
        # resets (the switch-thrash debounce) — is parked OFF the device
        # hot path onto an exact host-side program (the same scan step on
        # the CPU backend; the numpy oracle if no CPU backend exists).
        # Its device lane is fed a donor stream's data (discarded), its
        # deferred symbols drain via parked_output(), and once the host
        # demod reports locked for `unpark_after` ticks the exact host
        # carry is spliced back into the lane — bit-continuous resume.
        self.park_enabled = bool(park)
        self.park_after = int(park_after)
        self.unpark_after = int(unpark_after)
        self.park_max = (max(1, n_streams // 16) if park_max is None
                         else int(park_max))
        self.flap_park = int(flap_park)
        # Sweep rescue (opt-in; 0 = off = exact reference acquisition).
        # The reference's upward-first sweep has a measured DEAD ZONE:
        # small-negative carrier offsets trap the loop in a stable false
        # equilibrium near 0 Hz (mean Costas feedback cancels the sweep
        # step; -195 Hz @ 25 dB never locks in 68 s, and the C binary
        # shares the stall — pll.c:109-130, docs/PERF.md "acquisition
        # dead zone"). A DOWNWARD pass from the +fmax rail captures every
        # carrier in range (measured: lock ~4 s after the kick at the
        # sweep's 825 Hz/s transit). So: a stream unlocked for
        # sweep_rescue_s seconds of signal gets its carry KICKED on the
        # host side — p_freq=+fmax, updown=-1 — restarting acquisition on
        # the escape trajectory. Pure orchestration: no decision-structure
        # change, the kernel/scan/oracle programs are untouched, and the
        # kick is the same host-side carry splice parking uses. Applies to
        # device lanes at telemetry ticks and to parked host carries via
        # the park worker.
        self.set_sweep_rescue(sweep_rescue_s)
        self._rescue_streak = np.zeros(n_streams, np.int64)
        self._parked: dict[int, _ParkedStream] = {}
        self._retired_rows: dict[int, list] = {}
        self._unlock_streak = np.zeros(n_streams, np.int64)
        self._flap_count = np.zeros(n_streams, np.int64)
        self._tick_idx = 0
        self._lonce_vec = None
        self._agc_vec = None
        self._last_locked_vec = None
        self._active_locked = None     # locked count among non-parked lanes
        # Set by a flagged block, cleared at the next tick; selects no
        # program on the current device path (ROADMAP queue 3 item 2).
        self._wide_latch = False
        self._queue = None             # host worker feed (lazy)
        self._worker = None
        self._plock = None
        self._host_fn = None
        self._cpu_dev = None
        # Band marks set by a ServingFleet after sorting this group's
        # streams into a narrow first-fire band (parallel/serving.py);
        # they select no program on the current device path.
        self.banded_cfg: DemodConfig | None = None
        self.use_banded = False
        # Telemetry amortization: the fleet-global psum (the step's only
        # collective) runs every telemetry_every-th block — the reference
        # polls its getters at the UI refresh interval (main.c:231-237),
        # not per buffer. Blocks in between dispatch the collective-free
        # program; self.telemetry then holds the last refresh-tick values
        # (per-stream outputs and safety flags stay per-block regardless —
        # they are sharded readbacks, not collectives).
        self.telemetry_every = telemetry_every
        self._block_idx = 0
        self._fns = {}
        self._get_fn(telemetry=True)                # eager first build
        self.carry = fleet_carry(cfg, n_streams, self.mesh, axis_name)
        self.telemetry = None
        self.stream_flags = None
        # When True (default), any stream whose block trips a safety flag is
        # re-demodulated through the exact scalar oracle from its pre-block
        # carry and its outputs/carry are spliced back — the fleet then has
        # the same always-exact contract as StreamDemodulator (the reference
        # per-sample path is always exact, demod.c:23-48).
        self.recover_flagged = recover_flagged
        self.recovered_streams = 0

    def set_sweep_rescue(self, seconds: float) -> None:
        """(Re)configure the sweep rescue (see the note above): `seconds`
        of unlocked signal before a kick; 0 disables. Also derives the
        post-kick cooldown — a full downward pass takes 2*fmax/SWEEP_STEP
        symbols, and re-kicking before it completes would reset the sweep
        forever, so counters go negative after a kick and the next one
        waits transit + budget."""
        from ..constants import SWEEP_STEP
        cfg = self.cfg
        self.sweep_rescue_s = float(seconds)
        self._rescue_blocks = (
            0 if seconds <= 0 else
            max(1, int(round(seconds * cfg.samplerate / cfg.block_len))))
        self._rescue_transit_blocks = int(
            2.0 * float(cfg.pll_fmax) / SWEEP_STEP
            * cfg.samplerate / cfg.symrate / cfg.block_len) + 1

    def _get_fn(self, telemetry: bool) -> Callable:
        if telemetry not in self._fns:
            self._fns[telemetry] = make_fleet_demod(
                self.cfg, self.mesh, self.axis_name, self._backend,
                telemetry=telemetry, chain=self.chain_blocks,
                ingest=self.ingest, packed=self.packed_output)
        return self._fns[telemetry]

    def process_blocks(self, blocks: np.ndarray):
        """blocks: (n_streams, chain_blocks*block_len) complex64 (or
        (..., 2) float32) -> per-stream BlockOutput (numpy, via egress;
        with chain_blocks=K the output rows are the K blocks'
        step-concatenation)."""
        if self.ingest == "f32":
            if np.iscomplexobj(blocks):
                blocks = iq_to_f32(blocks)
            feed_dtype = np.float32
        else:
            feed_dtype = np.int16 if self.ingest == "i16" else np.uint8
            if blocks.dtype != feed_dtype:
                raise ValueError(
                    f"ingest {self.ingest!r} expects {feed_dtype} raw "
                    f"sample pairs, got {blocks.dtype}")
        K = self.chain_blocks
        want = (self.n_streams, K * self.cfg.block_len, 2)
        if blocks.shape != want:
            raise ValueError(f"expected {want}, got {blocks.shape}")
        blocks = np.ascontiguousarray(blocks, dtype=feed_dtype)
        if self._parked:
            blocks = self._feed_parked(blocks)
        prev_carry = self.carry
        dev_blocks = (blocks if K == 1 else
                      blocks.reshape(self.n_streams, K,
                                     self.cfg.block_len, 2))
        x = shard_blocks(dev_blocks, self.mesh, self.axis_name)
        tel_tick = (self._block_idx % self.telemetry_every) == 0
        self._block_idx += 1
        fn = self._get_fn(tel_tick)
        self.carry, outs, telemetry = fn(self.carry, x)
        if tel_tick:
            (outs, self.telemetry, self.stream_flags, locked_vec,
             lonce_vec, agc_vec) = egress(
                (outs, telemetry, self.carry.flags, self.carry.locked,
                 self.carry.locked_once, self.carry.agc_gain))
            self.stream_flags = np.array(self.stream_flags)
            locked_vec = np.array(locked_vec)
            self._lonce_vec = np.array(lonce_vec)
            self._agc_vec = np.array(agc_vec)
        else:
            outs, self.stream_flags = egress((outs, self.carry.flags))
            self.stream_flags = np.array(self.stream_flags)
            locked_vec = None
        if self._parked:
            outs = self._mask_parked(outs)
        if self.recover_flagged and np.any(self.stream_flags):
            outs = self._recover(prev_carry, blocks, outs,
                                 update_telemetry=tel_tick,
                                 locked_vec=locked_vec)
        if np.any(self.stream_flags):
            self._wide_latch = True
        if tel_tick:
            self._on_tick(np.asarray(locked_vec), outs)
        return outs

    # -- straggler parking ---------------------------------------------

    def _on_tick(self, locked_vec: np.ndarray, outs) -> None:
        """Refresh-tick bookkeeping: correct fleet telemetry for parked
        lanes, update lock streak / flap counters, park qualifying
        stragglers, unpark recovered ones, clear the demotion latch."""
        parked = set(self._parked)
        active = np.array([i not in parked for i in range(self.n_streams)])
        if parked:
            # locked_streams from the per-lane readback restricted to
            # active lanes (the psum counts parked lanes' donor
            # duplicates) plus the host-side lock states of parked
            # streams.
            host_locked = sum(int(p.locked) for p in self._parked.values())
            self._active_locked = int(locked_vec[active].sum())
            self.telemetry = dict(self.telemetry)
            self.telemetry["locked_streams"] = np.int32(
                self._active_locked + host_locked)
            # locked_once likewise: parked lanes mirror the donor on the
            # device; count their HOST state instead.
            host_lonce = sum(int(p.carry["locked_once"])
                             for p in self._parked.values())
            self.telemetry["locked_once_streams"] = np.int32(
                int(self._lonce_vec[active].sum()) + host_lonce)
            # mean_agc_gain over ACTIVE device lanes plus parked HOST
            # carries (the device pmean averages donor duplicates in).
            host_agc = [float(p.carry["agc_gain"])
                        for p in self._parked.values()]
            self.telemetry["mean_agc_gain"] = np.float32(
                (float(self._agc_vec[active].sum()) + sum(host_agc))
                / self.n_streams)
            self.telemetry["flags"] = np.int32(self.stream_flags.sum())
            # symbols: parked rows were masked; their deferred symbols
            # drain via parked_output() and are not in this count.
            self.telemetry["symbols"] = np.int32(
                np.asarray(outs.valid).sum())
        else:
            # No parked lanes: the psum/recovery-derived telemetry is
            # authoritative (bit-identical to the pre-parking behavior).
            self._active_locked = int(self.telemetry["locked_streams"])
        # Lock-state streaks and flap transitions (active lanes only).
        # The flap counter resets every 50 ticks: without decay,
        # legitimate fade/relock episodes hours apart would accumulate to
        # flap_park and park a healthy stream (r5 review finding); the
        # debounce only needs to catch thrash WITHIN a window.
        self._tick_idx += 1
        if self._tick_idx % 50 == 0:
            self._flap_count[:] = 0
        if self._last_locked_vec is not None:
            self._flap_count[active] += (
                locked_vec[active] != self._last_locked_vec[active])
        self._last_locked_vec = locked_vec.copy()
        # The dwell streak counts ticks a stream stays unlocked WHILE at
        # least one peer is locked — cold-start acquisition (everyone
        # sweeping) is grace time, or streams that simply lock later than
        # the fleet's fastest would get parked mid-acquisition.
        if bool(locked_vec[active].any()):
            self._unlock_streak[active & (locked_vec == 0)] += 1
        self._unlock_streak[active & (locked_vec != 0)] = 0
        self._wide_latch = False
        if self._rescue_blocks:
            self._rescue_streak[active & (locked_vec == 0)] += 1
            self._rescue_streak[active & (locked_vec != 0)] = 0
            self._maybe_rescue(active)
        if not self.park_enabled:
            return
        self._maybe_unpark()
        self._maybe_park(locked_vec, active)

    def _maybe_rescue(self, active: np.ndarray) -> None:
        """Kick long-unlocked streams onto the downward escape sweep (see
        the sweep_rescue_s note in __init__): active device lanes get a
        host-side carry splice here; parked streams get a kick request the
        park worker applies to the host carry."""
        blocks_per_tick = self.telemetry_every * self.chain_blocks
        kick_ticks = -(-self._rescue_blocks // blocks_per_tick)
        lanes = np.nonzero(active
                           & (self._rescue_streak >= kick_ticks))[0]
        if len(lanes):
            cur = {k: np.array(v)
                   for k, v in egress(self.carry)._asdict().items()}
            cur["p_freq"][lanes] = np.float32(self.cfg.pll_fmax)
            cur["updown"][lanes] = np.float32(-1.0)
            sharding = NamedSharding(self.mesh, P(self.axis_name))
            self.carry = DemodCarry(
                **{k: jax.device_put(v, sharding) for k, v in cur.items()})
            self._rescue_streak[lanes] = -(self._rescue_transit_blocks
                                           // blocks_per_tick)
        if not self._parked:
            return
        with self._plock:
            for p in self._parked.values():
                if (not p.locked and not p.kick_wanted
                        and p.blocks_fed - p.last_kick_fed
                        >= self._rescue_blocks):
                    p.kick_wanted = True
                    p.last_kick_fed = (p.blocks_fed
                                       + self._rescue_transit_blocks)

    def _maybe_park(self, locked_vec: np.ndarray, active: np.ndarray
                    ) -> None:
        """Park streams that qualify: unlocked for park_after ticks, or
        flapping, while at least one other active stream IS locked (never
        during fleet-wide cold acquisition — everyone is acquiring)."""
        if int(locked_vec[active].sum()) == 0:
            return
        cand = [i for i in range(self.n_streams)
                if active[i]
                and (self._unlock_streak[i] >= self.park_after
                     or self._flap_count[i] >= self.flap_park)]
        room = self.park_max - len(self._parked)
        n_active = int(active.sum())
        cand = cand[:max(0, min(room, n_active - 1))]
        if not cand:
            return
        cur = {k: np.array(v)
               for k, v in egress(self.carry)._asdict().items()}
        donor = next(i for i in range(self.n_streams)
                     if active[i] and i not in cand)
        for i in cand:
            self._park_stream(i, {k: v[i].copy() for k, v in cur.items()})
            # The parked DEVICE lane mirrors the donor exactly (carry AND
            # input, _feed_parked): a free-running stale carry on donor
            # data would wander out of any tau0 band and poison a banded
            # group's min-anchor (parallel/serving.py).
            for k in cur:
                cur[k][i] = cur[k][donor]
        sharding = NamedSharding(self.mesh, P(self.axis_name))
        self.carry = DemodCarry(
            **{k: jax.device_put(v, sharding) for k, v in cur.items()})

    def _park_stream(self, i: int, carry_leaves: dict) -> None:
        self._ensure_worker()
        self._parked[i] = _ParkedStream(carry_leaves)
        self._unlock_streak[i] = 0
        self._flap_count[i] = 0

    def _maybe_unpark(self) -> None:
        """Splice back parked streams whose host demod is locked and has
        caught up with every fed block — the host carry is then the exact
        sequential state through the last processed block, so resuming the
        device lane from it is bit-continuous."""
        if not self._parked:
            return
        ready = []
        with self._plock:
            for i, p in self._parked.items():
                if p.locked:
                    p.locked_streak += 1
                else:
                    p.locked_streak = 0
                if (p.locked_streak >= self.unpark_after
                        and p.blocks_done == p.blocks_fed):
                    ready.append(i)
        if not ready:
            return
        cur = {k: np.array(v)
               for k, v in egress(self.carry)._asdict().items()}
        for i in ready:
            p = self._parked.pop(i)
            for k, v in p.carry.items():
                cur[k][i] = v
            self._unlock_streak[i] = 0
            self._flap_count[i] = 0
            # The unparked stream is locked (the unpark condition): keep
            # the active-locked count consistent for the rest of the
            # telemetry interval.
            if self._active_locked is not None:
                self._active_locked += 1
            if self._last_locked_vec is not None:
                self._last_locked_vec[i] = 1   # spliced back locked
            self._retired_rows.setdefault(i, []).extend(p.out_rows)
        sharding = NamedSharding(self.mesh, P(self.axis_name))
        self.carry = DemodCarry(
            **{k: jax.device_put(v, sharding) for k, v in cur.items()})

    def _decode_rows(self, rows: np.ndarray) -> np.ndarray:
        """Raw-ingest rows -> f32 (decode_iq's math) for host-side paths."""
        if self.ingest == "i16":
            return rows.astype(np.float32)
        if self.ingest == "u8":
            return rows.astype(np.float32) - np.float32(128.0)
        return rows

    def _feed_parked(self, blocks: np.ndarray) -> np.ndarray:
        """Queue parked streams' real blocks to the host worker and fill
        their device lanes with a donor stream's data (computed then
        discarded — static shapes keep the fleet program unchanged).
        Chained dispatch feeds the host worker its K sub-blocks
        individually (the host step is per-block)."""
        donor = next(i for i in range(self.n_streams)
                     if i not in self._parked)
        L = self.cfg.block_len
        blocks = blocks.copy()
        for i, p in self._parked.items():
            with self._plock:
                p.blocks_fed += self.chain_blocks
            for k in range(self.chain_blocks):
                self._queue.put((p, self._decode_rows(
                    blocks[i, k * L:(k + 1) * L]).copy()))
            blocks[i] = blocks[donor]
        return blocks

    def _mask_parked(self, outs):
        """Invalidate parked lanes' donor-duplicate outputs and flags."""
        outs = outs.__class__(*(np.array(v) for v in outs))
        a, b = (("sym_i", "sym_q") if self.packed_output
                else ("sym_re", "sym_im"))
        for i, p in self._parked.items():
            getattr(outs, a)[i] = 0
            getattr(outs, b)[i] = 0
            outs.valid[i] = 0
            outs.locked_once[i] = p.carry["locked_once"]
            self.stream_flags[i] = 0
        return outs

    def parked_streams(self) -> np.ndarray:
        """Indices of streams currently parked on the host side-path."""
        return np.array(sorted(self._parked), dtype=np.int64)

    def parked_output(self, i: int) -> dict:
        """Drain stream i's deferred host-demodulated output: a dict of
        concatenated sym_re/sym_im/valid/locked_once arrays (one entry per
        processed block slot, valid-gated like BlockOutput rows). Empty
        arrays if nothing new. Works while parked and after unparking."""
        rows = []
        if self._plock is not None:
            with self._plock:
                if i in self._parked:
                    rows = self._parked[i].out_rows
                    self._parked[i].out_rows = []
        rows = self._retired_rows.pop(i, []) + rows
        if not rows:
            z = np.zeros(0, np.float32)
            return dict(sym_re=z, sym_im=z,
                        valid=np.zeros(0, np.int32),
                        locked_once=np.zeros(0, np.int32))
        return {k: np.concatenate([r[k] for r in rows])
                for k in ("sym_re", "sym_im", "valid", "locked_once")}

    # -- checkpoint state (io/checkpoint.py wraps these in .npz files) --
    #
    # The serialization mirror lives HERE, next to the state it mirrors:
    # a new fleet state field is added to __init__ and to state_dict/
    # restore_state in the same edit, instead of silently dropping out of
    # a hand-copied list in another module (r5 review finding — exactly
    # how _agc_vec briefly drifted out of the mirror).

    def wait_parked_drained(self, timeout_s: float = 60.0) -> None:
        """Block until the host park worker has processed every fed
        block — parked carries are then exact through the last block."""
        import time
        if not self._parked:
            return
        deadline = time.monotonic() + timeout_s
        while True:
            with self._plock:
                if all(p.blocks_done == p.blocks_fed
                       for p in self._parked.values()):
                    return
            if time.monotonic() > deadline:
                raise TimeoutError("park worker did not drain in time")
            time.sleep(0.02)

    def state_dict(self) -> tuple[dict, dict]:
        """(json-able meta, numpy arrays) capturing this fleet exactly.
        Non-mutating: pending parked rows are copied, not drained; the
        park worker is waited on so host carries are block-exact."""
        import dataclasses
        from .serialize import pack_rows
        self.wait_parked_drained()
        arrays = {f"carry_{k}": np.asarray(v)
                  for k, v in egress(self.carry)._asdict().items()}
        arrays["unlock_streak"] = self._unlock_streak
        arrays["flap_count"] = self._flap_count
        arrays["rescue_streak"] = self._rescue_streak
        for name, v in (("last_locked_vec", self._last_locked_vec),
                        ("lonce_vec", self._lonce_vec),
                        ("agc_vec", self._agc_vec),
                        ("stream_flags", self.stream_flags)):
            if v is not None:
                arrays[name] = np.asarray(v)
        parked_meta = {}
        if self._parked:
            with self._plock:
                for i, p in self._parked.items():
                    parked_meta[str(i)] = dict(
                        locked=bool(p.locked),
                        locked_streak=int(p.locked_streak),
                        blocks_fed=int(p.blocks_fed),
                        blocks_done=int(p.blocks_done),
                        kick_wanted=bool(p.kick_wanted),
                        last_kick_fed=int(p.last_kick_fed))
                    for k, v in p.carry.items():
                        arrays[f"parked_{i}_carry_{k}"] = np.asarray(v)
                    pack_rows(list(p.out_rows), arrays,
                              f"parked_{i}_rows_")
        for i, rows in self._retired_rows.items():
            pack_rows(list(rows), arrays, f"retired_{i}_rows_")
        meta = dict(
            cfg=dataclasses.asdict(self.cfg),
            n_streams=self.n_streams,
            axis_name=self.axis_name,
            backend=self._backend,
            recover_flagged=self.recover_flagged,
            telemetry_every=self.telemetry_every,
            park=self.park_enabled, park_after=self.park_after,
            unpark_after=self.unpark_after, park_max=self.park_max,
            flap_park=self.flap_park,
            sweep_rescue_s=self.sweep_rescue_s,
            chain_blocks=self.chain_blocks,
            ingest=self.ingest,
            packed_output=self.packed_output,
            tick_idx=self._tick_idx, block_idx=self._block_idx,
            active_locked=(None if self._active_locked is None
                           else int(self._active_locked)),
            wide_latch=bool(self._wide_latch),
            use_banded=bool(self.use_banded),
            banded_cfg=(dataclasses.asdict(self.banded_cfg)
                        if self.banded_cfg is not None else None),
            recovered_streams=int(self.recovered_streams),
            telemetry=(None if self.telemetry is None else
                       {k: float(v) for k, v in self.telemetry.items()}),
            parked=parked_meta,
            retired=sorted(int(i) for i in self._retired_rows))
        return meta, arrays

    def restore_state(self, meta: dict, z, prefix: str = "") -> None:
        """Overwrite this fleet's state from a state_dict capture (`z` is
        any mapping of the arrays with key list `z.files`, e.g. an open
        npz). The fleet must have been constructed with the same cfg,
        n_streams, and mesh size; policy parameters are re-applied from
        meta so a default-constructed fleet becomes exact."""
        from .serialize import unpack_rows
        p = prefix
        self._backend = meta["backend"]
        self.recover_flagged = meta["recover_flagged"]
        self.telemetry_every = meta["telemetry_every"]
        self.park_enabled = meta["park"]
        self.park_after = meta["park_after"]
        self.unpark_after = meta["unpark_after"]
        self.park_max = meta["park_max"]
        self.flap_park = meta["flap_park"]
        new_chain = int(meta.get("chain_blocks", 1))
        new_ingest = meta.get("ingest", "f32")
        new_packed = bool(meta.get("packed_output", False))
        if (new_chain != self.chain_blocks or new_ingest != self.ingest
                or new_packed != self.packed_output):
            # Structural: the chained/raw-ingest/packed program differs,
            # so the eagerly built fn cache is the wrong shape.
            self.chain_blocks = new_chain
            self.ingest = new_ingest
            self.packed_output = new_packed
            self._fns = {}
        if "sweep_rescue_s" in meta:
            self.set_sweep_rescue(float(meta["sweep_rescue_s"]))
        sharding = NamedSharding(self.mesh, P(self.axis_name))
        self.carry = DemodCarry(**{
            k[len(p) + len("carry_"):]:
                jax.device_put(np.asarray(z[k]), sharding)
            for k in z.files
            if k.startswith(f"{p}carry_")})
        self._unlock_streak = np.asarray(z[f"{p}unlock_streak"]).copy()
        self._flap_count = np.asarray(z[f"{p}flap_count"]).copy()
        if f"{p}rescue_streak" in z.files:
            self._rescue_streak = np.asarray(
                z[f"{p}rescue_streak"]).copy()
        for name, attr in (("last_locked_vec", "_last_locked_vec"),
                           ("lonce_vec", "_lonce_vec"),
                           ("agc_vec", "_agc_vec"),
                           ("stream_flags", "stream_flags")):
            if f"{p}{name}" in z.files:
                setattr(self, attr, np.asarray(z[f"{p}{name}"]).copy())
        if meta["telemetry"] is not None:
            self.telemetry = {
                k: (np.float32(v) if k == "mean_agc_gain"
                    else np.int32(v))
                for k, v in meta["telemetry"].items()}
        self._tick_idx = int(meta["tick_idx"])
        self._block_idx = int(meta["block_idx"])
        self._active_locked = meta["active_locked"]
        self._wide_latch = bool(meta["wide_latch"])
        self.use_banded = bool(meta["use_banded"])
        if meta["banded_cfg"] is not None:
            self.banded_cfg = DemodConfig(**meta["banded_cfg"])
        self.recovered_streams = int(meta["recovered_streams"])
        for i_s, pm in meta["parked"].items():
            i = int(i_s)
            leaves = {
                k[len(f"{p}parked_{i}_carry_"):]: np.asarray(z[k]).copy()
                for k in z.files
                if k.startswith(f"{p}parked_{i}_carry_")}
            self._ensure_worker()
            ps = _ParkedStream(leaves)
            ps.locked = bool(pm["locked"])
            ps.locked_streak = int(pm["locked_streak"])
            ps.blocks_fed = int(pm["blocks_fed"])
            ps.blocks_done = int(pm["blocks_done"])
            ps.kick_wanted = bool(pm.get("kick_wanted", False))
            ps.last_kick_fed = int(pm.get("last_kick_fed", 0))
            ps.out_rows = unpack_rows(z, f"{p}parked_{i}_rows_")
            self._parked[i] = ps
        for i in meta["retired"]:
            rows = unpack_rows(z, f"{p}retired_{i}_rows_")
            if rows:
                self._retired_rows[int(i)] = rows

    def _ensure_worker(self) -> None:
        if self._worker is not None:
            return
        import queue
        import threading
        self._plock = threading.Lock()
        self._queue = queue.Queue()
        try:
            self._cpu_dev = jax.devices("cpu")[0]
        except RuntimeError:
            self._cpu_dev = None    # oracle fallback (exact, host numpy)
        if self._cpu_dev is not None:
            from ..demod.backend import jit_batch_demod
            self._host_fn = jit_batch_demod(self.cfg, 1, "scan")
        self._worker = threading.Thread(
            target=self._park_worker, daemon=True)
        self._worker.start()

    def _park_worker(self) -> None:
        """Host worker: exact single-stream demod of parked streams'
        blocks, OFF the device hot path. Uses the scan step pinned to the
        CPU backend when one exists (it never queues work behind the
        fleet's device programs), else the numpy scalar oracle (the
        executable spec; slower but exact)."""
        import contextlib
        while True:
            item = self._queue.get()
            if item is None:
                return
            p, block = item
            with self._plock:
                if p.kick_wanted:        # sweep rescue (_maybe_rescue)
                    # Recheck the lock: a block queued before the kick
                    # request may have locked the host demod — kicking
                    # now would destroy the just-acquired lock.
                    if not p.locked:
                        p.carry = dict(p.carry,
                                       p_freq=np.float32(self.cfg.pll_fmax),
                                       updown=np.float32(-1.0))
                    p.kick_wanted = False
            try:
                if self._host_fn is not None:
                    ctx = jax.default_device(self._cpu_dev)
                else:
                    ctx = contextlib.nullcontext()
                with ctx:
                    row, leaves = self._host_step(p.carry, block)
            except Exception:               # record and keep draining
                import traceback
                traceback.print_exc()
                row, leaves = None, None
            with self._plock:
                if leaves is not None:
                    p.carry = leaves
                    p.out_rows.append(row)
                    p.locked = bool(int(leaves["locked"]))
                p.blocks_done += 1
            self._queue.task_done()

    def _host_step(self, leaves: dict, block: np.ndarray):
        """One exact block step from unbatched numpy carry leaves."""
        if self._host_fn is not None:
            carry = DemodCarry(**{k: np.asarray(v)[None]
                                  for k, v in leaves.items()})
            carry, outs = self._host_fn(carry, block[None])
            leaves = {k: np.asarray(v)[0]
                      for k, v in carry._asdict().items()}
            row = dict(
                sym_re=np.asarray(outs.sym_re, np.float32)[0],
                sym_im=np.asarray(outs.sym_im, np.float32)[0],
                valid=np.asarray(outs.valid, np.int32)[0],
                locked_once=np.asarray(outs.locked_once, np.int32)[0])
            return row, leaves
        # Oracle fallback: the scalar spec, one block at a time (exactly
        # the _recover path's conversion round-trip).
        from ..demod import scalar
        from ..demod.pipeline import (numpy_carry_to_scalar_state,
                                      scalar_state_to_numpy_carry)
        from ..dsp.fir import f32_to_iq
        st = numpy_carry_to_scalar_state(self.cfg, leaves)
        sym, st = scalar.demod_stream_np(self.cfg, f32_to_iq(block), st)
        new = dict(leaves)
        for k, v in scalar_state_to_numpy_carry(self.cfg, st).items():
            new[k] = np.asarray(v)
        n = len(sym)
        S = self.cfg.steps_per_block + (1 if self.cfg.oqpsk else 0)
        row = dict(sym_re=np.zeros(S, np.float32),
                   sym_im=np.zeros(S, np.float32),
                   valid=np.zeros(S, np.int32),
                   locked_once=np.full(S, int(st["locked_once"]), np.int32))
        row["sym_re"][:n] = sym["re"]
        row["sym_im"][:n] = sym["im"]
        row["valid"][:n] = 1
        row["locked_once"][:n] = sym["locked_once"]
        return row, new

    def _recover(self, prev_carry: DemodCarry, blocks: np.ndarray, outs,
                 update_telemetry: bool = True, locked_vec=None):
        """Re-demodulate every flagged stream's block with the exact scalar
        oracle (from the pre-block carry), splice the corrected symbols into
        `outs` (left-justified in the step slots — chronological order, which
        is all BlockOutput consumers rely on), and write the corrected carry
        back to the device mesh. Flags are cleared: a nonzero stream_flags
        entry always refers to the block just processed."""
        from ..demod import scalar
        from ..demod.pipeline import (numpy_carry_to_scalar_state,
                                      scalar_state_to_numpy_carry)
        from ..dsp.fir import f32_to_iq

        flagged = np.nonzero(np.asarray(self.stream_flags))[0]
        if self.ingest != "f32" and len(flagged):
            blocks = self._decode_rows(blocks)     # oracle needs f32
        prev_np = egress(prev_carry)._asdict()
        cur = {k: np.array(v) for k, v in egress(self.carry)._asdict().items()}
        outs = outs.__class__(*(np.array(v) for v in outs))
        a, b = (("sym_i", "sym_q") if self.packed_output
                else ("sym_re", "sym_im"))
        S = getattr(outs, a).shape[1]
        for i in flagged:
            st = numpy_carry_to_scalar_state(
                self.cfg, {k: v[i] for k, v in prev_np.items()})
            sym, st = scalar.demod_stream_np(
                self.cfg, f32_to_iq(blocks[i]), st)
            n = len(sym)
            if n > S:
                raise RuntimeError(
                    f"stream {i}: oracle produced {n} symbols > {S} slots")
            for k, v in scalar_state_to_numpy_carry(self.cfg, st).items():
                cur[k][i] = v
            re, im = sym["re"], sym["im"]
            if self.packed_output:
                # Host-side quantization with the device's exact math.
                re = np.trunc(np.clip(re * np.float32(0.5), -127.0, 127.0))
                im = np.trunc(np.clip(im * np.float32(0.5), -127.0, 127.0))
            getattr(outs, a)[i] = 0
            getattr(outs, b)[i] = 0
            outs.valid[i] = 0
            getattr(outs, a)[i, :n] = re
            getattr(outs, b)[i, :n] = im
            outs.valid[i, :n] = 1
            outs.locked_once[i, :n] = sym["locked_once"]
            outs.locked_once[i, n:] = st["locked_once"]
        self.recovered_streams += len(flagged)
        if locked_vec is not None:
            # Patch the tick's per-lane lock readback with the corrected
            # states so _on_tick's streak/park bookkeeping sees them.
            for i in flagged:
                locked_vec[i] = cur["locked"][i]

        sharding = NamedSharding(self.mesh, P(self.axis_name))
        self.carry = DemodCarry(
            **{k: jax.device_put(v, sharding) for k, v in cur.items()})
        if not update_telemetry:
            # Between refresh ticks self.telemetry keeps the last tick's
            # values (the recovery corrected the carry, so the next tick's
            # psum reflects the spliced state).
            return outs
        # Re-derive the fleet telemetry from the corrected host state (the
        # psum values were computed before the splice).
        self.telemetry = {
            "locked_streams": np.int32(cur["locked"].sum()),
            "locked_once_streams": np.int32(cur["locked_once"].sum()),
            "symbols": np.int32(outs.valid.sum()),
            "mean_agc_gain": np.float32(cur["agc_gain"].mean()),
            "flags": np.int32(0),
        }
        return outs

    def flagged_streams(self) -> np.ndarray:
        """Indices of streams that tripped a safety flag in the last block.

        With recover_flagged (the default) these streams have already been
        re-demodulated exactly and their carry/output corrected — the indices
        are reported for observability. With recover_flagged=False the flags
        are sticky and the stream's fast-path output is suspect from the
        flagged block onward."""
        if self.stream_flags is None:
            return np.zeros(0, dtype=np.int64)
        return np.nonzero(np.asarray(self.stream_flags))[0]
