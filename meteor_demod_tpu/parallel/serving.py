"""ServingFleet: multi-group fleet serving with tau0-sorted groups.

A card serves fleets larger than one dispatch group, so a production fleet
is many FleetDemodulator groups dispatched round-robin.

At the moment the fleet goes carrier-locked, this host SORTS streams by
their predicted first-fire tick and renumbers them into dispatch groups,
so each group spans a narrow tau0 band (`use_banded` marks groups whose
spread fits `band`). The recurrence on the current device path reads each
fire directly (demod/backend.py has no candidate window to narrow), so the
band selects no program: the sort and its flags are policy state only.

Stream identity is preserved: inputs are routed group-wise through a
host-side assignment and outputs return in the caller's original stream
order. Parked streams (FleetDemodulator's straggler policy) keep their
lanes across re-sorts — only live streams are renumbered.

Reference scope note: the reference is one process per stream
(main.c:284-329); fleet serving and this grouping policy are additions
with no reference counterpart.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..config import DemodConfig
from ..demod.pipeline import egress
from ..demod.state import DemodCarry
from .mesh import FleetDemodulator, make_mesh


def predict_tau0(cfg: DemodConfig, t_phase: np.ndarray,
                 t_freq: np.ndarray) -> np.ndarray:
    """Predicted first-fire tick of the next block per stream — the scan
    gate's closed form (demod/scan.py: fire at the smallest k with
    k*t_freq >= 2*pi - t_phase; QPSK threshold)."""
    diff = np.float32(2.0 * np.pi) - np.asarray(t_phase, np.float32)
    tau0 = np.ceil(diff / np.asarray(t_freq, np.float32))
    return np.maximum(tau0, 1.0).astype(np.int64)


class ServingFleet:
    """n_streams = n_groups x group_size, each group a FleetDemodulator
    dispatched per block; streams are renumbered across groups at the
    locked switch to form tau0 bands."""

    def __init__(self, cfg: DemodConfig, n_streams: int,
                 group_size: int = 128, band: int = 8,
                 mesh=None, axis_name: str = "streams", **fleet_kw):
        cfg.validate()
        if n_streams % group_size != 0:
            raise ValueError(
                f"n_streams {n_streams} not divisible by group {group_size}")
        self.cfg = cfg
        self.band = int(band)
        self.group_size = group_size
        self.n_streams = n_streams
        self.n_groups = n_streams // group_size
        self.mesh = mesh if mesh is not None else make_mesh(
            axis_name=axis_name)
        # Banding is QPSK-geometry only (config.validate); OQPSK fleets
        # keep sorting disabled.
        self.banding_possible = not cfg.oqpsk
        banded_cfg = (dataclasses.replace(cfg, tau0_band=self.band)
                      if self.banding_possible else None)
        self.groups = []
        for g in range(self.n_groups):
            f = FleetDemodulator(cfg, group_size, mesh=self.mesh,
                                 axis_name=axis_name, **fleet_kw)
            f.banded_cfg = banded_cfg
            self.groups.append(f)
        # assign[stream] = (group, lane); inverse kept as flat arrays.
        self._group_of = np.repeat(np.arange(self.n_groups), group_size)
        self._lane_of = np.tile(np.arange(group_size), self.n_groups)
        self.sorted_once = False
        self._resort_wanted = False
        # Deferred host-path symbols of parked streams, keyed by STREAM
        # (drained out of the lane-keyed group stores before any
        # renumbering so a re-sort cannot orphan them).
        self._deferred: dict[int, list] = {}

    # -- routing --------------------------------------------------------

    def _slots(self) -> np.ndarray:
        """Flat slot index (group*group_size + lane) per caller stream."""
        return self._group_of * self.group_size + self._lane_of

    def _scatter_in(self, blocks: np.ndarray, slots: np.ndarray):
        """(n_streams, ...) caller order -> per-group arrays."""
        flat = np.empty_like(blocks)
        flat[slots] = blocks
        return [flat[g * self.group_size:(g + 1) * self.group_size]
                for g in range(self.n_groups)]

    def process_blocks(self, blocks: np.ndarray):
        """One block per stream (caller order) -> per-stream BlockOutput
        leaves stacked back into caller order."""
        if blocks.shape[0] != self.n_streams:
            raise ValueError(
                f"expected {self.n_streams} streams, got {blocks.shape[0]}")
        # The assignment THIS block was dispatched under: _after_block may
        # re-sort (changing the assignment for the NEXT block), so both
        # scatter and gather use the snapshot.
        slots = self._slots()
        per_group = self._scatter_in(np.asarray(blocks), slots)
        outs = [self.groups[g].process_blocks(per_group[g])
                for g in range(self.n_groups)]
        self._after_block()
        # Gather back to caller order.
        first = outs[0]
        fields = {}
        for name in first._fields:
            cat = np.concatenate([np.asarray(getattr(o, name))
                                  for o in outs])
            fields[name] = cat[slots]
        return first.__class__(**fields)

    # -- policy ---------------------------------------------------------

    def _after_block(self) -> None:
        if not self.banding_possible:
            return
        all_locked = all(
            f.telemetry is not None and f._active_locked is not None
            and f._active_locked == f.n_streams - len(f._parked)
            and int(f.telemetry["flags"]) == 0 for f in self.groups)
        if all_locked and (not self.sorted_once or self._resort_wanted):
            self._sort_groups()
        # A banded group that starts flagging has streams drifting out of
        # band: clear its band mark and ask for a re-sort.
        for f in self.groups:
            if f.use_banded and np.any(np.asarray(f.stream_flags)):
                f.use_banded = False
                self._resort_wanted = True

    def parked_output(self, stream: int) -> dict:
        """Drain the deferred host-demodulated symbols of `stream` (see
        FleetDemodulator.parked_output) in caller stream identity —
        robust across re-sorts (rows are pulled out of the lane-keyed
        group stores before any renumbering)."""
        g, lane = int(self._group_of[stream]), int(self._lane_of[stream])
        rows = self._deferred.pop(stream, [])
        got = self.groups[g].parked_output(lane)
        if len(got["valid"]):
            rows.append(got)
        if not rows:
            return got
        return {k: np.concatenate([r[k] for r in rows])
                for k in ("sym_re", "sym_im", "valid", "locked_once")}

    def _drain_parked_rows(self) -> None:
        """Move every pending parked/retired row into the stream-keyed
        deferred store (called before renumbering)."""
        for g, f in enumerate(self.groups):
            lanes = set(f._parked) | set(f._retired_rows)
            for lane in lanes:
                rows = f.parked_output(lane)
                if not len(rows["valid"]):
                    continue
                mask = (self._group_of == g) & (self._lane_of == lane)
                stream = int(np.nonzero(mask)[0][0])
                self._deferred.setdefault(stream, []).append(rows)

    def _sort_groups(self) -> None:
        """Renumber live streams across groups by predicted tau0; enable
        the banded program for groups whose achieved spread fits the
        band. Host-side; runs at the locked switch (and on re-sort
        requests), not per block."""
        self._drain_parked_rows()
        carries = [egress(f.carry)._asdict() for f in self.groups]
        leaves = {k: np.concatenate(
            [np.asarray(carries[g][k])[:] for g in range(self.n_groups)])
            for k in carries[0]}
        # Global index of (group, lane) slot s = g*group_size + lane.
        slot_of_stream = (self._group_of * self.group_size + self._lane_of)
        # tau0 per SLOT, then per stream.
        tau0_slot = predict_tau0(self.cfg, leaves["t_phase"],
                                 leaves["t_freq"])
        parked_slots = set()
        for g, f in enumerate(self.groups):
            for lane in f._parked:
                parked_slots.add(g * self.group_size + lane)
        live = [s for s in range(self.n_streams)
                if slot_of_stream[s] not in parked_slots]
        live_slots = sorted(set(range(self.n_streams)) - parked_slots)
        # Sort live streams by tau0 of their CURRENT slot and deal them
        # into the free slots in order.
        order = sorted(live, key=lambda s: int(tau0_slot[slot_of_stream[s]]))
        new_slot = dict(zip(order, live_slots))
        perm = np.arange(self.n_streams)          # new slot <- old slot
        for s, ns in new_slot.items():
            perm[ns] = slot_of_stream[s]
        # Rewrite assignments.
        for s, ns in new_slot.items():
            self._group_of[s] = ns // self.group_size
            self._lane_of[s] = ns % self.group_size
        # Rewrite carries group-wise from the permuted global pool (the
        # permutation applied once per leaf, then sliced per group).
        permuted = {k: v[perm] for k, v in leaves.items()}
        tau0_new = tau0_slot[perm]
        parked_new = np.zeros(self.n_streams, bool)
        for ps in parked_slots:
            parked_new[ps] = True          # parked slots keep their place
        sharding = NamedSharding(self.mesh, P(self.groups[0].axis_name))
        for g, f in enumerate(self.groups):
            sl = slice(g * self.group_size, (g + 1) * self.group_size)
            # Re-mirror parked lanes onto the group's donor (the first
            # live lane — the same rule mesh._feed_parked uses for their
            # input): after the renumbering the donor's slot holds a
            # different stream, and a parked carry left evolving from the
            # OLD mirror point on NEW donor data can drift out of band.
            live_idx = np.nonzero(~parked_new[sl])[0]
            parked_idx = np.nonzero(parked_new[sl])[0]
            group_leaves = {k: np.ascontiguousarray(v[sl])
                            for k, v in permuted.items()}
            if len(parked_idx) and len(live_idx):
                for k in group_leaves:
                    group_leaves[k][parked_idx] = group_leaves[k][
                        live_idx[0]]
            f.carry = DemodCarry(**{
                k: jax.device_put(v, sharding)
                for k, v in group_leaves.items()})
            # Band check over LIVE slots only: a parked lane's device
            # carry mirrors its donor (in-band by construction,
            # mesh._maybe_park), but exclude it anyway so a straggler can
            # never veto its group's banding.
            live_g = ~parked_new[sl]
            spread_v = tau0_new[sl][live_g]
            spread = (int(spread_v.max() - spread_v.min())
                      if spread_v.size else 0)
            f.use_banded = spread <= max(0, self.band - 1)
            # Lane-keyed policy counters now describe different streams;
            # everyone live is locked at sort time, so reset them.
            f._unlock_streak[:] = 0
            f._flap_count[:] = 0
            f._last_locked_vec = None
        self.sorted_once = True
        self._resort_wanted = False

    # -- observability --------------------------------------------------

    def banded_groups(self) -> list[int]:
        return [g for g, f in enumerate(self.groups) if f.use_banded]

    def assignment(self) -> list[tuple[int, int]]:
        """(group, lane) per stream in caller order."""
        return [(int(self._group_of[s]), int(self._lane_of[s]))
                for s in range(self.n_streams)]
