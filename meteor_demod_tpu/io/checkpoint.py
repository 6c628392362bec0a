"""Checkpoint / resume: serialize the demodulator state mid-stream.

The reference has no checkpointing (SURVEY.md section 5) — its closest
analogue is the partial-ring flush at EOF (main.c:321-322). Here the
scan carry (FIR delay-line tail, PLL phase/freq/err/locked,
timing phase/freq/prev, AGC gain/bias, OQPSK inphase/slot) IS a complete,
exact checkpoint: demodulation resumed from a saved carry is sample-for-sample
identical to an uninterrupted run. This module serializes that carry (plus
the sub-block pending buffer and host-side counters) to a single .npz file.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from ..config import DemodConfig
from ..demod.pipeline import StreamDemodulator
from ..demod.state import DemodCarry

_FORMAT_VERSION = 1


def _savez(path: str, **arrays) -> None:
    """np.savez to the EXACT path given: np.savez(str) silently appends
    .npz to names lacking the suffix (so save('ck.0') would write
    'ck.0.npz' and the matching load would FileNotFoundError); writing
    through an open handle keeps save/load paths symmetric for the
    per-process multihost naming this module recommends."""
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def save_checkpoint(path: str, demod: StreamDemodulator) -> None:
    """Serialize a StreamDemodulator's complete state to `path` (.npz).

    Drains the dispatch pipeline first (demod.sync()) so the carry is
    flag-verified and the in-flight blocks' symbols are not lost — they are
    returned by the next process()/finish() call."""
    from ..demod.pipeline import egress, _SYM_DTYPE
    demod.sync()
    carry = {f"carry_{k}": np.asarray(v)
             for k, v in egress(demod._carry)._asdict().items()}
    backlog = (np.concatenate(demod._backlog) if demod._backlog
               else np.zeros(0, dtype=_SYM_DTYPE))
    meta = dict(version=_FORMAT_VERSION,
                cfg=dataclasses.asdict(demod.cfg),
                symbols_out=demod.symbols_out,
                fallback_blocks=demod.fallback_blocks)
    _savez(path,
           meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
           pending=demod._pending,
           backlog_re=backlog["re"], backlog_im=backlog["im"],
           backlog_lo=backlog["locked_once"],
           **carry)


def _fleet_ctor_kw(meta: dict) -> dict:
    """Constructor kwargs for a FleetDemodulator matching a state_dict
    capture (restore_state re-applies the policy params afterwards)."""
    return dict(axis_name=meta["axis_name"], backend=meta["backend"],
                recover_flagged=meta["recover_flagged"],
                telemetry_every=meta["telemetry_every"],
                park=meta["park"], park_after=meta["park_after"],
                unpark_after=meta["unpark_after"],
                park_max=meta["park_max"], flap_park=meta["flap_park"],
                sweep_rescue_s=meta.get("sweep_rescue_s", 0.0),
                chain_blocks=meta.get("chain_blocks", 1),
                ingest=meta.get("ingest", "f32"),
                packed_output=meta.get("packed_output", False))


def save_fleet_checkpoint(path: str, fleet) -> None:
    """Serialize a FleetDemodulator (device carry + all host-side policy
    and parking state, via FleetDemodulator.state_dict — the mirror lives
    next to the state it serializes) to `path` (.npz). The park worker is
    drained first so parked host carries are exact through the last fed
    block; pending deferred symbol rows are saved, not dropped. Resuming
    from the file is bit-identical to continuing the original (tested)."""
    meta, arrays = fleet.state_dict()
    meta = dict(version=_FORMAT_VERSION, kind="fleet", fleet=meta)
    _savez(path,
           meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
           **arrays)


def load_fleet_checkpoint(path: str, mesh=None):
    """Reconstruct a FleetDemodulator exactly as saved. `mesh` must have
    the same size as at save time (default: a fresh all-device mesh)."""
    from ..parallel.mesh import FleetDemodulator
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        if meta["version"] != _FORMAT_VERSION or meta.get("kind") != "fleet":
            raise ValueError("not a fleet checkpoint")
        fm = meta["fleet"]
        fleet = FleetDemodulator(DemodConfig(**fm["cfg"]),
                                 fm["n_streams"], mesh=mesh,
                                 **_fleet_ctor_kw(fm))
        fleet.restore_state(fm, z)
        return fleet


def save_serving_checkpoint(path: str, serving) -> None:
    """Serialize a ServingFleet: every group's fleet state plus the
    stream->(group,lane) assignment, per-group banding (inside each
    group's state_dict), and the stream-keyed deferred rows."""
    from ..parallel.serialize import pack_rows
    arrays = {}
    groups_meta = []
    for g, f in enumerate(serving.groups):
        gm, ga = f.state_dict()
        groups_meta.append(gm)
        for k, v in ga.items():
            arrays[f"g{g}_{k}"] = v
    arrays["group_of"] = serving._group_of
    arrays["lane_of"] = serving._lane_of
    for s, rows in serving._deferred.items():
        pack_rows(list(rows), arrays, f"deferred_{s}_rows_")
    meta = dict(version=_FORMAT_VERSION, kind="serving",
                cfg=dataclasses.asdict(serving.cfg),
                n_streams=serving.n_streams,
                group_size=serving.group_size, band=serving.band,
                sorted_once=bool(serving.sorted_once),
                resort_wanted=bool(serving._resort_wanted),
                deferred=sorted(int(s) for s in serving._deferred),
                groups=groups_meta)
    _savez(path,
           meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
           **arrays)


def load_serving_checkpoint(path: str, mesh=None):
    """Reconstruct a ServingFleet exactly as saved. Group state is
    restored INTO the constructor-built FleetDemodulators (one
    construction and one carry upload per group, not two)."""
    from ..parallel.serving import ServingFleet
    from ..parallel.serialize import unpack_rows
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        if (meta["version"] != _FORMAT_VERSION
                or meta.get("kind") != "serving"):
            raise ValueError("not a serving checkpoint")
        cfg = DemodConfig(**meta["cfg"])
        fleet_kw = (_fleet_ctor_kw(meta["groups"][0])
                    if meta["groups"] else {})
        fleet_kw.pop("axis_name", None)
        serving = ServingFleet(cfg, meta["n_streams"],
                               group_size=meta["group_size"],
                               band=meta["band"], mesh=mesh, **fleet_kw)
        for g, gm in enumerate(meta["groups"]):
            serving.groups[g].restore_state(gm, z, prefix=f"g{g}_")
        serving._group_of = np.asarray(z["group_of"]).copy()
        serving._lane_of = np.asarray(z["lane_of"]).copy()
        serving.sorted_once = bool(meta["sorted_once"])
        serving._resort_wanted = bool(meta["resort_wanted"])
        for s in meta["deferred"]:
            rows = unpack_rows(z, f"deferred_{s}_rows_")
            if rows:
                serving._deferred[int(s)] = rows
    return serving


def save_multihost_checkpoint(path: str, fleet) -> None:
    """Serialize THIS PROCESS's view of a MultiHostFleet (its local carry
    rows + replicated counters). In a multi-host job every process calls
    this with its own path (e.g. suffixed with jax.process_index())."""
    meta, arrays = fleet.state_dict()
    meta = dict(version=_FORMAT_VERSION, kind="multihost", fleet=meta)
    _savez(path,
           meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
           **arrays)


def load_multihost_checkpoint(path: str):
    """Reconstruct this process's MultiHostFleet from its own file; must
    run collectively in a job with the save-time topology."""
    from ..parallel.multihost import MultiHostFleet
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        if (meta["version"] != _FORMAT_VERSION
                or meta.get("kind") != "multihost"):
            raise ValueError("not a multihost checkpoint")
        fm = meta["fleet"]
        fleet = MultiHostFleet(DemodConfig(**fm["cfg"]),
                               fm["streams_per_device"],
                               backend=fm.get("backend", "auto"),
                               axis_name=fm["axis_name"],
                               recover_flagged=fm["recover_flagged"],
                               telemetry_every=fm["telemetry_every"])
        fleet.restore_state(fm, z)
        return fleet


def load_checkpoint(path: str) -> StreamDemodulator:
    """Reconstruct a StreamDemodulator exactly as saved."""
    import jax.numpy as jnp

    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        if meta["version"] != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {meta['version']}")
        if "kind" in meta:
            raise ValueError(
                f"{meta['kind']} checkpoint; use load_{meta['kind']}"
                "_checkpoint, not the single-stream loader")
        cfg = DemodConfig(**meta["cfg"])
        d = StreamDemodulator(cfg)
        leaves = {k[len("carry_"):]: jnp.asarray(z[k])
                  for k in z.files if k.startswith("carry_")}
        d._carry = DemodCarry(**leaves)
        d._pending = np.asarray(z["pending"], dtype=np.complex64)
        if "backlog_re" in z.files and len(z["backlog_re"]):
            from ..demod.pipeline import _SYM_DTYPE
            backlog = np.zeros(len(z["backlog_re"]), dtype=_SYM_DTYPE)
            backlog["re"] = z["backlog_re"]
            backlog["im"] = z["backlog_im"]
            backlog["locked_once"] = z["backlog_lo"]
            d._backlog = [backlog]
        d.symbols_out = int(meta["symbols_out"])
        d.fallback_blocks = int(meta["fallback_blocks"])
        d._publish_telemetry()
    return d
