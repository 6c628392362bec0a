"""Production serving host: many LRPT streams on one card, restartable.

The reference serves one stream per process (main.c:284-329); the fleet
replaces N such processes with one ServingFleet (dispatch groups,
straggler parking) — see parallel/serving.py and PERF.md. This script is
the operational glue a deployment needs around it:

- N inputs (2-channel WAV files and/or synthesized passes) demodulated
  concurrently, one lock-gated .s writer per stream (the reference's ring
  semantics, io/writer.py);
- parked stragglers' host-path symbols drained back into each stream's
  writer in order (device rows are masked while parked, so per-stream
  symbol order is preserved);
- periodic + signal-triggered checkpointing (save_serving_checkpoint) and
  --resume, which seeks every input to the checkpoint's block index —
  demodulation continues bit-identically (tests/test_fleet_checkpoint.py
  pins the resume contract). Writer ring state rides in a side
  <checkpoint>.writers.npz and the .s files are truncated back to the
  checkpointed byte counts on resume, so the restarted host's byte
  stream is EXACTLY the uninterrupted one (validated; requires stable
  park membership — a stream that transiently parks takes host-program
  symbols for the parked span, whose int8 values sit within the
  cross-program loop noise of the -T contract and whose park timing is
  wall-clock dependent. --park-after-s defaults generous so only
  genuinely dead streams park).

Synthesized passes carry LEO Doppler (sim.leo_doppler_hz), each stream at
its own point of the pass.

Smoke run (CPU):
    JAX_PLATFORMS=cpu python scripts/serve_fleet.py \
        --synth 16 --dead 1 --seconds 2 --group-size 8 \
        --out-dir /tmp/fleet_out --checkpoint /tmp/fleet.ckpt.npz
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from meteor_demod_tpu.config import DemodConfig                 # noqa: E402
from meteor_demod_tpu.io.checkpoint import (                    # noqa: E402
    load_serving_checkpoint, save_serving_checkpoint)
from meteor_demod_tpu.io.wav import decode_iq, open_input       # noqa: E402
from meteor_demod_tpu.io.writer import SymbolWriter             # noqa: E402
from meteor_demod_tpu.demod.pipeline import quantize_symbols    # noqa: E402
from meteor_demod_tpu.parallel.serving import ServingFleet      # noqa: E402
from meteor_demod_tpu.sim import leo_doppler_hz, synth_psk      # noqa: E402
from meteor_demod_tpu.utils import enable_compile_cache         # noqa: E402


class _FileSource:
    """Block-aligned reads from a 2-channel WAV (sniffed) or raw IQ
    (8/16/32-bit via --bps) — io/wav.open_input, the CLI's exact ingest
    sniffing; zeros after EOF."""

    def __init__(self, path: str, block_len: int, samplerate: int,
                 raw_bps: int):
        self.f, info, _ = open_input(path)
        if info is not None and info.samplerate != samplerate:
            raise SystemExit(
                f"{path}: samplerate {info.samplerate} != {samplerate}")
        self.bps = info.bps if info is not None else raw_bps
        self.data_start = self.f.tell()    # after the sniffed header
        self.size = os.path.getsize(path)
        self.block_bytes = block_len * 2 * (self.bps // 8)
        self.block_len = block_len
        self.done = False
        # Raw-ingest mode (set by main() when every source shares the
        # fleet's integer format): next_block returns the file's raw
        # (L, 2) integer sample pairs, decoded ON DEVICE — 2x/4x less
        # host->device traffic.
        self.raw_dtype = None
        self.raw_pad = 0

    def seek_blocks(self, n: int) -> None:
        pos = self.data_start + n * self.block_bytes
        # A seek at/past the data end means no real sample remains: mark
        # done so a resumed run cannot emit a post-EOF zero chain the
        # uninterrupted run never wrote.
        self.done = pos >= self.size
        self.f.seek(pos)

    def _empty(self) -> np.ndarray:
        if self.raw_dtype is not None:
            return np.full((self.block_len, 2), self.raw_pad,
                           self.raw_dtype)
        return np.zeros(self.block_len, np.complex64)

    def _decode(self, raw: bytes) -> np.ndarray:
        if self.raw_dtype is not None:
            return np.frombuffer(raw, self.raw_dtype).reshape(-1, 2)
        return decode_iq(raw, self.bps)

    def next_block(self) -> np.ndarray:
        if self.done:
            return self._empty()
        raw = self.f.read(self.block_bytes)
        if len(raw) < self.block_bytes:
            # Pad the partial tail instead of dropping it (with --chain
            # the feed is K blocks, so a dropped partial read would lose
            # up to K*block_len-1 real samples). Pad value = the format's
            # zero level (128 for unsigned 8-bit).
            self.done = True
            bps_bytes = 2 * (self.bps // 8)
            raw = raw[:len(raw) - len(raw) % bps_bytes]
            out = self._empty()
            if raw:
                tail = self._decode(raw)
                out[:len(tail)] = tail
            return out
        return self._decode(raw)


class _SynthSource:
    """A deterministic synthesized pass (or pure-noise dead antenna):
    a carrier offset plus the LEO Doppler of a stretch of an overhead
    pass, centred idx-dependently within +-60 s of closest approach
    (|Doppler| <= ~1.7 kHz, so offset + Doppler stays inside the
    default +-fmax sweep)."""

    def __init__(self, idx: int, cfg: DemodConfig, n_blocks: int,
                 feed_len: int, dead: bool):
        n = n_blocks * feed_len
        if dead:
            rng = np.random.default_rng(1000 + idx)
            x = (500.0 * (rng.standard_normal(n)
                          + 1j * rng.standard_normal(n))
                 ).astype(np.complex64)
        else:
            # Carrier offsets cycle in 317 Hz steps folded into +-1000 Hz.
            c = -1000.0 + (317.0 * idx) % 2000.0
            t_ca = -60.0 + (37.0 * idx) % 120.0
            x, _ = synth_psk(
                int(n * cfg.symrate / cfg.samplerate) + 64,
                cfg.samplerate, symrate=cfg.symrate, oqpsk=cfg.oqpsk,
                carrier_hz=c, amplitude=6000.0,
                snr_db=(12.0, 15.0, 18.0, 25.0)[idx % 4], seed=idx,
                carrier_profile=lambda m: leo_doppler_hz(
                    m, cfg.samplerate, t_ca_s=t_ca))
            x = x[:n]
        self.x = x
        self.block_len = feed_len
        self.pos = 0
        self.done = False

    def seek_blocks(self, n: int) -> None:
        self.pos = n * self.block_len
        self.done = self.pos + self.block_len > len(self.x)

    def next_block(self) -> np.ndarray:
        if self.pos + self.block_len > len(self.x):
            self.done = True
            return np.zeros(self.block_len, np.complex64)
        b = self.x[self.pos:self.pos + self.block_len]
        self.pos += self.block_len
        return b


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--inputs", nargs="*", default=[],
                    help="2-channel WAV files, one per stream")
    ap.add_argument("--synth", type=int, default=0,
                    help="additionally synthesize this many streams")
    ap.add_argument("--dead", type=int, default=0,
                    help="of the synthesized streams, make this many "
                         "pure-noise dead antennas (exercises parking)")
    ap.add_argument("--seconds", type=float, default=10.0,
                    help="length of the synthesized streams")
    ap.add_argument("-s", "--samplerate", type=int, default=230400)
    ap.add_argument("--bps", type=int, default=16, choices=(8, 16, 32),
                    help="bits per sample for raw (non-WAV) inputs")
    ap.add_argument("--block-len", type=int, default=8192)
    ap.add_argument("--group-size", type=int, default=128)
    ap.add_argument("--chain", type=int, default=8,
                    help="blocks per device dispatch (the bench headline "
                         "shape is 16; higher amortizes the host round "
                         "trip, lower tightens the policy/status tick)")
    ap.add_argument("--band", type=int, default=8)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--checkpoint", default=None,
                    help=".npz path; saved periodically and on SIGINT/"
                         "SIGTERM")
    ap.add_argument("--checkpoint-every", type=int, default=256,
                    help="dispatches (chains of --chain blocks) between "
                         "periodic checkpoint saves")
    ap.add_argument("--resume", action="store_true",
                    help="resume from --checkpoint (inputs are seeked to "
                         "the checkpoint's block index; .s files appended)")
    ap.add_argument("--status-every", type=int, default=64)
    ap.add_argument("--park-after-s", type=float, default=5.0,
                    help="seconds of signal a stream may stay unlocked "
                         "(while peers are locked) before it parks onto "
                         "the host side-path. Generous by default: a "
                         "TRANSIENTLY parked stream's symbols come from "
                         "the host program for the parked span — same "
                         "decisions, int8 soft values within the "
                         "cross-program loop noise of the -T contract — "
                         "so only streams that are genuinely dead should "
                         "park")
    ap.add_argument("--sweep-rescue", type=float, default=0.0,
                    help="seconds of unlocked signal before a stream's "
                         "sweep is kicked onto the downward escape pass "
                         "(0 = off = exact reference acquisition; see "
                         "parallel/mesh.py sweep_rescue_s)")
    ap.add_argument("--ingest", choices=("auto", "f32", "i16", "u8"),
                    default="auto",
                    help="sample upload format: i16/u8 uploads the raw "
                         "integer stream and decodes on device (2x/4x "
                         "less host->device traffic). "
                         "auto picks i16/u8 when EVERY input file shares "
                         "that format and no synth streams are mixed in")
    ap.add_argument("--until", choices=("shortest", "longest"),
                    default="shortest",
                    help="stop when the FIRST source ends (default; no "
                         "stream is ever fed post-EOF zeros) or when the "
                         "LAST does (shorter streams feed zeros and "
                         "their post-EOF rows are dropped)")
    ap.add_argument("--max-blocks", type=int, default=0,
                    help="stop after this many dispatches (chains of "
                         "--chain blocks; 0 = run to EOF); for "
                         "deterministic kill/resume validation")
    args = ap.parse_args(argv)
    enable_compile_cache()

    cfg = DemodConfig(samplerate=args.samplerate, block_len=args.block_len)
    feed_len = args.chain * cfg.block_len     # samples per dispatch
    park_ticks = max(1, round(args.park_after_s * cfg.samplerate
                              / feed_len))
    n_blocks_synth = max(
        1, int(args.seconds * cfg.samplerate / feed_len))
    sources = [_FileSource(p, feed_len, cfg.samplerate, args.bps)
               for p in args.inputs]
    n_files = len(sources)
    for i in range(args.synth):
        sources.append(_SynthSource(n_files + i, cfg, n_blocks_synth,
                                    feed_len, dead=i < args.dead))
    ingest = args.ingest
    if ingest == "auto":
        file_bps = {s.bps for s in sources if isinstance(s, _FileSource)}
        if args.synth == 0 and file_bps == {16}:
            ingest = "i16"
        elif args.synth == 0 and file_bps == {8}:
            ingest = "u8"
        else:
            ingest = "f32"
    if ingest != "f32":
        bad = [i for i, s in enumerate(sources)
               if not isinstance(s, _FileSource)
               or s.bps != (16 if ingest == "i16" else 8)]
        if bad:
            raise SystemExit(
                f"--ingest {ingest} needs every input to be a "
                f"{'16' if ingest == 'i16' else '8'}-bit file; "
                f"streams {bad} are not")
        for src in sources:
            src.raw_dtype = np.int16 if ingest == "i16" else np.uint8
            src.raw_pad = 0 if ingest == "i16" else 128
        print(f"raw {ingest} ingest: on-device decode", flush=True)
    n_streams = len(sources)
    if n_streams == 0 or n_streams % args.group_size != 0:
        raise SystemExit(
            f"{n_streams} streams; need a nonzero multiple of "
            f"--group-size {args.group_size}")

    start_block = 0
    if args.resume:
        if not (args.checkpoint and os.path.exists(args.checkpoint)):
            raise SystemExit("--resume needs an existing --checkpoint")
        fleet = load_serving_checkpoint(args.checkpoint)
        if fleet.n_streams != n_streams:
            raise SystemExit(
                f"checkpoint has {fleet.n_streams} streams, inputs give "
                f"{n_streams}")
        if fleet.group_size != args.group_size:
            raise SystemExit(
                f"checkpoint group size {fleet.group_size} != "
                f"--group-size {args.group_size}")
        if fleet.cfg != cfg:
            raise SystemExit(
                "checkpoint was saved with a different DemodConfig "
                f"({fleet.cfg}) than this session ({cfg}) — pass the "
                "matching -s/--block-len")
        if fleet.groups and fleet.groups[0].ingest != ingest:
            raise SystemExit(
                f"checkpoint ingest {fleet.groups[0].ingest!r} != this "
                f"session's {ingest!r}; pass the matching --ingest")
        if fleet.groups and fleet.groups[0].chain_blocks != args.chain:
            raise SystemExit(
                f"checkpoint was saved with --chain "
                f"{fleet.groups[0].chain_blocks}, this run uses "
                f"--chain {args.chain} — the block index and input "
                "seeks are in chain units; pass the matching --chain")
        # Session policy flags win over the checkpointed values — an
        # operator restarting WITH --sweep-rescue expects it to apply.
        for f in fleet.groups:
            f.set_sweep_rescue(args.sweep_rescue)
            f.park_after = park_ticks
        start_block = fleet.groups[0]._block_idx
        for s in sources:
            s.seek_blocks(start_block)
        print(f"resumed at chain {start_block}", flush=True)
    else:
        fleet = ServingFleet(cfg, n_streams, group_size=args.group_size,
                             band=args.band,
                             sweep_rescue_s=args.sweep_rescue,
                             chain_blocks=args.chain,
                             park_after=park_ticks, ingest=ingest,
                             packed_output=True)

    os.makedirs(args.out_dir, exist_ok=True)
    mode = "ab" if args.resume else "wb"
    files = [open(os.path.join(args.out_dir, f"stream{i:03d}.s"), mode)
             for i in range(n_streams)]
    writers = [SymbolWriter(f) for f in files]
    if args.resume:
        wpath = args.checkpoint + ".writers.npz"
        if not os.path.exists(wpath):
            raise SystemExit(
                f"{wpath} missing: writer ring state is saved next to "
                "every checkpoint — without it a resume would duplicate "
                "or misalign output bytes. Restart without --resume to "
                "start fresh.")
        with np.load(wpath) as z:
            if int(z["block_idx"]) != start_block:
                raise SystemExit(
                    f"writer state is from block {int(z['block_idx'])} "
                    f"but the fleet checkpoint is from {start_block} — "
                    "the host died between the two save steps. Restart "
                    "without --resume (or restore a consistent pair).")
            for i, w in enumerate(writers):
                w._ring[:] = z["rings"][i]
                w._fill = int(z["fills"][i])
                w.bytes_out = int(z["bytes_out"][i])
        # The .s files may hold bytes written AFTER the checkpoint
        # (blocks between the last save and the kill): truncate back
        # to the recorded counts so the resume appends exactly once.
        # A file SHORTER than the count means the out-dir does not match
        # the checkpoint (truncate would zero-fill a silent hole).
        for i, f in enumerate(files):
            have = os.fstat(f.fileno()).st_size
            if have < writers[i].bytes_out:
                raise SystemExit(
                    f"{f.name}: {have} bytes on disk but the checkpoint "
                    f"recorded {writers[i].bytes_out} — the output dir "
                    "does not match this checkpoint")
            f.truncate(writers[i].bytes_out)
            f.seek(writers[i].bytes_out)

    stop = {"now": False}

    def _sig(_signo, _frame):
        stop["now"] = True

    old_handlers = {s: signal.signal(s, _sig)
                    for s in (signal.SIGINT, signal.SIGTERM)}

    def _write_rows(i: int, sym_a, sym_b, valid, locked_once) -> None:
        """Valid-gate one stream's rows into its lock-gated writer.
        Device rows arrive PRE-QUANTIZED int8 (PackedOutput — the fleet
        runs packed_output=True, so the .s byte math happened on device
        and the egress was ~4x smaller); parked host-path rows arrive
        f32 and quantize here with the identical math."""
        v = np.asarray(valid).astype(bool)
        if not v.any():
            return
        sym_a, sym_b = np.asarray(sym_a), np.asarray(sym_b)
        lo = np.asarray(locked_once)[v].astype(np.int32)
        if sym_a.dtype == np.int8:
            n = int(v.sum())
            iq = np.empty(2 * n, np.int8)
            iq[0::2] = sym_a[v]
            iq[1::2] = sym_b[v]
            writers[i].feed(iq, lo)
            return
        sym = np.zeros(int(v.sum()),
                       dtype=[("re", np.float32), ("im", np.float32),
                              ("locked_once", np.int32)])
        sym["re"] = sym_a[v]
        sym["im"] = sym_b[v]
        sym["locked_once"] = lo
        writers[i].feed(quantize_symbols(sym), sym["locked_once"])

    def _drain_stream(i: int) -> None:
        """Write stream i's deferred host-path (parked) symbols."""
        rows = fleet.parked_output(i)
        _write_rows(i, rows["sym_re"], rows["sym_im"], rows["valid"],
                    rows["locked_once"])

    def _save() -> None:
        if not args.checkpoint:
            return
        for i in range(n_streams):
            _drain_stream(i)          # deferred rows go to disk, not .npz
        for f in files:
            f.flush()
        # Writer ring state rides in a side file so a resumed host
        # continues the byte stream EXACTLY (flushing partial rings
        # mid-run would break the reference's ring cadence and emit
        # pre-lock bytes; the reference flushes only at EOF).
        tmp = args.checkpoint + ".tmp.npz"   # savez appends .npz otherwise
        save_serving_checkpoint(tmp, fleet)
        os.replace(tmp, args.checkpoint)
        # block_idx ties the two files together: resume refuses a pair
        # split by a crash between the replaces (loud error, never a
        # silent byte hole).
        wtmp = args.checkpoint + ".writers.tmp.npz"
        np.savez(wtmp,
                 block_idx=np.int64(fleet.groups[0]._block_idx),
                 rings=np.stack([w._ring for w in writers]),
                 fills=np.array([w._fill for w in writers]),
                 bytes_out=np.array([w.bytes_out for w in writers]))
        os.replace(wtmp, args.checkpoint + ".writers.npz")
        print(f"checkpoint saved at chain {fleet.groups[0]._block_idx}",
              flush=True)

    t0 = time.time()
    blocks = 0
    mid_chain = False      # True while a chain's rows are being written:
    # an exception there leaves a torn state (some writers have the
    # chain, others do not), so the exit save must NOT checkpoint it —
    # the last periodic checkpoint stays the consistent resume point.
    try:
        while not stop["now"]:
            if args.max_blocks and blocks >= args.max_blocks:
                break
            if args.until == "shortest" and any(s.done for s in sources):
                break
            if all(s.done for s in sources):
                break
            # A source that already hit EOF feeds zeros this chain (the
            # fleet shape is static); its device rows are post-signal
            # garbage (locked_once stays set, so the lock gate would pass
            # them) — drop them. The real tail is written in the chain
            # where done first flips (was_done still False there).
            was_done = [s.done for s in sources]
            batch = np.stack([s.next_block() for s in sources])
            mid_chain = True
            outs = fleet.process_blocks(batch)
            for i in range(n_streams):
                _drain_stream(i)
                if was_done[i]:
                    continue
                _write_rows(i, np.asarray(outs.sym_i)[i],
                            np.asarray(outs.sym_q)[i],
                            np.asarray(outs.valid)[i],
                            np.asarray(outs.locked_once)[i])
            mid_chain = False
            blocks += 1
            if args.checkpoint and blocks % args.checkpoint_every == 0:
                _save()
            if blocks % args.status_every == 0:
                tel = {g: f.telemetry for g, f in enumerate(fleet.groups)}
                locked = sum(int(t["locked_streams"]) for t in tel.values()
                             if t is not None)
                parked = sum(len(f._parked) for f in fleet.groups)
                rate = (blocks * feed_len * n_streams
                        / max(time.time() - t0, 1e-9) / 1e6)
                print(f"chain {start_block + blocks}: locked {locked}/"
                      f"{n_streams}, parked {parked}, {rate:.1f} Msamp/s",
                      flush=True)
    finally:
        if mid_chain:
            print("aborted mid-chain: keeping the last periodic "
                  "checkpoint (a save now would record a torn state)",
                  flush=True)
        else:
            _save()
        for i in range(n_streams):
            _drain_stream(i)
        for w in writers:
            w.flush_partial()
        for f in files:
            f.close()
        total = sum(w.bytes_out for w in writers)
        print(f"{start_block + blocks} chains served, {total} soft bytes "
              f"across {n_streams} streams", flush=True)
        for s, h in old_handlers.items():
            signal.signal(s, h)
    return 0


if __name__ == "__main__":
    sys.exit(main())
