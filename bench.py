"""Benchmark: IQ demod throughput on the default 230 ksps QPSK config.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "Msamples/s", "vs_baseline": N, ...}

Headline: fleet throughput per chip — 128 concurrent streams (BASELINE.json
configs[4]), the production serving shape. Extra fields:
  - single_stream_*: one live stream through the chained block demod
    (configs[0]).
  - turbo_single_recording_*: ONE recording demodulated chunk-parallel
    across the batch lanes with the gauge-mode fixpoint (demod/turbo.py:
    warmup + one-shot quadrant resolution, O(1) passes) — the BASELINE
    north-star workload (>=100x real-time for one 230 ksps recording,
    i.e. the job of the reference's main.c:284-329). Only the tiny carry
    and three (C,) fingerprint vectors cross the host link per pass.
  - oqpsk_fleet / hifi fleet stress configs (configs[1]/[3]).

Methodology: the block demodulator is chained CHAIN blocks per dispatch
with an outer lax.scan, so the measurement sees device throughput, not
per-dispatch host latency. Each timed window ends in a device->host
readback of the safety flags (which also checks them). Sample data is
device-resident: the reference's own number is compute-, not I/O-bound.
The bench measures the GPU only: it exits non-zero when JAX finds none.

Baseline: the reference's implied full-load single-core throughput,
~0.66 Msamples/s (BASELINE.md, derived from README.md:71-76: real-time
230 ksps at ~35% of a Pi Zero core).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

from meteor_demod_tpu.config import DemodConfig
from meteor_demod_tpu.demod.backend import make_batch_demod, make_single_demod
from meteor_demod_tpu.demod.pipeline import egress
from meteor_demod_tpu.demod.state import (init_carry, batch_carry,
                                           batch_carry_np)
from meteor_demod_tpu.dsp.fir import iq_to_f32
from meteor_demod_tpu.sim import synth_psk
from meteor_demod_tpu.utils import enable_compile_cache

BASELINE_MSPS = 0.66
SAMPLERATE = 230400
REALTIME_SPS = 230400.0
BLOCK_LEN = 8192
CHAIN = 16            # blocks per dispatch
FLEET_BATCH = 128


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _make_signal(cfg, n_samples, seed=0):
    nsym = int(n_samples * cfg.symrate / cfg.samplerate) + 64
    x, _ = synth_psk(nsym, cfg.samplerate, symrate=cfg.symrate,
                     oqpsk=cfg.oqpsk, carrier_hz=400.0,
                     amplitude=6000.0, snr_db=18.0, seed=seed)
    return x[:n_samples]


def _sync(c):
    """Fence: device->host readback of the safety flags (their sum)."""
    return int(np.sum(egress(c.flags)))


def _chained_fn(cfg, batch):
    """Jitted CHAIN-blocks-per-dispatch demod on the backend
    demod/backend.py picks (batch=None: one stream, no batch axis)."""
    demod = (make_batch_demod(cfg, batch) if batch
             else make_single_demod(cfg))

    def chained(carry, blocks):
        carry, outs = jax.lax.scan(demod, carry, blocks)
        return carry, jnp.sum(outs.valid)

    return jax.jit(chained)


def _spread(rates):
    """Sorted per-window rates -> [min, median, max] in Msamples/s."""
    r = sorted(rates)
    med = r[len(r) // 2] if len(r) % 2 else 0.5 * (r[len(r) // 2 - 1]
                                                   + r[len(r) // 2])
    return [round(r[0] / 1e6, 2), round(med / 1e6, 2),
            round(r[-1] / 1e6, 2)]


def _bench(cfg, batch, seconds):
    """Samples/sec through the chained block demod in carrier-locked
    steady state (the production serving regime): one chained dispatch
    acquires lock on every stream, then the same program is timed from the
    locked carry. Returns (best_sps, [min, med, max] Msamples/s spread)."""
    x = _make_signal(cfg, CHAIN * cfg.block_len)
    bl = iq_to_f32(x.reshape(CHAIN, cfg.block_len))          # (K, L, 2)
    if batch:
        # Upload the (K, L, 2) signal once and broadcast across the batch
        # ON DEVICE.
        blocks = jnp.broadcast_to(jnp.asarray(bl)[:, None],
                                  (CHAIN, batch, cfg.block_len, 2)) + 0.0
        carry0 = batch_carry(cfg, batch)
    else:
        blocks = jnp.asarray(bl)
        carry0 = init_carry(cfg)

    t0 = time.time()
    fn = _chained_fn(cfg, batch)
    carry, nsym = fn(carry0, blocks)                          # compile+warm
    assert _sync(carry) == 0
    locked_n = int(np.sum(egress(carry.locked)))
    log(f"compile+warm (batch={batch}): {time.time()-t0:.1f}s, "
        f"{locked_n}/{batch or 1} locked")

    # Calibrate, then run a fixed dispatch count (an open-ended timed loop
    # would enqueue async dispatches far faster than the device drains them).
    # Three windows; the spread is reported beside the best.
    t0 = time.perf_counter()
    carry, nsym = fn(carry, blocks)
    assert _sync(carry) == 0
    dt1 = time.perf_counter() - t0
    n_calls = max(3, min(100, int(seconds / dt1)))
    per_call = CHAIN * cfg.block_len * (batch or 1)
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n_calls):
            carry, nsym = fn(carry, blocks)
        assert _sync(carry) == 0
        dt = time.perf_counter() - t0
        rates.append(n_calls * per_call / dt)
    rates.sort()
    sps = rates[-1]
    log(f"batch={batch}: 3x{n_calls} dispatches, best {sps/1e6:.2f} "
        f"Msamples/s (spread {rates[0]/1e6:.1f}/{rates[1]/1e6:.1f}/"
        f"{rates[2]/1e6:.1f})")
    return sps, _spread(rates)


def _bench_turbo(cfg, chunks=FLEET_BATCH, kb=128, max_passes=4, seed=3,
                 mesh=None):
    """ONE recording of chunks*kb*block_len samples (the default geometry
    is 134 Msamples, a representative ~10-minute 230.4 ksps LRPT pass),
    demodulated with the FUSED gauge fixpoint (demod/turbo.py
    _fused_gauge_fn): warmup acquisition + both fixpoint passes + one-shot
    quadrant resolution + convergence detection in a single dispatch, with
    ONE small egress — the per-pass host round-trips of the unfused loop
    cost ~3x the device compute at this geometry. With `mesh` the chunk
    axis is sharded over it (a 1-device mesh measures the shard_map
    overhead of the mesh-turbo path vs the plain dispatch). Returns
    (samples_per_sec, passes, converged, spread)."""
    from meteor_demod_tpu.demod.turbo import (
        fused_gauge_run, default_warmup_blocks)

    L = cfg.block_len
    taps = cfg.taps
    # The recording is ONE chunk tiled across the lanes (synth cost stays
    # bounded). The tiling is only physically coherent if the chunk holds
    # an integer number of symbols — otherwise every seam jumps the symbol
    # clock by a fraction of a symbol (e.g. 128*8192 samples at 80 ksym/s /
    # 230.4 ksps is 34133.33 symbols). Snap kb down to the nearest
    # symbol-periodic chunk length (QPSK 72k: every kb; OQPSK 80k: kb % 9).
    from fractions import Fraction
    fr = Fraction(float(cfg.symrate) / float(cfg.samplerate))
    step = (L * fr.limit_denominator(4096)).denominator
    kb = max(step, kb // step * step)
    n_samples = chunks * kb * L
    kb_w = min(default_warmup_blocks(L, kb), kb)

    # One contiguous chunk of real signal; every chunk lane demodulates the
    # same data (synth cost stays bounded; the fixpoint still propagates
    # real carries/gauges across all chunk boundaries). Carrier chosen
    # seam-periodic so the repeated chunk is phase-continuous.
    chunk_len = kb * L
    carrier = round(400.0 * chunk_len / cfg.samplerate) \
        * cfg.samplerate / chunk_len
    nsym = int(chunk_len * cfg.symrate / cfg.samplerate) + 64
    x, _ = synth_psk(nsym, cfg.samplerate, symrate=cfg.symrate,
                     oqpsk=cfg.oqpsk, carrier_hz=carrier,
                     amplitude=6000.0, snr_db=18.0, seed=seed)
    xf = iq_to_f32(x[:chunk_len])                             # (kb*L, 2)
    # Upload the 1-chunk signal once, broadcast across the chunk lanes ON
    # DEVICE (~270 MB at the default geometry).
    xdev = jnp.asarray(xf.reshape(kb, L, 2))
    blocks = jnp.broadcast_to(xdev[:, None], (kb, chunks, L, 2)) + 0.0
    wblocks = jnp.broadcast_to(xdev[kb - kb_w:, None],
                               (kb_w, chunks, L, 2)) + 0.0
    tails_np = np.zeros((chunks, taps - 1, 2), np.float32)
    tails_np[1:] = xf[-(taps - 1):]
    wtails = np.zeros((chunks, taps - 1, 2), np.float32)
    ws = (kb - kb_w) * L
    if ws >= taps - 1:
        wtails[1:] = xf[ws - (taps - 1):ws]

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        axis = mesh.axis_names[0]
        c_shard = NamedSharding(mesh, P(axis))
        lane_shard = NamedSharding(mesh, P(None, axis))
        b_shard = NamedSharding(mesh, P(None, axis))
        put = lambda t: (jax.device_put(t[0], lane_shard),
                         jax.device_put(t[1], lane_shard),
                         jax.device_put(t[2], c_shard))
        # Reshard the device-resident broadcasts onto the mesh (device->
        # device; the host uploads only the 1-chunk signal above).
        blocks = jax.device_put(blocks, b_shard)
        wblocks = jax.device_put(wblocks, b_shard)
        tails_dev = jax.device_put(jnp.asarray(tails_np), c_shard)
    else:
        put = lambda t: tuple(map(jnp.asarray, t))
        tails_dev = jnp.asarray(tails_np)
    w0_np = jax.tree_util.tree_map(
        np.array, batch_carry_np(cfg, chunks)._replace(fir_tail=wtails))
    # The warmup entries are data-derived (FIR tails from the recording) —
    # pre-placed on device like the sample blocks themselves, so the
    # measurement sees the demod work, not the uploads.
    from meteor_demod_tpu.demod.turbo import pack_carry_np
    pw0_dev = put(pack_carry_np(w0_np))

    def one_recording():
        f_np, _, _, passes, converged, _, _, _ = fused_gauge_run(
            cfg, chunks, kb, kb_w, "auto", mesh, put, w0_np,
            wblocks, blocks, tails_dev, tails_np, max_passes,
            pw0_dev=pw0_dev)
        assert int(np.asarray(f_np.flags).sum()) == 0
        return passes, converged

    t0 = time.time()
    passes, converged = one_recording()                        # compile+warm
    log(f"turbo warmup: {time.time()-t0:.1f}s, passes={passes}")
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        passes, converged = one_recording()
        rates.append(n_samples / (time.perf_counter() - t0))
    sps = max(rates)
    log(f"turbo{' (mesh)' if mesh is not None else ''}: "
        f"{n_samples/1e6:.0f} Msamples, best {sps/1e6:.1f} Msamples/s "
        f"(passes={passes}, conv={converged})")
    return sps, passes, converged, _spread(rates)


def _bench_stream_span(cfg, chunks=128, kb=16, nspans=6):
    """Single-stream STREAMING throughput via the span-turbo path
    (demod/turbo.py span_submit/span_finish; VERDICT r2 item 5): one
    ongoing stream, locked, whose buffered spans are demodulated
    chunk-parallel from the stream's exact carry with the strict
    verified-prefix contract. This is the file-backed / bursty
    live-pipeline workload (the reference's README.md:75-92) - the
    sequential per-block chain (single_stream_*) remains the
    latency-bound floor for sample-at-a-time input.

    Steady-state PIPELINED measurement: span k+1 is submitted from span
    k's exit carry (final at submit time, decided by the small egress
    alone) before span k's bulk int8 payload transfers and assembles -
    every span's symbols are fully retrieved and assembled on the host.
    The span signal is seam-periodic (integer symbols per span) so one
    device-resident span chains exactly into itself and the carry
    evolution across spans is honest. Device-resident span blocks, same
    rationale as _bench_turbo. Returns (samples_per_sec, passes,
    verified_all, spread)."""
    from meteor_demod_tpu.demod.turbo import (span_submit, span_finish,
                                              build_warmup,
                                              default_warmup_blocks)
    L = cfg.block_len
    span_n = chunks * kb * L
    # Seam-periodicity: span_n samples must hold an integer number of
    # symbols so the span can chain into itself.
    assert (span_n * int(cfg.symrate)) % int(cfg.samplerate) == 0
    nwarm = 24
    carrier = round(400.0 * span_n / cfg.samplerate) \
        * cfg.samplerate / span_n
    nsym = int((nwarm * L + span_n) * cfg.symrate / cfg.samplerate) + 64
    x, _ = synth_psk(nsym, cfg.samplerate, symrate=cfg.symrate,
                     oqpsk=cfg.oqpsk, carrier_hz=carrier,
                     amplitude=6000.0, snr_db=18.0, seed=9)
    xf_all = iq_to_f32(x[:nwarm * L + span_n])

    # Lock the stream with the chained sequential program.
    wide = _chained_fn(cfg, None)
    carry = init_carry(cfg)
    warm_blocks = jnp.asarray(xf_all[:nwarm * L].reshape(nwarm, L, 2))
    carry, _ = wide(carry, warm_blocks)
    assert _sync(carry) == 0
    carry_np = jax.tree_util.tree_map(np.asarray, egress(carry))
    assert int(carry_np.locked) == 1

    xf_span = xf_all[nwarm * L:]
    blocks_dev = jnp.asarray(
        xf_span.reshape(chunks, kb, L, 2).transpose(1, 0, 2, 3)) + 0.0
    kb_w = min(default_warmup_blocks(L, kb), kb)
    wblocks_np, _ = build_warmup(xf_span, chunks, kb * L, kb_w, L, cfg.taps)
    wblocks_dev = jnp.asarray(wblocks_np) + 0.0

    def run_spans(n):
        """n consecutive spans, pipelined; returns (consumed, passes,
        all_verified)."""
        c = carry_np
        consumed, nsym_out, ok = 0, 0, True
        pend = None
        for _ in range(n):
            p = span_submit(cfg, c, xf_span, chunks=chunks,
                            blocks_dev=blocks_dev, wblocks_dev=wblocks_dev)
            assert p.consumed > 0
            ok = ok and p.P == chunks
            consumed += p.consumed
            c = p.exit_carry
            if pend is not None:
                nsym_out += len(span_finish(cfg, pend).symbols)
            pend = p
        nsym_out += len(span_finish(cfg, pend).symbols)
        assert nsym_out > 0
        return consumed, p.passes, ok

    t0 = time.time()
    # Warm with TWO spans: compiles the fused program AND exercises the
    # submit/finish pipeline overlap path the timed windows measure. It is
    # reported as stream_span_compile_warm_s, NOT a per-session warmup
    # cost: a live -T session with a hot compile cache pays only
    # stream_span_first_span_s.
    consumed, passes, ok = run_spans(2)
    warm_s = time.time() - t0
    log(f"stream-span compile+warm: {warm_s:.1f}s, passes={passes}, "
        f"verified_all={ok}")
    # First-span latency on a warm cache: what a live -T session pays for
    # its first span's symbols once the data is buffered — the CLI
    # pre-compiles at startup (StreamDemodulator.prewarm_span_async), so
    # this, not warm_s, is the user-visible first-span cost.
    t0 = time.perf_counter()
    consumed1, _, _ = run_spans(1)
    first_span_s = time.perf_counter() - t0
    log(f"stream-span first-span latency (warm): {first_span_s:.2f}s "
        f"({consumed1/1e6:.1f} Msamples)")
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        consumed, passes, ok = run_spans(nspans)
        rates.append(consumed / (time.perf_counter() - t0))
    sps = max(rates)
    log(f"stream-span: best {sps/1e6:.1f} Msamples/s "
        f"(passes={passes}, verified_all={ok})")
    return (sps, passes, ok, _spread(rates), round(warm_s, 1),
            round(first_span_s, 2))


def _bench_acquisition_diverse(cfg, batch=FLEET_BATCH, max_disp=120,
                               seed=33):
    """Per-stream DIVERSE cold acquisition.

    16 signal groups span BOTH sweep directions (carriers uniform in
    +-0.85 fmax — negative offsets are the worst case for the
    upward-first acquisition sweep, pll.c:126-128) with SNRs cycling
    12/15/18/25 dB and distinct seeds; lane 0 carries PURE NOISE (the dead
    antenna). The chained program runs until every signal stream locks
    (an untimed replay recovers exact per-stream lock samples)."""
    span = CHAIN * cfg.block_len
    fmax_hz = float(cfg.pll_fmax) * cfg.symrate / (2 * np.pi)
    G = 16
    fracs = np.linspace(-0.85, 0.85, G)
    snrs = [12.0, 15.0, 18.0, 25.0]
    sigs, meta = [], []
    for g in range(G):
        c = (round(fracs[g] * fmax_hz * span / cfg.samplerate)
             * cfg.samplerate / span)            # seam-periodic per group
        x, _ = synth_psk(int(span * cfg.symrate / cfg.samplerate) + 64,
                         cfg.samplerate, symrate=cfg.symrate,
                         oqpsk=cfg.oqpsk, carrier_hz=c, amplitude=6000.0,
                         snr_db=snrs[g % len(snrs)], seed=seed + g)
        sigs.append(iq_to_f32(x[:span]).reshape(CHAIN, cfg.block_len, 2))
        meta.append({"carrier_hz": round(c, 1), "snr_db": snrs[g % len(snrs)]})
    rng = np.random.default_rng(seed)
    noise = (500.0 * (rng.standard_normal(span)
                      + 1j * rng.standard_normal(span))).astype(np.complex64)
    sigs.insert(0, iq_to_f32(noise).reshape(CHAIN, cfg.block_len, 2))
    groups = jnp.asarray(np.stack(sigs, axis=1))      # (CHAIN, G+1, L, 2)
    lane_map = np.zeros(batch, np.int32)
    lane_map[1:] = 1 + (np.arange(batch - 1) % G)
    blocks = jax.jit(
        lambda g: jnp.take(g, jnp.asarray(lane_map), axis=1))(groups)

    fn = _acq_chained(cfg, batch)
    carry = batch_carry(cfg, batch)
    c0, _ = fn(carry, blocks)                         # compile (untimed)
    _sync(c0)

    carry = batch_carry(cfg, batch)
    t0 = time.perf_counter()
    disp, locked_n = 0, 0
    while disp < max_disp:
        carry, _ = fn(carry, blocks)
        disp += 1
        locked_n = int(np.sum(egress(carry.locked)))
        if locked_n >= batch - 1:                     # all but the noise lane
            break
    dwell_s = time.perf_counter() - t0

    # Untimed replay for exact per-stream lock steps.
    lock_step = np.full(batch, -1, np.int64)
    c2 = batch_carry(cfg, batch)
    base = 0
    for _ in range(disp):
        c2, lo = fn(c2, blocks)
        lo = np.asarray(egress(lo)).transpose(1, 0, 2).reshape(batch, -1)
        first = np.argmax(lo > 0, axis=1)
        hit = (lo > 0).any(axis=1) & (lock_step < 0)
        lock_step[hit] = base + first[hit]
        base += lo.shape[1]
    locked_mask = lock_step >= 0
    lock_s = (lock_step[locked_mask] * cfg.ticks_per_step / cfg.interp
              / cfg.samplerate)
    group_locked = {g: int(locked_mask[lane_map == 1 + g].sum())
                    for g in range(G)}
    out = {
        "groups": meta,
        "noise_streams": 1,
        "streams_locked": int(locked_mask.sum()),
        "all_signal_locked": locked_n >= batch - 1,
        "noise_lane_locked": bool(locked_mask[0]),
        "per_group_locked": group_locked,
        "wide_dwell_s": round(dwell_s, 2),
        "signal_dwelled_s": round(disp * span / cfg.samplerate, 2),
        "lock_signal_s_p50": (round(float(np.median(lock_s)), 3)
                              if lock_s.size else None),
        "lock_signal_s_p90": (round(float(np.percentile(lock_s, 90)), 3)
                              if lock_s.size else None),
        "lock_signal_s_max": (round(float(lock_s.max()), 3)
                              if lock_s.size else None),
    }
    cur_locked = np.asarray(egress(carry.locked))
    unlocked = np.nonzero(cur_locked == 0)[0]
    out["never_locked_streams"] = int(len(unlocked))
    if len(unlocked) > 1:
        # Sweep-rescue leg (parallel/mesh.py sweep_rescue_s; the
        # reference-shared acquisition dead zone): kick every
        # never-locked lane onto the downward escape pass (p_freq=+fmax,
        # updown=-1) and measure how many lock within the transit budget.
        # Expectation: everything but the pure-noise lane.
        from meteor_demod_tpu.demod.state import DemodCarry
        kick = {k: np.array(v) for k, v in egress(carry)._asdict().items()}
        kick["p_freq"][unlocked] = np.float32(cfg.pll_fmax)
        kick["updown"][unlocked] = np.float32(-1.0)
        c3 = DemodCarry(**{k: jnp.asarray(v) for k, v in kick.items()})
        extra = 0
        while extra < 30:                 # <= ~17 s signal: transit ~7 s
            c3, _ = fn(c3, blocks)
            extra += 1
            if int(np.sum(egress(c3.locked))) >= batch - 1:
                break
        after = np.asarray(egress(c3.locked))
        out["rescue_kick"] = {
            "kicked_streams": int(len(unlocked)),
            "rescued_streams": int((after[unlocked] != 0).sum()),
            "extra_signal_s": round(extra * span / cfg.samplerate, 2),
            "never_locked_after_rescue": int((after == 0).sum()),
        }
    log(f"acquisition[diverse]: { {k: v for k, v in out.items() if k != 'groups'} }")
    return out


def _bench_acquisition_ramp(cfg, batch=FLEET_BATCH, ramp_hz_s=-500.0,
                            n_disp=4, seed=44):
    """Moving-target acquisition (VERDICT r4 item 1d): the sweep must
    catch a carrier RAMPING at 16x the realistic LEO peak rate (31 Hz/s,
    sim.leo_doppler_hz) — with ramp < 0 the upward sweep and the falling
    carrier approach, cross, and diverge. NON-looped data (a ramp is not
    seam-periodic): n_disp chained spans of fresh signal per lane, 4
    carrier groups broadcast across the batch."""
    span = CHAIN * cfg.block_len
    total = n_disp * span
    G = 4
    carriers = [80.0, 300.0, 700.0, 1400.0]
    sigs = []
    for g in range(G):
        x, _ = synth_psk(int(total * cfg.symrate / cfg.samplerate) + 64,
                         cfg.samplerate, symrate=cfg.symrate,
                         oqpsk=cfg.oqpsk, carrier_hz=carriers[g],
                         carrier_ramp_hz_s=ramp_hz_s, amplitude=6000.0,
                         snr_db=18.0, seed=seed + g)
        sigs.append(iq_to_f32(x[:total]).reshape(n_disp, CHAIN,
                                                 cfg.block_len, 2))
    groups = jnp.asarray(np.stack(sigs, axis=2))  # (n_disp, CHAIN, G, L, 2)
    lane_map = np.arange(batch, dtype=np.int32) % G
    blocks = jax.jit(
        lambda g: jnp.take(g, jnp.asarray(lane_map), axis=2))(groups)

    fn = _acq_chained(cfg, batch)
    carry = batch_carry(cfg, batch)
    lock_step = np.full(batch, -1, np.int64)
    base = 0
    for d in range(n_disp):
        carry, lo = fn(carry, blocks[d])
        lo = np.asarray(egress(lo)).transpose(1, 0, 2).reshape(batch, -1)
        first = np.argmax(lo > 0, axis=1)
        hit = (lo > 0).any(axis=1) & (lock_step < 0)
        lock_step[hit] = base + first[hit]
        base += lo.shape[1]
    locked_mask = lock_step >= 0
    lock_s = (lock_step[locked_mask] * cfg.ticks_per_step / cfg.interp
              / cfg.samplerate)
    per_group_locked = [int(locked_mask[lane_map == g].sum())
                        for g in range(G)]
    out = {
        "ramp_hz_s": ramp_hz_s,
        "carriers_hz": carriers,
        "signal_s": round(total / cfg.samplerate, 2),
        "streams_locked": int(locked_mask.sum()),
        "streams_total": batch,
        "per_group_locked": per_group_locked,
        "lock_signal_s_p50": (round(float(np.median(lock_s)), 3)
                              if lock_s.size else None),
        "lock_signal_s_max": (round(float(lock_s.max()), 3)
                              if lock_s.size else None),
    }
    log(f"acquisition[ramp]: {out}")
    return out


def _acq_chained(cfg, batch):
    """Chained CHAIN-block demod returning locked_once outputs (the
    acquisition benches' shared program shape)."""
    demod = make_batch_demod(cfg, batch)

    def chained_lo(carry, blocks):
        carry, outs = jax.lax.scan(demod, carry, blocks)
        return carry, outs.locked_once

    return jax.jit(chained_lo)


def _bench_acquisition(cfg, batch=FLEET_BATCH, max_disp=40,
                       carrier_hz=400.0, tag="nominal"):
    """Cold start -> all-locked -> first locked dispatch (pll.c:109-130
    sweep, pll.c:117-123 hysteresis).

    A COLD batch fleet dispatches the chained program on a seam-periodic
    device-resident span, reading the locked-stream count after each
    dispatch (the production host's own telemetry), until every stream
    is locked. An untimed replay captures the locked_once output rows for
    the exact per-stream lock step. Returns a dict for the bench record."""
    # Seam-periodic carrier over the CHAIN-block span.
    span = CHAIN * cfg.block_len
    carrier = round(carrier_hz * span / cfg.samplerate) \
        * cfg.samplerate / span
    nsym = int(span * cfg.symrate / cfg.samplerate) + 64
    x, _ = synth_psk(nsym, cfg.samplerate, symrate=cfg.symrate,
                     oqpsk=cfg.oqpsk, carrier_hz=carrier,
                     amplitude=6000.0, snr_db=18.0, seed=21)
    bl = iq_to_f32(x[:span].reshape(CHAIN, cfg.block_len))
    blocks = jnp.broadcast_to(jnp.asarray(bl)[:, None],
                              (CHAIN, batch, cfg.block_len, 2)) + 0.0

    fn = _acq_chained(cfg, batch)
    # Warm the program on a throwaway carry so the timed dwell below is
    # dispatch+readback only (the production host compiles once per fleet).
    c, _ = fn(batch_carry(cfg, batch), blocks)
    assert _sync(c) == 0

    carry = batch_carry(cfg, batch)
    t0 = time.perf_counter()
    disp = 0
    locked_n = 0
    while disp < max_disp:
        carry, _ = fn(carry, blocks)
        disp += 1
        locked_n = int(np.sum(egress(carry.locked)))
        if locked_n == batch:
            break
    dwell_s = time.perf_counter() - t0
    samples = disp * CHAIN * cfg.block_len

    # Untimed replay for the exact per-stream lock step (deterministic).
    lock_step = np.full(batch, -1, np.int64)
    c2 = batch_carry(cfg, batch)
    base = 0
    for _ in range(disp):
        c2, lo = fn(c2, blocks)
        lo = np.asarray(egress(lo))          # (CHAIN, batch, S)
        lo = lo.transpose(1, 0, 2).reshape(batch, -1)
        first = np.argmax(lo > 0, axis=1)
        hit = (lo > 0).any(axis=1) & (lock_step < 0)
        lock_step[hit] = base + first[hit]
        base += lo.shape[1]
    # step index -> approx input sample (a step ~ one symbol); -1 entries
    # never locked and are excluded from the stats.
    locked_mask = lock_step >= 0
    lock_s = (lock_step[locked_mask] * cfg.ticks_per_step / cfg.interp
              / cfg.samplerate)
    all_locked = locked_n == batch

    out = {
        "carrier_hz": round(carrier, 1),
        "all_locked": all_locked,
        "streams_locked": int(locked_mask.sum()),
        "dispatches": disp,
        "samples_dwelled": samples,
        "wide_dwell_s": round(dwell_s, 2),
        "acq_realtime_x": round(samples / cfg.samplerate / dwell_s, 1),
        "lock_signal_s_p50": (round(float(np.median(lock_s)), 3)
                              if lock_s.size else None),
        "lock_signal_s_max": (round(float(lock_s.max()), 3)
                              if lock_s.size else None),
    }
    log(f"acquisition[{tag}]: {out}")
    return out


def _bench_fir(cfg, seconds=2.0):
    """Time-sharded FIR (parallel/timeshard.py) vs the plain overlap-save
    FIR at the same device count (one card): the single-device
    shard_map/halo overhead of the sequence-parallel FIR path, backing
    docs/SCALING.md's sequence-scaling claims with a measured baseline.
    Returns {"sharded": (best_sps, spread), "plain": (best_sps, spread)}
    in input samples/s."""
    from meteor_demod_tpu.parallel.timeshard import (make_sharded_fir,
                                                     time_mesh)
    from meteor_demod_tpu.dsp.fir import make_fir_banks, polyphase_fir_block
    mesh = time_mesh(jax.devices()[:1])
    fir_sh = make_sharded_fir(cfg, mesh)
    banks = make_fir_banks(cfg)
    n = 1 << 21
    xf = jnp.asarray(iq_to_f32(_make_signal(cfg, n)))
    tail0 = jnp.zeros((cfg.taps - 1, 2), jnp.float32)
    fns = {
        "sharded": jax.jit(lambda x: jnp.sum(fir_sh(x))),
        "plain": jax.jit(
            lambda x: jnp.sum(polyphase_fir_block(x, tail0, banks)[0])),
    }
    out = {}
    for name, fn in fns.items():
        float(np.asarray(egress(fn(xf))))                 # compile+warm
        t0 = time.perf_counter()
        s = fn(xf)
        float(np.asarray(egress(s)))
        dt1 = time.perf_counter() - t0
        n_calls = max(30, min(300, int(seconds / max(dt1, 1e-4))))
        rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(n_calls):
                s = fn(xf)
            float(np.asarray(egress(s)))                  # fence
            rates.append(n_calls * n / (time.perf_counter() - t0))
        out[name] = (max(rates), _spread(rates))
        log(f"fir {name}: best {max(rates)/1e6:.0f} Msamples/s")
    return out


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"bench.py measures the GPU; JAX found {dev.platform!r}")
        return 1
    enable_compile_cache()
    cfg = DemodConfig(samplerate=SAMPLERATE, block_len=BLOCK_LEN)

    def maybe(name, thunk):
        """Run a section; report None on failure without sinking the rest."""
        try:
            return thunk()
        except Exception as e:    # noqa: BLE001 - report partial results
            log(f"{name} bench failed: {e}")
            return None

    # Headline first (it is the metric); everything after reuses its cache
    # or compiles something small, so ordering no longer starves the extras.
    fleet_sps, fleet_spread = _bench(cfg, batch=FLEET_BATCH, seconds=3.0)
    single = maybe("single-stream", lambda: _bench(cfg, None, 2.0))
    turbo = maybe("turbo", lambda: _bench_turbo(cfg))
    oqpsk = maybe("oqpsk-fleet", lambda: _bench(
        DemodConfig(samplerate=SAMPLERATE, symrate=80000.0, oqpsk=True,
                    block_len=BLOCK_LEN), FLEET_BATCH, 2.0))
    hifi = maybe("hifi-fleet", lambda: _bench(
        DemodConfig(samplerate=SAMPLERATE, rrc_order=64, interp=10,
                    block_len=BLOCK_LEN), FLEET_BATCH, 2.0))
    # OQPSK single recording through the fused gauge fixpoint (the OQPSK
    # gauge couples the PLL quadrant with the half-symbol timing slot —
    # demod/turbo.py _gauge_measure/_gauge_shift_np).
    turbo_oq = maybe("turbo-oqpsk", lambda: _bench_turbo(
        DemodConfig(samplerate=SAMPLERATE, symrate=80000.0, oqpsk=True,
                    block_len=BLOCK_LEN), seed=5))
    # Mesh-sharded turbo on a 1-device mesh: the shard_map overhead of the
    # multi-device single-recording path vs the plain dispatch above.
    from meteor_demod_tpu.demod.turbo import make_chunk_mesh
    turbo_m = maybe("turbo-mesh1", lambda: _bench_turbo(
        cfg, mesh=make_chunk_mesh(jax.devices()[:1])))
    span = maybe("stream-span", lambda: _bench_stream_span(cfg))
    fir = maybe("timeshard-fir", lambda: _bench_fir(cfg))
    # Cold-start acquisition: per-stream DIVERSE
    # problems (+- carriers spanning both sweep directions, mixed SNRs,
    # one pure-noise dead antenna) with the straggler-parking serving
    # rate, a moving-carrier (ramp) acquisition, and the broadcast
    # fmax-edge worst case kept from r4.
    acq = maybe("acquisition-diverse",
                lambda: _bench_acquisition_diverse(cfg))
    acq_ramp = maybe("acquisition-ramp",
                     lambda: _bench_acquisition_ramp(cfg))
    fmax_hz = float(cfg.pll_fmax) * cfg.symrate / (2 * np.pi)
    acq_edge = maybe("acquisition-edge", lambda: _bench_acquisition(
        cfg, carrier_hz=0.85 * fmax_hz, tag="fmax-edge", max_disp=60))
    acq_neg_edge = maybe("acquisition-neg-edge", lambda: _bench_acquisition(
        cfg, carrier_hz=-0.85 * fmax_hz, tag="neg-fmax-edge", max_disp=160))
    # BASELINE configs[3] pll-bw variants: the hi-fi geometry at 0.5x/2x
    # the default loop bandwidth (golden parity for -b is pinned on CPU by
    # tests/test_golden_reference.py::test_golden_freq_delta_and_pll_bw).
    pllbw = {}
    for bw in (0.5, 2.0):
        r = maybe(f"hifi-pllbw-{bw}", lambda bw=bw: _bench(
            DemodConfig(samplerate=SAMPLERATE, rrc_order=64, interp=10,
                        pll_bw=bw, block_len=BLOCK_LEN), FLEET_BATCH, 1.5))
        if r:
            pllbw[str(bw)] = round(r[0] / 1e6, 2)
    if hifi:
        pllbw["1.0"] = round(hifi[0] / 1e6, 2)

    value = fleet_sps / 1e6
    turbo_sps, turbo_passes, turbo_conv, turbo_spread = \
        turbo if turbo else (None, None, None, None)
    single_sps = single[0] if single else None
    print(json.dumps({
        "metric": "iq_demod_Msamples_per_s_per_card_230ksps_qpsk_128stream_fleet",
        "value": round(value, 2),
        "unit": "Msamples/s",
        "vs_baseline": round(value / BASELINE_MSPS, 1),
        "fleet_batch": FLEET_BATCH,
        "fleet_realtime_x_per_card": round(fleet_sps / REALTIME_SPS, 1),
        "fleet_spread_msps": fleet_spread,
        "single_stream_msamples_per_s":
            round(single_sps / 1e6, 3) if single_sps else None,
        "single_stream_realtime_x":
            round(single_sps / REALTIME_SPS, 1) if single_sps else None,
        "single_stream_spread_msps": single[1] if single else None,
        "stream_span_msamples_per_s":
            round(span[0] / 1e6, 1) if span else None,
        "stream_span_realtime_x":
            round(span[0] / REALTIME_SPS, 1) if span else None,
        "stream_span_passes": span[1] if span else None,
        "stream_span_spread_msps": span[3] if span else None,
        # Compile + first-two-spans time; with a hot persistent cache a
        # session pays only stream_span_first_span_s.
        "stream_span_compile_warm_s": span[4] if span else None,
        "stream_span_first_span_s": span[5] if span else None,
        "turbo_single_recording_msamples_per_s":
            round(turbo_sps / 1e6, 1) if turbo_sps else None,
        "turbo_single_recording_realtime_x":
            round(turbo_sps / REALTIME_SPS, 1) if turbo_sps else None,
        "turbo_passes": turbo_passes,
        "turbo_converged": turbo_conv,
        "turbo_spread_msps": turbo_spread,
        "turbo_oqpsk_single_recording_msamples_per_s":
            round(turbo_oq[0] / 1e6, 1) if turbo_oq else None,
        "turbo_oqpsk_passes": turbo_oq[1] if turbo_oq else None,
        "turbo_oqpsk_spread_msps": turbo_oq[3] if turbo_oq else None,
        "turbo_mesh1_msamples_per_s":
            round(turbo_m[0] / 1e6, 1) if turbo_m else None,
        "turbo_mesh1_spread_msps": turbo_m[3] if turbo_m else None,
        "oqpsk_fleet_msamples_per_s":
            round(oqpsk[0] / 1e6, 2) if oqpsk else None,
        "oqpsk_fleet_spread_msps": oqpsk[1] if oqpsk else None,
        "hifi_o64_x10_fleet_msamples_per_s":
            round(hifi[0] / 1e6, 2) if hifi else None,
        "hifi_fleet_spread_msps": hifi[1] if hifi else None,
        "timeshard_fir_msamples_per_s":
            round(fir["sharded"][0] / 1e6, 1) if fir else None,
        "plain_fir_msamples_per_s":
            round(fir["plain"][0] / 1e6, 1) if fir else None,
        "fleet_acquisition_diverse": acq,
        "fleet_acquisition_ramp": acq_ramp,
        "fleet_acquisition_fmax_edge": acq_edge,
        "fleet_acquisition_neg_fmax_edge": acq_neg_edge,
        "hifi_pllbw_fleet_msamples_per_s": pllbw or None,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "block_len": cfg.block_len,
        "chained_blocks_per_dispatch": CHAIN,
    }))


if __name__ == "__main__":
    sys.exit(main())
