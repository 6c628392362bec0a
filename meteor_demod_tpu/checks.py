"""On-device checks of the main paths, shared by chip_smoke.py and the
gpu-marked tests.

Each check drives one path through the entry point a user calls, compares
what comes out with the repository's own reference (the numpy oracle
demod/scalar.py, fir_reference_np, the sequential demodulator, or a
one-device run), raises AssertionError on any failure, and returns a dict
of what it measured — `samples` and `seconds` of the timed device work
among them.

Tolerances against the oracle, and why: on a GPU the compiler contracts
a*b+c into fused multiply-adds, so loop-state values drift from the numpy
oracle by ULPs. The closed-form timing gate keeps each fire decision
FMA-proof, but a drifted trajectory can move an occasional fire by one
tick. Per-block symbol counts, block-end lock state and safety flags must
therefore match exactly; soft symbols are held to sign agreement
(SIGN_AGREE_MIN, lock-gated) and a mean int8 difference (MEAN_ABS_LSB_MAX).
Within a block the lock edge itself may move by a few symbols: the lock
detector is a threshold crossing of the p_err moving average, and a
ULP-drifted average crosses it a fire earlier or later (LOCK_EDGE_MAX).
"""

from __future__ import annotations

import os
import subprocess
import time

import numpy as np

# FIR: normwise relative error against fir_reference_np. TF32 (about 3
# decimal digits) fails it by two orders of magnitude.
FIR_REL_TOL = 1e-5
SIGN_AGREE_MIN = 0.999
MEAN_ABS_LSB_MAX = 0.5
LOCK_EDGE_MAX = 64          # symbols

# Mixed fixtures: carriers on both sides of zero (the far ones do not lock
# within a few blocks, which exercises acquisition), SNRs cycling.
CARRIERS_HZ = (-120.0, -60.0, 0.0, 40.0, 90.0, 150.0, 250.0, 400.0)
SNRS_DB = (12.0, 15.0, 18.0, 25.0)


def _require(ok, msg) -> None:
    """A check that holds under `python -O` too (unlike assert)."""
    if not ok:
        raise AssertionError(msg)


def card_name_power() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def quantize(v) -> np.ndarray:
    """The .s byte math (pipeline.quantize_symbols), as int32."""
    return np.trunc(np.clip(np.asarray(v, np.float32) * np.float32(0.5),
                            -127.0, 127.0)).astype(np.int32)


def fixture_streams(cfg, n_streams: int, n_samples: int,
                    seed: int = 0) -> np.ndarray:
    """(n_streams, n_samples) complex64 mixed fixtures."""
    from .sim import synth_psk
    nsym = int(n_samples * cfg.symrate / cfg.samplerate) + 64
    return np.stack([
        synth_psk(nsym, cfg.samplerate, symrate=cfg.symrate,
                  oqpsk=cfg.oqpsk,
                  carrier_hz=CARRIERS_HZ[i % len(CARRIERS_HZ)],
                  amplitude=6000.0, snr_db=SNRS_DB[i % len(SNRS_DB)],
                  seed=seed + i)[0][:n_samples]
        for i in range(n_streams)])


def _timed(fn, *args):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------- FIR --

def check_fir(cfg, n_streams: int = 128) -> dict:
    """Device FIR at the fleet shape vs fir_reference_np: proves the conv
    runs at full f32 precision (no TF32)."""
    import jax
    import jax.numpy as jnp
    from .dsp.fir import fir_reference_np, iq_to_f32, make_fir_banks, \
        polyphase_fir_block
    banks = make_fir_banks(cfg)
    L = cfg.block_len
    x = fixture_streams(cfg, n_streams, L)
    fn = jax.jit(jax.vmap(lambda xs, ts: polyphase_fir_block(xs, ts,
                                                             banks)[0]))
    xd = jnp.asarray(iq_to_f32(x))
    td = jnp.zeros((n_streams, cfg.taps - 1, 2), jnp.float32)
    F, _ = _timed(fn, xd, td)
    F, dt = _timed(fn, xd, td)
    F = np.asarray(F)
    err = 0.0
    for i in sorted({0, n_streams - 1}):
        ref = fir_reference_np(x[i], np.zeros(cfg.taps - 1, np.complex64),
                               banks)
        got = F[i, ..., 0] + 1j * F[i, ..., 1]
        err = max(err, float(np.max(np.abs(got - ref))
                             / np.max(np.abs(ref))))
    _require(err <= FIR_REL_TOL,
             f"FIR max relative error {err:.3g}")
    return dict(max_rel_err=err, samples=n_streams * L, seconds=dt)


# --------------------------------------------------------- recurrence --

def _oracle_stream(cfg, F_blocks, x_blocks):
    """Numpy oracle over one stream's blocks, consuming the device's FIR
    outputs. Returns per-block (count, locked, locked_once) and the
    symbols."""
    from .demod import scalar
    st = scalar.initial_state(cfg)
    counts, locked, lonce, syms = [], [], [], []
    for F, xb in zip(F_blocks, x_blocks):
        s, st = scalar.demod_stream_np(cfg, xb, st, F=F)
        counts.append(len(s))
        locked.append(int(st["locked"]))
        lonce.append(int(st["locked_once"]))
        syms.append(s)
    return (np.array(counts), np.array(locked), np.array(lonce),
            np.concatenate(syms))


def _map_oracle(cfg, F, x):
    """_oracle_stream over every stream, in worker processes."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    n = len(x)
    workers = max(1, min(16, os.cpu_count() or 1, n))
    if workers == 1:
        return [_oracle_stream(cfg, F[i], x[i]) for i in range(n)]
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        return list(ex.map(_oracle_stream, [cfg] * n, list(F), list(x)))


def check_recurrence(cfg, backend: str = "auto", n_streams: int = 128,
                     n_blocks: int = 4) -> dict:
    """The batched recurrence on the device vs the numpy oracle, block by
    block, on mixed fixtures (see the module docstring for tolerances)."""
    import jax
    import jax.numpy as jnp
    from .demod.backend import make_batch_demod, resolve_backend
    from .demod.state import batch_carry
    from .dsp.fir import iq_to_f32, make_fir_banks, polyphase_fir_block
    backend = resolve_backend(backend)
    L = cfg.block_len
    x = fixture_streams(cfg, n_streams, n_blocks * L, seed=100)
    xb = x.reshape(n_streams, n_blocks, L)
    xf = jnp.asarray(iq_to_f32(xb))                 # (B, nblk, L, 2)
    banks = make_fir_banks(cfg)
    demod = jax.jit(make_batch_demod(cfg, n_streams, backend))
    fir = jax.jit(jax.vmap(lambda xs, ts: polyphase_fir_block(xs, ts, banks)))

    def run():
        carry = batch_carry(cfg, n_streams)
        carries, outs, Fs = [], [], []
        for k in range(n_blocks):
            Fs.append(fir(xf[:, k], carry.fir_tail)[0])
            carry, o = demod(carry, xf[:, k])
            carries.append(carry)
            outs.append(o)
        return carries, outs, Fs

    run()                                           # compile
    t0 = time.perf_counter()
    carries, outs, Fs = jax.block_until_ready(run())
    dt = time.perf_counter() - t0
    carries, outs, Fs = jax.device_get((carries, outs, Fs))
    F = np.stack([f[..., 0] + 1j * f[..., 1] for f in Fs], axis=1)
    F = F.astype(np.complex64).reshape(n_streams, n_blocks, L, cfg.interp)
    ref = _map_oracle(cfg, F, xb)

    flags = int(sum(np.asarray(c.flags).sum() for c in carries))
    _require(flags == 0,
             f"{backend}: {flags} safety flags on clean fixtures")
    agree = total = 0
    lsb = []
    edge = 0
    for i in range(n_streams):
        counts, locked, lonce, syms = ref[i]
        valid = [np.asarray(o.valid[i]).astype(bool) for o in outs]
        dev_counts = np.array([v.sum() for v in valid])
        _require(np.array_equal(dev_counts, counts),
                 f"stream {i}: symbol counts {dev_counts} != oracle {counts}")
        _require(np.array_equal([int(c.locked[i]) for c in carries],
                                locked), f"stream {i} lock")
        _require(np.array_equal([int(c.locked_once[i]) for c in carries],
                                lonce), f"stream {i} locked_once")
        re = np.concatenate([np.asarray(o.sym_re[i])[v]
                             for o, v in zip(outs, valid)])
        im = np.concatenate([np.asarray(o.sym_im[i])[v]
                             for o, v in zip(outs, valid)])
        lo = np.concatenate([np.asarray(o.locked_once[i])[v]
                             for o, v in zip(outs, valid)])
        first = [int(np.argmax(a)) if a.any() else len(a)
                 for a in (lo == 1, syms["locked_once"] == 1)]
        edge = max(edge, abs(first[0] - first[1]))
        _require(edge <= LOCK_EDGE_MAX,
                 f"stream {i}: lock edge at symbol {first[0]} "
                 f"vs oracle {first[1]}")
        g = (syms["locked_once"] == 1) & (lo == 1)
        for dev, orc in ((re, syms["re"]), (im, syms["im"])):
            agree += int(np.sum((dev[g] >= 0) == (orc[g] >= 0)))
            total += int(g.sum())
            lsb.append(np.abs(quantize(dev[g]) - quantize(orc[g])))
    _require(total > 0, "no lock-gated symbols")
    sign = agree / total
    mad = float(np.concatenate(lsb).mean())
    _require(sign >= SIGN_AGREE_MIN,
             f"{backend}: sign agreement {sign:.5f}")
    _require(mad < MEAN_ABS_LSB_MAX,
             f"{backend}: mean |diff| {mad:.3f} LSB")
    return dict(backend=backend, sign_agree=sign, mean_abs_lsb=mad,
                gated_components=total, lock_edge_max_shift=edge,
                samples=n_streams * n_blocks * L, seconds=dt)


# --------------------------------------------------------------- CLI --

def _leo_pass(seconds: float, carrier_hz: float, seed: int = 1,
              samplerate: int = 230400):
    from .sim import leo_doppler_hz, synth_psk
    t_ca = seconds / 2
    x, _ = synth_psk(int(seconds * 72000) + 64, samplerate,
                     carrier_hz=carrier_hz, amplitude=6000.0, snr_db=20.0,
                     seed=seed,
                     carrier_profile=lambda m: leo_doppler_hz(
                         m, samplerate, t_ca_s=t_ca))
    end_hz = carrier_hz + float(
        leo_doppler_hz(len(x), samplerate, t_ca_s=t_ca)[-1])
    return x, end_hz


def _run_cli(argv, stdin_path=None, stdout_path=None):
    """cli.main in this process, recording the StreamDemodulator it
    builds; optional stdin/stdout files for the pipe mode."""
    import io
    import sys
    from unittest import mock
    from . import cli
    made = []

    class Recording(cli.StreamDemodulator):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    saved = sys.stdin, sys.stdout
    try:
        if stdin_path:
            sys.stdin = io.TextIOWrapper(open(stdin_path, "rb"))
        if stdout_path:
            sys.stdout = io.TextIOWrapper(open(stdout_path, "wb"))
        with mock.patch.object(cli, "StreamDemodulator", Recording):
            rc = cli.main(argv)
    finally:
        if stdout_path:
            sys.stdout.flush()
            sys.stdout.close()
        if stdin_path:
            sys.stdin.close()
        sys.stdin, sys.stdout = saved
    _require(rc == 0,
             f"cli exit {rc}")
    return made[-1]


def check_cli(workdir: str, seconds: float = 6.0) -> dict:
    """The CLI on a 16-bit WAV of a LEO pass (-B) and on 8-bit raw stdin
    (--stdout): lock, carrier estimate near the injected carrier, mean
    |soft| of the .s bytes, and no oracle fallback on clean input."""
    from .sim import write_raw, write_wav
    carrier = 300.0
    x, end_hz = _leo_pass(seconds, carrier)
    wav = os.path.join(workdir, "pass16.wav")
    raw = os.path.join(workdir, "pass8.raw")
    write_wav(wav, x, 230400, 16)
    write_raw(raw, x / 60.0, 8)
    out = {}
    t_all = 0.0
    for mode, argv, stdin in (
            ("wav16", ["meteor_demod_tpu", "-B", "-q", "-o",
                       os.path.join(workdir, "wav16.s"), wav], None),
            ("stdin8", ["meteor_demod_tpu", "--stdout", "-s", "230400",
                        "--bps", "8", "-"], raw)):
        dst = os.path.join(workdir, f"{mode}.s")
        t0 = time.perf_counter()
        d = _run_cli(argv, stdin_path=stdin,
                     stdout_path=dst if stdin else None)
        t_all += time.perf_counter() - t0
        soft = np.fromfile(dst, np.int8)
        mean_soft = float(np.abs(soft.astype(np.float32)).mean())
        carrier_est = d.carrier_freq_hz()
        _require(d.pll_locked,
                 f"{mode}: not locked at the end")
        _require(abs(carrier_est - end_hz) < 50.0,
                 f"{mode}: carrier {carrier_est:.1f} Hz vs injected "
                 f"{end_hz:.1f}")
        _require(55.0 <= mean_soft <= 75.0,
                 f"{mode}: mean |soft| {mean_soft}")
        _require(d.fallback_blocks == 0,
                 f"{mode}: {d.fallback_blocks} blocks fell back to the oracle")
        out[mode] = dict(carrier_hz=carrier_est, injected_hz=end_hz,
                         mean_soft=mean_soft, bytes=int(soft.size))
    out.update(samples=2 * len(x), seconds=t_all)
    return out


# ------------------------------------------------------------ serving --

def check_serving(workdir: str, n_streams: int = 256, group: int = 128,
                  seconds: float = 4.0, block_len: int = 8192,
                  chain: int = 8, n_distinct: int = 16) -> dict:
    """scripts/serve_fleet.py in this process: n_streams 16-bit WAV
    streams (n_distinct LEO passes with mixed carriers and SNRs, one dead
    antenna), uninterrupted vs checkpoint + kill + resume; every .s file
    must be byte-identical."""
    import filecmp
    import importlib.util
    from .sim import leo_doppler_hz, synth_psk, write_wav
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "serve_fleet", os.path.join(root, "scripts", "serve_fleet.py"))
    serve = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(serve)

    fs = 230400
    n = int(seconds * fs)
    paths = []
    rng = np.random.default_rng(5)
    dead = os.path.join(workdir, "dead.wav")
    write_wav(dead, (500.0 * (rng.standard_normal(n)
                              + 1j * rng.standard_normal(n))
                     ).astype(np.complex64), fs, 16)
    for j in range(n_distinct):
        t_ca = -60.0 + 120.0 * j / n_distinct
        x, _ = synth_psk(int(seconds * 72000) + 64, fs,
                         carrier_hz=-1000.0 + (317.0 * j) % 2000.0,
                         amplitude=6000.0, snr_db=SNRS_DB[j % len(SNRS_DB)],
                         seed=200 + j,
                         carrier_profile=lambda m, t=t_ca: leo_doppler_hz(
                             m, fs, t_ca_s=t))
        p = os.path.join(workdir, f"pass{j:02d}.wav")
        write_wav(p, x[:n], fs, 16)
        paths.append(p)
    inputs = [dead] + [paths[i % n_distinct] for i in range(n_streams - 1)]
    common = ["--inputs", *inputs, "--group-size", str(group),
              "--block-len", str(block_len), "--chain", str(chain),
              "--status-every", "1000"]
    a_dir = os.path.join(workdir, "a")
    b_dir = os.path.join(workdir, "b")
    ckpt = os.path.join(workdir, "fleet.ckpt.npz")
    chains = n // (block_len * chain)
    t0 = time.perf_counter()
    _require(serve.main(common + ["--out-dir", a_dir]) == 0,
             "uninterrupted serve_fleet run failed")
    dt = time.perf_counter() - t0
    ck = ["--out-dir", b_dir, "--checkpoint", ckpt]
    _require(serve.main(common + ck + [
        "--checkpoint-every", str(max(1, chains // 3)),
        "--max-blocks", str(max(2, chains // 2))]) == 0,
        "serve_fleet run to the kill point failed")
    _require(serve.main(common + ck + ["--resume"]) == 0,
             "serve_fleet resume failed")
    sizes = []
    for i in range(n_streams):
        name = f"stream{i:03d}.s"
        a, b = os.path.join(a_dir, name), os.path.join(b_dir, name)
        _require(filecmp.cmp(a, b, shallow=False),
                 f"{name} differs on resume")
        sizes.append(os.path.getsize(a))
    sizes = np.array(sizes)
    _require(sizes[1:].min() > 0,
             "a live stream wrote no symbols")
    return dict(streams=n_streams, chains=chains,
                soft_bytes=int(sizes.sum()), dead_stream_bytes=int(sizes[0]),
                samples=n_streams * chains * block_len * chain, seconds=dt)


# -------------------------------------------------------------- turbo --

def check_turbo(parity_seconds: float = 30.0, pass_tiles: int = 20,
                parity_chunks: int = 16, pass_chunks: int = 512) -> dict:
    """Turbo (demod_array_turbo): decision parity with the sequential
    demodulator on a parity_seconds recording, then the whole pass — the
    recording tiled pass_tiles times (seam-continuous: an integer number
    of symbols and carrier cycles per tile)."""
    from .config import DemodConfig
    from .demod.pipeline import StreamDemodulator
    from .demod.turbo import demod_array_turbo
    from .sim import synth_psk
    cfg = DemodConfig(samplerate=230400, block_len=8192)
    n = int(parity_seconds * cfg.samplerate)
    x, _ = synth_psk(int(parity_seconds * cfg.symrate) + 64, cfg.samplerate,
                     carrier_hz=150.0, amplitude=6000.0, snr_db=18.0,
                     seed=31)
    x = x[:n]
    d = StreamDemodulator(cfg)
    t0 = time.perf_counter()
    seq = np.concatenate([d.process(x), d.finish()])
    seq_s = time.perf_counter() - t0
    _require(d.fallback_blocks == 0,
             f"{d.fallback_blocks} fallback blocks")
    res = demod_array_turbo(cfg, x, chunks=parity_chunks, strict=True)
    t0 = time.perf_counter()
    res = demod_array_turbo(cfg, x, chunks=parity_chunks, strict=True)
    par_s = time.perf_counter() - t0
    _assert_same_decisions(res.symbols, seq, "turbo vs sequential")

    xl = np.tile(x, pass_tiles)
    res = demod_array_turbo(cfg, xl, chunks=pass_chunks, strict=True)
    t0 = time.perf_counter()
    res = demod_array_turbo(cfg, xl, chunks=pass_chunks, strict=True)
    pass_s = time.perf_counter() - t0
    _require(not res.fell_back or res.fallback_samples < len(xl) // 10,
             f"pass fell back on {res.fallback_samples} samples")
    expect = len(xl) * cfg.symrate / cfg.samplerate
    _require(abs(len(res.symbols) - expect) < 0.01 * expect,
             len(res.symbols))
    _assert_same_decisions(res.symbols[:len(seq)], seq, "pass prefix")
    return dict(parity_samples=n, sequential_s=seq_s, parity_turbo_s=par_s,
                pass_samples=len(xl), pass_s=pass_s,
                pass_converged=bool(res.converged),
                pass_fallback_samples=int(res.fallback_samples),
                samples=len(xl), seconds=pass_s)


def _assert_same_decisions(got, ref, what: str) -> None:
    _require(len(got) == len(ref),
             f"{what}: {len(got)} vs {len(ref)} symbols")
    _require(np.array_equal(got["locked_once"], ref["locked_once"]),
             f"{what}: lock history differs")
    for k in ("re", "im"):
        agree = float(np.mean((got[k] >= 0) == (ref[k] >= 0)))
        _require(agree == 1.0,
                 f"{what}: {k} sign agreement {agree}")


# ------------------------------------------------------------ 4 cards --

def check_multicard(n_cards: int = 4, streams_per_card: int = 128,
                    block_len: int = 8192) -> dict:
    """The paths that span cards, each against its one-card result: the
    sharded fleet (make_mesh + shard_map + psum telemetry), the
    chunk-mesh turbo, and the time-shard FIR."""
    import jax
    import jax.numpy as jnp
    from .config import DemodConfig
    from .demod.turbo import demod_array_turbo, make_chunk_mesh
    from .dsp.fir import iq_to_f32
    from .parallel.mesh import FleetDemodulator, make_mesh
    from .parallel.timeshard import make_sharded_fir, time_mesh
    devs = jax.devices()
    _require(len(devs) >= n_cards,
             f"{len(devs)} devices < {n_cards}")
    devs = devs[:n_cards]
    cfg = DemodConfig(samplerate=230400, block_len=block_len)
    out = {}

    # Sharded fleet: streams_per_card streams per card, 4 chained blocks.
    n_streams = streams_per_card * n_cards
    x = fixture_streams(cfg, n_streams, 4 * cfg.block_len, seed=300)
    res = {}
    for name, mesh in (("one", make_mesh(devs[:1])), ("all", make_mesh(devs))):
        f = FleetDemodulator(cfg, n_streams, mesh=mesh, chain_blocks=4)
        t0 = time.perf_counter()
        o = f.process_blocks(x)
        res[name] = (o, f.telemetry, time.perf_counter() - t0)
    (o1, t1, _), (o4, t4, dt) = res["one"], res["all"]
    for k in o1._fields:
        _require(np.array_equal(np.asarray(getattr(o1, k)),
                              np.asarray(getattr(o4, k))),
                 f"fleet {k}")
    for k in t1:
        # mean_agc_gain is a pmean: its summation order follows the mesh.
        _require(np.isclose(float(t1[k]), float(t4[k]), rtol=1e-6, atol=0),
                 f"fleet telemetry {k}: {t1[k]} vs {t4[k]}")
    out["fleet"] = dict(streams=n_streams, telemetry={
        k: float(v) for k, v in t4.items()}, seconds=dt)

    # Chunk-mesh turbo: one recording, chunks sharded over the cards.
    xr = fixture_streams(cfg, 1, 64 * n_cards * cfg.block_len, seed=400)[0]
    r1 = demod_array_turbo(cfg, xr, chunks=16 * n_cards, mesh=None)
    r4 = demod_array_turbo(cfg, xr, chunks=16 * n_cards,
                           mesh=make_chunk_mesh(devs))
    for k in ("re", "im", "locked_once"):
        _require(np.array_equal(r1.symbols[k], r4.symbols[k]),
                 f"turbo {k}")
    out["turbo"] = dict(samples=len(xr), symbols=len(r4.symbols),
                        converged=bool(r4.converged))

    # Time-shard FIR: one long block split over the cards with halos.
    xf = jnp.asarray(iq_to_f32(xr[:1 << 20]))
    f1 = np.asarray(make_sharded_fir(cfg, time_mesh(devs[:1]))(xf))
    f4 = np.asarray(make_sharded_fir(cfg, time_mesh(devs))(xf))
    err = float(np.max(np.abs(f1 - f4)) / np.max(np.abs(f1)))
    _require(err <= FIR_REL_TOL,
             f"time-shard FIR differs: {err:.3g}")
    out["timeshard_fir"] = dict(samples=int(xf.shape[0]), max_rel_err=err)
    return out
