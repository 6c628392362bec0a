"""Pass-scale soak: >=1 Gsample (~72 min of 230.4 ksps signal) end to end.

VERDICT r4 item 6: the reference's real workload is an hours-long live loop
(main.c:303-329); nothing in the repo had run longer than a few hundred
Msamples. This drives >=1 Gsample through the SPAN-TURBO streaming path
(demod/turbo.py span_submit/span_finish — each span is a full fused gauge
turbo run chained from the previous span's exact exit carry, so this is
simultaneously the turbo soak and the streaming soak) plus a sequential
chained-dispatch leg, with:

- a MID-STREAM CHECKPOINT: the exit carry is serialized to .npz at the
  half-way span, the next span runs, then the checkpoint is restored and
  the same span re-run — consumed count, gauges, symbol payload and exit
  carry must be BITWISE identical (the carry is a complete exact state,
  io/checkpoint.py's argument, exercised here at the Gsample scale);
- counter/accumulator checks every span: convergence (P == chunks,
  2 passes), lock held, p_err / phases finite and in range (the tick
  counter is per-block and resets; p_phase wraps mod 2pi — the soak
  verifies no drift pathology accumulates across ~60 wraps of everything);
- host RSS tracked across the run (memory stability);
- sustained throughput (samples/s over the whole wall window).

The span signal is seam-periodic (integer symbols per span) so one
device-resident span chains into itself indefinitely — the carry evolution
is honest while the 8 GB of samples are never uploaded.

On the GPU:  python scripts/soak.py           (~1 Gsample, minutes)
CPU smoke:   python scripts/soak.py cpu small (~8 Msample)
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

CPU = "cpu" in sys.argv[1:]
SMALL = "small" in sys.argv[1:]
if CPU:
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax.numpy as jnp

from meteor_demod_tpu.config import DemodConfig
from meteor_demod_tpu.demod.pipeline import egress
from meteor_demod_tpu.demod.state import init_carry
from meteor_demod_tpu.dsp.fir import iq_to_f32
from meteor_demod_tpu.sim import synth_psk
from meteor_demod_tpu.utils import enable_compile_cache


def log(m):
    print(m, file=sys.stderr, flush=True)


def rss_mb():
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) // 1024
    return -1


def _sync(c):
    return int(np.sum(egress(c.flags)))


def sanity(carry_np, where):
    """Counter/accumulator pathology checks on an egressed carry."""
    import math
    for k, v in carry_np._asdict().items():
        a = np.asarray(v)
        if a.dtype.kind == "f":
            assert np.all(np.isfinite(a)), (where, k, "non-finite")
    p = float(np.asarray(carry_np.p_phase).reshape(-1)[0])
    t = float(np.asarray(carry_np.t_phase).reshape(-1)[0])
    assert 0.0 <= p < 2 * math.pi + 1e-3, (where, "p_phase", p)
    assert -1e-3 <= t < 2 * math.pi + 1e-3, (where, "t_phase", t)
    perr = float(np.asarray(carry_np.p_err).reshape(-1)[0])
    assert 0.0 < perr < 1000.0, (where, "p_err", perr)


def span_soak(cfg, target_samples, chunks, kb, ckpt_path):
    from meteor_demod_tpu.demod.turbo import (span_submit, span_finish,
                                              build_warmup,
                                              default_warmup_blocks)
    from bench import _chained_fn  # noqa: E402  (repo-root bench helpers)
    L = cfg.block_len
    span_n = chunks * kb * L
    assert (span_n * int(cfg.symrate)) % int(cfg.samplerate) == 0
    n_spans = max(2, -(-target_samples // span_n))
    # Small-block smoke mode needs a longer warm (lock at 400 Hz takes
    # ~0.5 s of signal) — use a nearer carrier + more warm blocks there.
    nwarm = 60 if SMALL else 24
    carrier = round((80.0 if SMALL else 400.0) * span_n / cfg.samplerate) \
        * cfg.samplerate / span_n
    nsym = int((nwarm * L + span_n) * cfg.symrate / cfg.samplerate) + 64
    x, _ = synth_psk(nsym, cfg.samplerate, symrate=cfg.symrate,
                     carrier_hz=carrier, amplitude=6000.0, snr_db=18.0,
                     seed=9)
    xf_all = iq_to_f32(x[:nwarm * L + span_n])

    wide = _chained_fn(cfg, None)
    carry = init_carry(cfg)
    carry, _ = wide(carry, jnp.asarray(xf_all[:nwarm * L].reshape(nwarm, L, 2)))
    assert _sync(carry) == 0
    c = jax.tree_util.tree_map(np.asarray, egress(carry))
    assert int(c.locked) == 1

    xf_span = xf_all[nwarm * L:]
    blocks_dev = jnp.asarray(
        xf_span.reshape(chunks, kb, L, 2).transpose(1, 0, 2, 3)) + 0.0
    kb_w = min(default_warmup_blocks(L, kb), kb)
    wblocks_np, _ = build_warmup(xf_span, chunks, kb * L, kb_w, L, cfg.taps)
    wblocks_dev = jnp.asarray(wblocks_np) + 0.0

    def one_span(c):
        p = span_submit(cfg, c, xf_span, chunks=chunks,
                        blocks_dev=blocks_dev, wblocks_dev=wblocks_dev)
        res = span_finish(cfg, p)
        return p, res

    # compile + warm (untimed)
    p, res = one_span(c)
    assert p.P == chunks and p.converged, (p.P, p.converged)

    ck_span = n_spans // 2
    consumed = 0
    n_sym = 0
    rss0 = rss_mb()
    rss_track = []
    passes_max = 0
    ck_record = None
    t0 = time.time()
    for s in range(n_spans):
        p, res = one_span(c)
        assert p.converged and p.P == chunks, (s, p.P, p.converged)
        passes_max = max(passes_max, p.passes)
        consumed += p.consumed
        n_sym += len(res.symbols)
        c = jax.tree_util.tree_map(np.asarray, p.exit_carry)
        sanity(c, f"span {s}")
        assert int(np.asarray(c.locked)) == 1, s
        if s == ck_span:
            np.savez(ckpt_path, **{k: np.asarray(v)
                                   for k, v in c._asdict().items()})
            log(f"checkpoint saved at span {s} ({consumed/1e6:.0f} Msamp)")
        if s == ck_span + 1:
            ck_record = (len(res.symbols), int(p.consumed),
                         np.asarray(p.K).copy(),
                         hash(res.symbols.tobytes()),
                         jax.tree_util.tree_map(np.asarray, c))
        if s % 10 == 0:
            rss_track.append(rss_mb())
    wall = time.time() - t0
    rate = consumed / wall

    # Restore the checkpoint and re-run the post-checkpoint span: bitwise
    # identical consumed/gauges/symbols/exit carry.
    z = np.load(ckpt_path)
    c2 = type(c)(**{k: z[k] for k in z.files})
    p2, res2 = one_span(c2)
    nsym2, cons2, K2, h2, cexit = ck_record
    assert int(p2.consumed) == cons2
    assert len(res2.symbols) == nsym2
    np.testing.assert_array_equal(np.asarray(p2.K), K2)
    assert hash(res2.symbols.tobytes()) == h2, "symbol payload differs"
    c2exit = jax.tree_util.tree_map(np.asarray, p2.exit_carry)
    for k in c2exit._fields:
        np.testing.assert_array_equal(np.asarray(getattr(c2exit, k)),
                                      np.asarray(getattr(cexit, k)),
                                      err_msg=k)
    log("checkpoint restore: bitwise-identical span replay OK")

    return dict(samples=int(consumed), symbols=int(n_sym),
                spans=n_spans, passes_max=passes_max,
                msamples_per_s=round(rate / 1e6, 1),
                signal_minutes=round(consumed / cfg.samplerate / 60, 1),
                rss_start_mb=rss0, rss_track_mb=rss_track,
                rss_end_mb=rss_mb(), checkpoint_span=ck_span)


def sequential_soak(cfg, target_samples):
    """Sequential chained-dispatch leg (the per-block live path) over a
    device-resident seam-periodic span."""
    from bench import _chained_fn, CHAIN
    L = cfg.block_len
    span = CHAIN * L
    carrier = round(400.0 * span / cfg.samplerate) * cfg.samplerate / span
    nsym = int(span * cfg.symrate / cfg.samplerate) + 64
    x, _ = synth_psk(nsym, cfg.samplerate, carrier_hz=carrier,
                     amplitude=6000.0, snr_db=18.0, seed=11)
    blocks = jnp.asarray(iq_to_f32(x[:span]).reshape(CHAIN, L, 2))
    fn = _chained_fn(cfg, None)
    carry = init_carry(cfg)
    carry, _ = fn(carry, blocks)                 # compile + acquire lock
    assert _sync(carry) == 0
    n_disp = max(2, -(-target_samples // span))
    t0 = time.time()
    for d in range(n_disp):
        carry, _ = fn(carry, blocks)
        if d % 200 == 199:
            assert _sync(carry) == 0          # periodic flag fence
    assert _sync(carry) == 0
    wall = time.time() - t0
    c = jax.tree_util.tree_map(np.asarray, egress(carry))
    sanity(c, "sequential end")
    assert int(np.asarray(c.locked)) == 1
    return dict(samples=n_disp * span,
                msamples_per_s=round(n_disp * span / wall / 1e6, 2))


def main():
    cfg = DemodConfig(samplerate=230400, block_len=2048 if SMALL else 8192)
    if SMALL:
        target, chunks, kb = 8 * 1 << 20, 8, 8
        seq_target = 4 * 1 << 20
    else:
        target, chunks, kb = 1 << 30, 128, 16
        seq_target = 1 << 28
    enable_compile_cache()
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        span_res = span_soak(cfg, target, chunks, kb,
                             os.path.join(tmp, "soak_ckpt.npz"))
    log(f"span soak: {span_res}")
    seq_res = sequential_soak(cfg, seq_target)
    log(f"sequential soak: {seq_res}")
    print(json.dumps({"span": span_res, "sequential": seq_res}))


if __name__ == "__main__":
    main()
