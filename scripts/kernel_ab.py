"""Kernel-vs-scan and FIR-lowering timings on the GPU.

Times the recurrence kernel (kernels/recurrence.py) against what XLA makes
of `jax.vmap(make_block_demod(cfg))`, both chained CHAIN blocks per
dispatch, for QPSK, OQPSK and the hi-fi stress at several stream counts;
and the FIR's conv lowering against a banded-Toeplitz dot_general, both at
HIGHEST precision, at the fleet shape. Each row is a JSON line on stdout;
the card's name and power limit come first.

    python scripts/kernel_ab.py

Exits non-zero when JAX finds no GPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from meteor_demod_tpu.checks import card_name_power
from meteor_demod_tpu.config import DemodConfig
from meteor_demod_tpu.demod.backend import make_batch_demod
from meteor_demod_tpu.demod.state import batch_carry
from meteor_demod_tpu.dsp.fir import (fir_reference_np, iq_to_f32,
                                      make_fir_banks, polyphase_fir_block)
from meteor_demod_tpu.kernels.recurrence import make_kernel_batch_demod
from meteor_demod_tpu.sim import synth_psk
from meteor_demod_tpu.utils import enable_compile_cache

CHAIN = 16
CONFIGS = {
    "qpsk": DemodConfig(samplerate=230400, block_len=8192),
    "oqpsk": DemodConfig(samplerate=230400, symrate=80000.0, oqpsk=True,
                         block_len=8192),
    "hifi": DemodConfig(samplerate=230400, rrc_order=64, interp=10,
                        block_len=8192),
}


def emit(**row):
    print(json.dumps(row), flush=True)


def signal(cfg, n, seed=0):
    x, _ = synth_psk(int(n * cfg.symrate / cfg.samplerate) + 64,
                     cfg.samplerate, symrate=cfg.symrate, oqpsk=cfg.oqpsk,
                     carrier_hz=400.0, amplitude=6000.0, snr_db=18.0,
                     seed=seed)
    return iq_to_f32(x[:n])


def chained(demod):
    def run(carry, blocks):
        carry, outs = jax.lax.scan(demod, carry, blocks)
        return carry, jnp.sum(outs.valid)
    return jax.jit(run)


def time_fn(fn, args, reps=3):
    """Median of `reps` timed calls (after one compile+warm call)."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), ts, compile_s


def recurrence_row(name, cfg, batch, backend, tile=None, chain=CHAIN):
    L = cfg.block_len
    bl = jnp.asarray(signal(cfg, chain * L).reshape(chain, 1, L, 2))
    blocks = jnp.broadcast_to(bl, (chain, batch, L, 2)) + 0.0
    if backend == "kernel" and tile is not None:
        demod = make_kernel_batch_demod(cfg, batch, tile=tile)
    else:
        demod = make_batch_demod(cfg, batch, backend)
    fn = chained(demod)
    carry = batch_carry(cfg, batch)
    med, ts, compile_s = time_fn(fn, (carry, blocks))
    n = chain * L * batch
    emit(kind="recurrence", config=name, batch=batch, backend=backend,
         tile=tile, chain=chain, dispatch_s=med, dispatch_s_all=ts,
         msamples_per_s=n / med / 1e6, compile_s=compile_s)


def check_against_scan(name, cfg, batch=128, nblk=4):
    """Kernel vs scan on the card: decisions and values (one dispatch)."""
    L = cfg.block_len
    x = np.stack([signal(cfg, nblk * L, seed=b) for b in range(batch)])
    blocks = jnp.asarray(x.reshape(batch, nblk, L, 2).transpose(1, 0, 2, 3))
    outs = {}
    for backend in ("kernel", "scan"):
        demod = make_batch_demod(cfg, batch, backend)

        def run(carry, blocks, demod=demod):
            return jax.lax.scan(demod, carry, blocks)

        c, o = jax.jit(run)(batch_carry(cfg, batch), blocks)
        outs[backend] = jax.device_get((c, o))
    (ck, ok), (cs, os_) = outs["kernel"], outs["scan"]
    v = np.asarray(os_.valid).astype(bool)
    same_valid = bool(np.array_equal(np.asarray(ok.valid),
                                     np.asarray(os_.valid)))
    both = v & np.asarray(ok.valid).astype(bool)
    sign = float(np.mean(np.sign(np.asarray(ok.sym_re)[both])
                         == np.sign(np.asarray(os_.sym_re)[both])))
    emit(kind="check_vs_scan", config=name, batch=batch, blocks=nblk,
         valid_equal=same_valid,
         counts_equal=bool(np.array_equal(np.asarray(ok.valid).sum(-1),
                                          np.asarray(os_.valid).sum(-1))),
         locked_equal=bool(np.array_equal(np.asarray(ck.locked),
                                          np.asarray(cs.locked))),
         flags_kernel=int(np.asarray(ck.flags).sum()),
         flags_scan=int(np.asarray(cs.flags).sum()),
         sign_agree=sign)


def toeplitz_fir(banks, ch=128):
    """Banded-Toeplitz dot_general FIR (the alternative lowering)."""
    interp, taps = banks.shape
    u_len = ch + taps - 1
    w = np.zeros((u_len, ch, interp), np.float32)
    for s in range(ch):
        w[s:s + taps, s, :] = banks.T
    wm = jnp.asarray(w.reshape(u_len, ch * interp))

    def fir(x, tail):
        L = x.shape[0]
        xin = jnp.concatenate([tail, x])
        k = L // ch
        a = xin[:L].reshape(k, ch, 2)
        ext = jnp.concatenate([a[1:, :taps - 1],
                               xin[None, L:L + taps - 1]], axis=0)
        win = jnp.concatenate([a, ext], axis=1)
        out = jax.lax.dot_general(win, wm, (((1,), (0,)), ((), ())),
                                  precision=jax.lax.Precision.HIGHEST,
                                  preferred_element_type=jnp.float32)
        return out.transpose(0, 2, 1).reshape(L, interp, 2)
    return fir


def fir_rows(batch=128):
    for name in ("qpsk", "hifi"):
        cfg = CONFIGS[name]
        banks = make_fir_banks(cfg)
        L = cfg.block_len
        x = np.stack([signal(cfg, L, seed=b) for b in range(batch)])
        tail = np.zeros((batch, cfg.taps - 1, 2), np.float32)
        ref = fir_reference_np(x[0].view(np.complex64)[:, 0],
                               np.zeros(cfg.taps - 1, np.complex64), banks)
        variants = {
            "conv_highest": lambda xs, ts: polyphase_fir_block(xs, ts,
                                                               banks)[0],
            "toeplitz_highest": toeplitz_fir(banks),
        }
        xd, td = jnp.asarray(x), jnp.asarray(tail)
        for vname, f in variants.items():
            fn = jax.jit(jax.vmap(f))
            med, ts, compile_s = time_fn(fn, (xd, td), reps=5)
            F = np.asarray(fn(xd, td))[0]
            Fc = F[..., 0] + 1j * F[..., 1]
            err = float(np.max(np.abs(Fc - ref)) / np.max(np.abs(ref)))
            emit(kind="fir", config=name, batch=batch, lowering=vname,
                 dispatch_s=med, dispatch_s_all=ts,
                 msamples_per_s=batch * L / med / 1e6, max_rel_err=err)


def main() -> int:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX found {dev.platform!r}", file=sys.stderr)
        return 1
    enable_compile_cache()
    emit(kind="card", nvidia_smi=card_name_power(), device_kind=dev.device_kind)
    for name, cfg in CONFIGS.items():
        check_against_scan(name, cfg)
    fir_rows()
    for tile in (32, 64, 128):                 # lanes per program
        recurrence_row("qpsk", CONFIGS["qpsk"], 1024, "kernel", tile)
    for name, cfg in CONFIGS.items():
        for batch in (1, 128, 1024):
            for backend in ("kernel", "scan"):
                recurrence_row(name, cfg, batch, backend)
    for batch in (4096, 8192):
        recurrence_row("qpsk", CONFIGS["qpsk"], batch, "kernel")
    recurrence_row("qpsk", CONFIGS["qpsk"], 4096, "scan")
    return 0


if __name__ == "__main__":
    sys.exit(main())
