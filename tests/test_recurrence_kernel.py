"""The GPU recurrence kernel (kernels/recurrence.py) on the CPU, through the
Pallas interpreter, against the XLA scan (demod/scan.py) it must agree
with; plus the backend choice, the FIR's precision and the compile-cache
helper.

In interpret mode both paths run on XLA:CPU, so the decision structure
(which ticks fire, symbol counts, lock transitions, integer state) must be
identical; float values may differ by FMA-fusion ULPs between the two
programs and are compared with a tight tolerance."""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from meteor_demod_tpu.config import DemodConfig
from meteor_demod_tpu.demod import backend as be
from meteor_demod_tpu.demod.scan import make_block_demod, _make_gate
from meteor_demod_tpu.demod.state import batch_carry
from meteor_demod_tpu.dsp.fir import iq_to_f32
from meteor_demod_tpu.kernels import recurrence
from meteor_demod_tpu.kernels.recurrence import make_kernel_batch_demod
from meteor_demod_tpu.sim import synth_psk

CONFIGS = {
    "qpsk": DemodConfig(samplerate=230400, block_len=1024),
    "oqpsk": DemodConfig(samplerate=230400, symrate=80000.0, oqpsk=True,
                         block_len=1024),
    "hifi": DemodConfig(samplerate=230400, rrc_order=64, interp=10,
                        block_len=1024),
}


def _streams(cfg, batch, n_blocks, seed=0):
    n = n_blocks * cfg.block_len
    x = np.stack([
        synth_psk(int(n * cfg.symrate / cfg.samplerate) + 64,
                  cfg.samplerate, symrate=cfg.symrate, oqpsk=cfg.oqpsk,
                  carrier_hz=60.0 + 30 * b, amplitude=6000.0, snr_db=22.0,
                  seed=seed + b, dc_offset=25 - 10j)[0][:n]
        for b in range(batch)])
    return iq_to_f32(x).reshape(batch, n_blocks, cfg.block_len, 2)


def _assert_match(rc, ro, kc, ko):
    for f in ("valid", "locked_once"):
        np.testing.assert_array_equal(np.asarray(getattr(ko, f)),
                                      np.asarray(getattr(ro, f)), err_msg=f)
    m = np.asarray(ro.valid).astype(bool)
    for f in ("sym_re", "sym_im"):
        np.testing.assert_allclose(np.asarray(getattr(ko, f))[m],
                                   np.asarray(getattr(ro, f))[m],
                                   rtol=1e-5, atol=1e-3, err_msg=f)
    for k in rc._fields:
        a, b = np.asarray(getattr(rc, k)), np.asarray(getattr(kc, k))
        if a.dtype.kind == "i":
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-4,
                                       err_msg=k)


def _run_both(cfg, batch, n_blocks, seed=0, tile=recurrence.TILE):
    x = _streams(cfg, batch, n_blocks, seed)
    ref = jax.jit(jax.vmap(make_block_demod(cfg)))
    ker = jax.jit(make_kernel_batch_demod(cfg, batch, tile=tile,
                                          interpret=True))
    rc = kc = batch_carry(cfg, batch)
    nvalid = 0
    for k in range(n_blocks):
        rc, ro = ref(rc, x[:, k])
        kc, ko = ker(kc, jnp.asarray(x[:, k]))
        _assert_match(rc, ro, kc, ko)
        nvalid += int(np.asarray(ro.valid).sum())
    assert int(np.asarray(kc.flags).sum()) == 0
    return nvalid


@pytest.mark.parametrize("n_blocks", [1, 3])
@pytest.mark.parametrize("mode", ["qpsk", "oqpsk", "hifi"])
def test_kernel_matches_scan(mode, n_blocks):
    cfg = CONFIGS[mode]
    assert _run_both(cfg, 4, n_blocks) > 100 * n_blocks


@pytest.mark.parametrize("batch", [1, 37])
def test_kernel_batch_not_multiple_of_tile(batch):
    """Padding lanes (the tile is 32 lanes) must not disturb real ones."""
    _run_both(CONFIGS["qpsk"], batch, 1, seed=5)


def test_kernel_small_tile_multiple_programs():
    """Several programs over the batch (tile 2 -> 3 programs for B=5)."""
    _run_both(CONFIGS["oqpsk"], 5, 2, seed=7, tile=2)


def test_kernel_splits_batches_past_int32_offsets(monkeypatch):
    """Batches whose flat FIR offsets would pass int32 run as several
    kernel calls; the result is the unsplit one."""
    cfg = CONFIGS["qpsk"]
    x = jnp.asarray(_streams(cfg, 6, 1, seed=3)[:, 0])
    whole = make_kernel_batch_demod(cfg, 6, tile=2, interpret=True)
    monkeypatch.setattr(recurrence, "_MAX_FLAT", 2 * 2 * cfg.block_ticks + 1)
    split = make_kernel_batch_demod(cfg, 6, tile=2, interpret=True)
    c = batch_carry(cfg, 6)
    (c1, o1), (c2, o2) = whole(c, x), split(c, x)
    for a, b in zip(jax.tree_util.tree_leaves((c1, o1)),
                    jax.tree_util.tree_leaves((c2, o2))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_kernel_adversarial_block_host_output_is_oracle():
    """Full-scale 16-bit cold start (tests/test_adversarial.py's worst
    case) through the stream host on the kernel: the host output equals
    the numpy oracle's decisions."""
    from meteor_demod_tpu.demod import scalar
    from meteor_demod_tpu.demod.pipeline import StreamDemodulator
    cfg = DemodConfig(samplerate=230400, block_len=2048)
    n = 3 * cfg.block_len
    x, _ = synth_psk(int(n * cfg.symrate / cfg.samplerate) + 64,
                     cfg.samplerate, carrier_hz=250.0, amplitude=23000.0,
                     snr_db=25.0, seed=7)
    x = (np.clip(np.real(x[:n]), -32768, 32767)
         + 1j * np.clip(np.imag(x[:n]), -32768, 32767)).astype(np.complex64)
    d = StreamDemodulator(cfg, backend="kernel_interpret")
    got = np.concatenate([d.process(x), d.finish()])
    ref, _ = scalar.demod_stream_np(cfg, x)
    assert len(got) == len(ref)
    np.testing.assert_array_equal(got["locked_once"], ref["locked_once"])
    for k in ("re", "im"):
        assert np.mean(np.sign(got[k]) == np.sign(ref[k])) > 0.999


@pytest.mark.parametrize("mode", ["qpsk", "oqpsk"])
def test_turbo_through_kernel(mode):
    """demod_array_turbo with the kernel backend equals the scan-backend
    turbo decision for decision."""
    from meteor_demod_tpu.demod.turbo import demod_array_turbo
    cfg = dataclasses.replace(CONFIGS[mode], block_len=2048)
    chunks = 4
    n = chunks * 2 * cfg.block_len
    x, _ = synth_psk(int(n * cfg.symrate / cfg.samplerate) + 64,
                     cfg.samplerate, symrate=cfg.symrate, oqpsk=cfg.oqpsk,
                     carrier_hz=150.0, amplitude=6000.0, snr_db=22.0,
                     seed=21)
    runs = [demod_array_turbo(cfg, x[:n], chunks=chunks, backend=b)
            for b in ("scan", "kernel_interpret")]
    a, b = runs[0].symbols, runs[1].symbols
    assert len(a) == len(b) > 1000
    np.testing.assert_array_equal(a["locked_once"], b["locked_once"])
    for k in ("re", "im"):
        np.testing.assert_array_equal(np.sign(a[k]), np.sign(b[k]))


def test_fleet_on_cpu_mesh_through_kernel():
    """FleetDemodulator sharded over the 8-device CPU mesh, recurrence on
    the kernel: outputs and telemetry equal the scan fleet's."""
    from meteor_demod_tpu.parallel.mesh import FleetDemodulator, make_mesh
    cfg = DemodConfig(samplerate=230400, block_len=1024)
    assert len(jax.devices()) == 8
    n_streams = 8
    x = _streams(cfg, n_streams, 2, seed=11)
    fleets = [FleetDemodulator(cfg, n_streams, mesh=make_mesh(), backend=b)
              for b in ("scan", "kernel_interpret")]
    for k in range(2):
        outs = [f.process_blocks(x[:, k]) for f in fleets]
        np.testing.assert_array_equal(outs[0].valid, outs[1].valid)
        np.testing.assert_array_equal(outs[0].locked_once,
                                      outs[1].locked_once)
        m = np.asarray(outs[0].valid).astype(bool)
        np.testing.assert_allclose(np.asarray(outs[1].sym_re)[m],
                                   np.asarray(outs[0].sym_re)[m],
                                   rtol=1e-5, atol=1e-3)
        for key in ("locked_streams", "locked_once_streams", "symbols",
                    "flags"):
            assert int(fleets[0].telemetry[key]) == \
                int(fleets[1].telemetry[key]), key


def test_padded_gate_equals_exact_gate():
    """The kernel's power-of-two candidate axis (masked past K) makes the
    same gate decisions, bit for bit, as the K-wide gate."""
    cfg = CONFIGS["qpsk"]
    K = cfg.gate_candidates
    assert K & (K - 1)                     # 24: the padding is exercised
    rng = np.random.default_rng(0)
    n = 4096
    tp = rng.uniform(-2.0, 7.0, n).astype(np.float32)
    tf = (cfg.timing_freq * rng.uniform(0.999, 1.001, n)).astype(np.float32)
    thresh = np.full(n, 2 * np.pi, np.float32)
    t = rng.integers(cfg.block_ticks - 40, cfg.block_ticks + 1,
                     n).astype(np.int32)
    exact = _make_gate(cfg)(tp, tf, thresh, t)
    padded = _make_gate(cfg, 32)(tp, tf, thresh, t)
    for a, b in zip(exact, padded):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_default_backend_on_cpu_is_scan():
    assert jax.devices()[0].platform == "cpu"
    assert be.default_backend() == "scan"
    assert be.resolve_backend("auto") == "scan"
    with pytest.raises(ValueError):
        be.resolve_backend("pallas")


def test_product_path_never_interprets():
    """The product backend names compile the kernel for the card: on the
    CPU the "kernel" backend refuses to lower instead of silently running
    the interpreter, and "auto" never resolves to the interpreter."""
    cfg = CONFIGS["qpsk"]
    assert "kernel_interpret" not in {be.resolve_backend("auto"),
                                      be.default_backend()}
    fn = jax.jit(be.make_batch_demod(cfg, 2, "kernel"))
    x = jnp.zeros((2, cfg.block_len, 2), jnp.float32)
    with pytest.raises(Exception):
        fn.lower(batch_carry(cfg, 2), x).compile()


def test_fir_conv_runs_at_highest_precision():
    """The FIR conv asks for HIGHEST precision (a GPU would otherwise be
    free to run the f32 conv in TF32)."""
    from meteor_demod_tpu.dsp.fir import make_fir_banks, polyphase_fir_block
    cfg = CONFIGS["qpsk"]
    banks = make_fir_banks(cfg)
    jaxpr = jax.make_jaxpr(lambda x, t: polyphase_fir_block(x, t, banks))(
        jnp.zeros((cfg.block_len, 2)), jnp.zeros((cfg.taps - 1, 2)))
    convs = [e for e in jaxpr.jaxpr.eqns
             if e.primitive.name == "conv_general_dilated"]
    assert len(convs) == 1
    prec = convs[0].params["precision"]
    assert all(p == jax.lax.Precision.HIGHEST for p in prec), prec


def test_fir_precision_check_on_cpu():
    """The on-card FIR check (meteor_demod_tpu.checks) passes on the CPU
    at a small fleet shape: <= 1e-5 normwise against fir_reference_np."""
    from meteor_demod_tpu import checks
    r = checks.check_fir(CONFIGS["hifi"], n_streams=4)
    assert r["max_rel_err"] <= checks.FIR_REL_TOL


def test_compile_cache_defaults_to_checkout(monkeypatch):
    from meteor_demod_tpu import utils
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        path = utils.enable_compile_cache()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    from meteor_demod_tpu import utils
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    old = jax.config.jax_compilation_cache_dir
    assert utils.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == old    # nothing set
