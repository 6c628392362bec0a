"""Raw integer ingest: on-device sample decode (mesh.py ingest=i16/u8).

Uploading the SDR's raw integer stream and decoding on device cuts
host->device traffic 2x (int16) / 4x (uint8). The on-device decode must
be BIT-EXACTLY io/wav.py decode_iq's math (i16: float cast, exact for
all int16; u8: float - 128), so a raw-ingest fleet's output is bitwise
the f32 fleet's on the same underlying samples — including the host-side
paths that need f32 (parked worker feed, oracle recovery decode)."""

import numpy as np
import pytest

from meteor_demod_tpu.config import DemodConfig
from meteor_demod_tpu.parallel.mesh import FleetDemodulator
from meteor_demod_tpu.sim import synth_psk


@pytest.fixture(scope="module")
def cfg():
    return DemodConfig(samplerate=230400, block_len=2048)


def _int_fixture(cfg, n_streams, n_blocks, scale, noise_stream=None):
    """Integer sample pairs (n, N, 2) plus the decode_iq-equivalent
    complex64 view of the same values."""
    n = n_blocks * cfg.block_len
    raws = []
    for i in range(n_streams):
        if i == noise_stream:
            rng = np.random.default_rng(99)
            x = 500.0 * (rng.standard_normal(n)
                         + 1j * rng.standard_normal(n))
        else:
            x, _ = synth_psk(
                int(n * cfg.symrate / cfg.samplerate) + 64,
                cfg.samplerate, carrier_hz=60.0 + 15.0 * i,
                amplitude=6000.0, snr_db=22.0, seed=70 + i)
            x = x[:n]
        pairs = np.stack([np.round(x.real * scale),
                          np.round(x.imag * scale)], axis=-1)
        raws.append(pairs)
    return np.stack(raws)


def test_packed_output_bitwise_equals_host_quantize(cfg):
    """packed_output=True (device-side quantization, state.PackedOutput)
    produces the EXACT bytes host-side quantize_symbols would — for
    device rows, oracle-recovered rows, and parked masked rows."""
    from tests.test_fleet_recovery import _mixed_fleet
    from meteor_demod_tpu.demod.pipeline import quantize_symbols
    n_streams, n_blocks, K = 8, 9, 3
    data = _mixed_fleet(cfg, n_streams, n_blocks)   # incl. a flag trip

    L = K * cfg.block_len
    a2 = FleetDemodulator(cfg, n_streams, park=False, chain_blocks=K)
    b2 = FleetDemodulator(cfg, n_streams, park=False, chain_blocks=K,
                          packed_output=True)
    for c in range(n_blocks // K):
        blk = data[:, c * L:(c + 1) * L]
        for fa, fb, kk in ((a2, b2, "chain"),):
            ga = fa.process_blocks(blk)
            gb = fb.process_blocks(blk)
            np.testing.assert_array_equal(
                np.asarray(ga.valid), np.asarray(gb.valid),
                err_msg=f"{kk} {c} valid")
            np.testing.assert_array_equal(
                np.asarray(ga.locked_once).astype(np.int8),
                np.asarray(gb.locked_once), err_msg=f"{kk} {c} lonce")
            for s in range(n_streams):
                v = np.asarray(ga.valid)[s].astype(bool)
                sym = np.zeros(int(v.sum()),
                               dtype=[("re", np.float32),
                                      ("im", np.float32),
                                      ("locked_once", np.int32)])
                sym["re"] = np.asarray(ga.sym_re)[s][v]
                sym["im"] = np.asarray(ga.sym_im)[s][v]
                want = quantize_symbols(sym)
                np.testing.assert_array_equal(
                    np.asarray(gb.sym_i)[s][v], want[0::2],
                    err_msg=f"{kk} {c} stream {s} I")
                np.testing.assert_array_equal(
                    np.asarray(gb.sym_q)[s][v], want[1::2],
                    err_msg=f"{kk} {c} stream {s} Q")
    assert b2.recovered_streams > 0    # the packed recovery path ran


@pytest.mark.parametrize("ingest", ["i16", "u8"])
def test_raw_ingest_bitwise_equals_f32(cfg, ingest):
    n_streams, n_blocks, K = 8, 8, 2
    scale = 1.0 if ingest == "i16" else 1.0 / 60.0
    pairs = _int_fixture(cfg, n_streams, n_blocks, scale,
                         noise_stream=5)
    if ingest == "i16":
        raw = np.clip(pairs, -32768, 32767).astype(np.int16)
        f32 = raw.astype(np.float32)
    else:
        raw = np.clip(pairs + 128.0, 0, 255).astype(np.uint8)
        f32 = raw.astype(np.float32) - np.float32(128.0)

    a = FleetDemodulator(cfg, n_streams, park_after=2, chain_blocks=K)
    b = FleetDemodulator(cfg, n_streams, park_after=2, chain_blocks=K,
                         ingest=ingest)
    L = K * cfg.block_len
    for c in range(n_blocks // K):
        ga = a.process_blocks(
            np.ascontiguousarray(f32[:, c * L:(c + 1) * L]))
        gb = b.process_blocks(
            np.ascontiguousarray(raw[:, c * L:(c + 1) * L]))
        for name in ("sym_re", "sym_im", "valid", "locked_once"):
            np.testing.assert_array_equal(
                np.asarray(getattr(ga, name)),
                np.asarray(getattr(gb, name)),
                err_msg=f"{ingest} chain {c} {name}")
    # The parking policy behaved identically (same noise-lane handling),
    # and the parked HOST path (fed device-decoded-equivalent f32) too.
    assert sorted(a._parked) == sorted(b._parked)
    for i in a._parked:
        a.wait_parked_drained()
        b.wait_parked_drained()
        ra, rb = a.parked_output(i), b.parked_output(i)
        for k in ra:
            np.testing.assert_array_equal(ra[k], rb[k],
                                          err_msg=f"parked {i} {k}")
