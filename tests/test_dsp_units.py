"""Unit tests for the DSP primitives against closed-form oracles
(SURVEY.md section 4, item 2)."""

import numpy as np
import pytest

from meteor_demod_tpu.dsp.rrc import rrc_coeffs, polyphase_rrc_banks
from meteor_demod_tpu.dsp.sincos import fast_sin, fast_cos, fast_sin_np, fast_cos_np
from meteor_demod_tpu.dsp.loops import (loop_gains, lut_tanh, lut_tanh_np,
                                        mm_error_np, TANH_TABLE)


class TestRRC:
    def test_center_tap_closed_form(self):
        # filter.c:82-84: center = norm * (1 - alpha + 4*alpha/pi)
        taps = rrc_coeffs(65, 3.2, 0.6)
        expect = np.float32(0.4) * np.float32(
            1 - 0.6 + 4 * 0.6 / np.float32(np.pi))
        assert abs(taps[32] - expect) < 1e-6

    def test_window_zeroes_ends(self):
        # Blackman window 0.42-0.5+0.08 = 0 at stage 0 and taps-1.
        taps = rrc_coeffs(65, 3.2, 0.6)
        assert abs(taps[0]) < 1e-6
        assert abs(taps[-1]) < 1e-6

    def test_symmetric(self):
        taps = rrc_coeffs(65, 3.2, 0.6)
        np.testing.assert_allclose(taps, taps[::-1], rtol=0, atol=2e-6)

    def test_matched_filter_response(self):
        # An RRC-shaped impulse train convolved with the matched filter must
        # be (near) ISI-free at symbol points.
        osf = 4.0
        n = 4 * 65 + 1
        tx = rrc_coeffs(n, osf, 0.6).astype(np.float64)
        rx = tx[::-1]
        full = np.convolve(tx, rx)
        center = len(full) // 2
        peak = full[center]
        isi = [full[center + int(k * osf)] for k in range(1, 8)]
        assert all(abs(v) < 0.02 * abs(peak) for v in isi)

    def test_polyphase_bank_layout(self):
        # banks[p, k] must equal prototype[k*factor + factor-1-p]
        # (filter.c:20 + reversed bank indexing filter.c:52).
        order, factor = 8, 5
        banks = polyphase_rrc_banks(order, 3.2, 0.6, factor)
        proto = rrc_coeffs((2 * order + 1) * factor, 3.2 * factor, 0.6)
        for p in range(factor):
            for k in range(2 * order + 1):
                assert banks[p, k] == proto[k * factor + factor - 1 - p]


class TestFastSincos:
    def test_accuracy(self):
        x = np.linspace(-4 * np.pi, 4 * np.pi, 10001).astype(np.float32)
        err = np.abs(fast_sin_np(x) - np.sin(x))
        assert err.max() < 3.5e-3  # parabolic approx + Q14 quantization error bound

    def test_cos_accuracy(self):
        x = np.linspace(-4 * np.pi, 4 * np.pi, 10001).astype(np.float32)
        err = np.abs(fast_cos_np(x) - np.cos(x))
        assert err.max() < 3.5e-3

    def test_jax_matches_numpy_bitexact(self):
        x = np.linspace(-7.0, 7.0, 20011).astype(np.float32)
        j = np.asarray(fast_sin(x))
        n = fast_sin_np(x)
        assert (j == n).all()
        jc = np.asarray(fast_cos(x))
        nc = fast_cos_np(x)
        assert (jc == nc).all()

    def test_quantized_output_grid(self):
        # Outputs live on the Q14 grid.
        x = np.linspace(-3.0, 3.0, 999).astype(np.float32)
        v = fast_sin_np(x) * 16384.0
        assert np.allclose(v, np.round(v))


class TestLoops:
    def test_loop_gains_formula(self):
        # pll.c:132-140 with damp=1/sqrt(2), bw=0.01
        a, b = loop_gains(1 / np.sqrt(2), 0.01)
        damp, bw = 1 / np.sqrt(2), 0.01
        denom = 1 + 2 * damp * bw + bw * bw
        assert abs(a - 4 * damp * bw / denom) < 1e-7
        assert abs(b - 4 * bw * bw / denom) < 1e-9

    def test_lut_tanh_truncation_semantics(self):
        # (int)val truncates toward zero (pll.c:157).
        cases = [(0.9, np.tanh(0.0)), (-0.9, np.tanh(0.0)),
                 (1.5, np.tanh(1.0)), (-1.5, np.tanh(-1.0)),
                 (15.2, 1.0), (16.0, 1.0), (200.0, 1.0),
                 (-16.0, np.tanh(-16.0)), (-16.5, -1.0), (-200.0, -1.0)]
        for v, expect in cases:
            got = lut_tanh_np(np.float32(v))
            assert abs(got - np.float32(expect)) < 2e-7, (v, got, expect)

    def test_lut_tanh_jax_matches_numpy(self):
        v = np.linspace(-40, 40, 4001).astype(np.float32)
        assert (np.asarray(lut_tanh(v)) == lut_tanh_np(v)).all()

    def test_tanh_table_matches_c_construction(self):
        for i in range(32):
            assert TANH_TABLE[i] == np.float32(np.tanh(float(i - 16)))

    def test_mm_error_sgn_zero_is_positive(self):
        # utils.h:26: sgn(0) = +1
        assert mm_error_np(np.float32(0.0), np.float32(2.0)) == np.float32(2.0)
        assert mm_error_np(np.float32(-1.0), np.float32(2.0)) == np.float32(-1.0)


class TestClosedFormGate:
    """Edge cases of the closed-form timing gate (demod/scalar.py)."""

    def _ks(self, K=32):
        return np.arange(1, K + 1, dtype=np.float32)

    def test_fires_next_tick_when_past_threshold(self):
        from meteor_demod_tpu.demod.scalar import gate_fire_np
        # tp already beyond threshold (retime overshoot): fires on tick 1.
        fired, k = gate_fire_np(np.float32(7.0), np.float32(0.39),
                                np.float32(2 * np.pi), 1000, self._ks())
        assert fired and k == 1

    def test_nominal_symbol_period(self):
        from meteor_demod_tpu.demod.scalar import gate_fire_np
        tf = np.float32(2 * np.pi / 16)
        fired, k = gate_fire_np(np.float32(0.0), tf, np.float32(2 * np.pi),
                                1000, self._ks())
        assert fired and k == 16

    def test_block_exhaustion_consumes_remainder(self):
        from meteor_demod_tpu.demod.scalar import gate_fire_np
        tf = np.float32(2 * np.pi / 16)
        fired, k = gate_fire_np(np.float32(0.0), tf, np.float32(2 * np.pi),
                                5, self._ks())
        assert not fired and k == 5

    def test_stall_consumes_K_and_continues(self):
        from meteor_demod_tpu.demod.scalar import gate_fire_np
        # Gap larger than K candidates: consume K, no fire (next step
        # continues) — mirrors the scan/kernel continuation semantics.
        tf = np.float32(0.05)
        fired, k = gate_fire_np(np.float32(0.0), tf, np.float32(2 * np.pi),
                                1000, self._ks())
        assert not fired and k == 32


class TestLockedGeometry:
    """Static invariants of the LOCKED window geometry
    (config.window_locked_asym / locked_pair_slices) across the supported
    configuration space — a violating combination would mis-slice a
    window silently rather than fail loudly."""

    def _grid(self):
        from meteor_demod_tpu.config import DemodConfig
        for sr, symr in [(230400, 72000.0), (230400, 80000.0),
                         (140000, 72000.0), (300000, 80000.0),
                         (2048000, 80000.0), (1024000, 72000.0),
                         (512000, 80000.0), (230400, 66000.0)]:
            for interp in (4, 5, 10):
                for order in (32, 64):
                    for oq in (False, True):
                        yield DemodConfig(samplerate=sr, symrate=symr,
                                          interp=interp, rrc_order=order,
                                          oqpsk=oq, block_len=8192)

    def test_asym_window_bounds(self):
        for cfg in self._grid():
            W = cfg.window_locked_asym
            assert W % 8 == 0 and 0 < W <= cfg.window_common
            # Low anchor + one-sided tau0 coverage must fit the width.
            import math
            need = (2 * cfg.window_delta_locked
                    + int(math.ceil(cfg.ticks_per_fire)) + 1
                    + cfg._pair_extra)
            assert W >= need

    def test_gate_spec_bounds_cover_inenvelope_fires(self):
        """config.gate_spec_bounds must cover every fire an in-envelope
        stream can produce: k* = min{k: fl(k*tf) >= fl(fs - tp)} with
        |tp| <= locked_jitter_rad and tf within the M&M clamp. Checked
        numerically at the extremes for every grid config and both
        envelope tiers (a candidate outside the bound only costs a flag,
        but INSIDE-envelope fires outside it would flag steady-state
        serving traffic — the boundary this pins)."""
        import numpy as np
        for base in self._grid():
            for cfg in (base, base.serving()):
                k0s, Ks = cfg.gate_spec_bounds
                K = cfg.gate_candidates
                assert 0 <= k0s and 0 < Ks and k0s + Ks <= K
                jr = cfg.locked_jitter_rad
                fs = np.float32(cfg.fire_spacing)
                for tp in (-jr, 0.0, jr):
                    for dev in (-1.0, 0.0, 1.0):
                        tf = np.float32(float(cfg.timing_freq)
                                        * (1 + dev * 2.0 ** -12))
                        diff = np.float32(fs - np.float32(tp))
                        k = np.arange(1, K + 1, dtype=np.float32)
                        fired = (k * tf).astype(np.float32) >= diff
                        assert fired.any()
                        kstar = int(np.argmax(fired)) + 1  # 1-based
                        assert k0s + 1 <= kstar <= k0s + Ks, (
                            cfg.symrate, cfg.interp, cfg.oqpsk, jr,
                            tp, dev, kstar, (k0s, Ks))

    def test_pargate_bounds_cover_inenvelope_fires(self):
        """config.pargate_bounds must cover every transaction-A fire
        candidate INDEX an in-envelope OQPSK stream can resolve: kA is
        0-based (tick count = kA + 1), so the exact lower bound for tick
        count x = (fs - jr)/tf_max is ceil(x) - 1 as an index — the r4
        advisor found floor(x) lands one too high when x is integral,
        tripping par_oob -> FLAG_WINDOW_MISS on clean traffic. Checked
        numerically at the envelope extremes for every OQPSK grid config
        and both envelope tiers."""
        import numpy as np
        for base in self._grid():
            for cfg in (base, base.serving()):
                pb = cfg.pargate_bounds
                if not cfg.oqpsk:
                    assert pb is None
                    continue
                k_loA, KA = pb
                K = cfg.gate_candidates
                assert 0 <= k_loA and 0 < KA and k_loA + KA <= K
                jr = cfg.locked_jitter_rad
                fs = np.float32(cfg.fire_spacing)
                for tp in (-jr, 0.0, jr):
                    for dev in (-1.0, 0.0, 1.0):
                        tf = np.float32(float(cfg.timing_freq)
                                        * (1 + dev * 2.0 ** -12))
                        diff = np.float32(fs - np.float32(tp))
                        k = np.arange(1, K + 1, dtype=np.float32)
                        fired = (k * tf).astype(np.float32) >= diff
                        assert fired.any()
                        kA = int(np.argmax(fired))     # 0-based index
                        assert k_loA <= kA < k_loA + KA, (
                            cfg.symrate, cfg.interp, jr, tp, dev,
                            kA, (k_loA, KA))

    def test_pair_slices_within_window(self):
        for cfg in self._grid():
            sl = cfg.locked_pair_slices
            if not cfg.oqpsk:
                assert sl is None
                continue
            W = cfg.window_locked_asym
            oA, WA, oB, WB = sl
            assert oA % 8 == 0 and oB % 8 == 0
            assert WA % 8 == 0 and WB % 8 == 0
            assert 0 <= oA and oA + WA <= W and WA > 0
            assert 0 <= oB <= W - WB and WB > 0
            # The Q slice sits at or above the I slice (the Q fire lands
            # ticks_per_fire later).
            assert oB >= oA
