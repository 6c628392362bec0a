"""ServingFleet: tau0-sorted multi-group serving (parallel/serving.py).

The host sorts streams by predicted first-fire tick once the fleet is
locked, so every dispatch group spans a narrow tau0 band. These tests pin
the POLICY on the CPU mesh: sorting happens at the switch, group bands are
achieved and marked, stream identity survives the renumbering, and
outputs are bit-identical to unsorted same-width groups (the step is
lane-permutation invariant, so the policy must be output-neutral)."""

import numpy as np
import pytest

from meteor_demod_tpu.config import DemodConfig
from meteor_demod_tpu.parallel.mesh import FleetDemodulator
from meteor_demod_tpu.parallel.serving import ServingFleet, predict_tau0
from meteor_demod_tpu.sim import synth_psk


@pytest.fixture(scope="module")
def cfg():
    return DemodConfig(samplerate=230400, block_len=2048)


def _clustered_fleet(cfg, n_streams, n_blocks):
    """Streams whose symbol-timing offsets form two tight clusters, so a
    tau0 sort separates them into narrow-band groups."""
    xs = []
    for i in range(n_streams):
        x, _ = synth_psk(
            int(n_blocks * cfg.block_len * cfg.symrate / cfg.samplerate)
            + 64, cfg.samplerate, carrier_hz=70.0 + 9.0 * i,
            amplitude=6000.0, snr_db=22.0, seed=500 + i,
            timing_offset=0.05 * (i % 2 == 0) + 0.55 * (i % 2 == 1)
            + 0.004 * (i // 2))
        xs.append(x[:n_blocks * cfg.block_len])
    return np.stack(xs)


def test_serving_sorts_bands_and_preserves_streams(cfg):
    n_streams, group, n_blocks = 16, 8, 14
    data = _clustered_fleet(cfg, n_streams, n_blocks)

    fleet = ServingFleet(cfg, n_streams, group_size=group, band=8)
    # Unsorted same-width reference groups (initial assignment).
    refs = [FleetDemodulator(cfg, group) for _ in range(2)]

    outs, ref_outs = [], []
    for b in range(n_blocks):
        blk = data[:, b * cfg.block_len:(b + 1) * cfg.block_len]
        outs.append(fleet.process_blocks(blk))
        r = [refs[g].process_blocks(blk[g * group:(g + 1) * group])
             for g in range(2)]
        ref_outs.append(r)

    assert fleet.sorted_once, "fleet never reached the locked switch"
    # Groups achieved their bands and selected the banded program.
    assert fleet.banded_groups() == [0, 1]
    # The renumbering actually separated the timing clusters.
    assign = fleet.assignment()
    for g in range(2):
        members = [s for s in range(n_streams) if assign[s][0] == g]
        carries = fleet.groups[g]
        from meteor_demod_tpu.demod.pipeline import egress
        c = egress(carries.carry)
        tau0 = predict_tau0(cfg, np.asarray(c.t_phase),
                            np.asarray(c.t_freq))
        assert int(tau0.max() - tau0.min()) <= 7, (g, tau0)
        # Clusters are parity classes of the stream index.
        assert len({s % 2 for s in members}) == 1, members

    # Output identity: every stream's rows bit-equal to the unsorted
    # reference groups (lane permutation within the same program width
    # cannot change elementwise results).
    for b in range(n_blocks):
        got = outs[b]
        for name in ("sym_re", "sym_im", "valid", "locked_once"):
            ref_cat = np.concatenate(
                [np.asarray(getattr(ref_outs[b][g], name))
                 for g in range(2)])
            np.testing.assert_array_equal(
                np.asarray(getattr(got, name)), ref_cat,
                err_msg=f"block {b} {name}")


def test_serving_oqpsk_runs_without_banding(cfg):
    ocfg = DemodConfig(samplerate=240000, symrate=80000.0, oqpsk=True,
                       block_len=2048)
    n_streams, group, n_blocks = 16, 8, 4
    xs = []
    for i in range(n_streams):
        x, _ = synth_psk(
            int(n_blocks * ocfg.block_len * ocfg.symrate / ocfg.samplerate)
            + 64, ocfg.samplerate, symrate=ocfg.symrate, oqpsk=True,
            carrier_hz=60.0 + 10.0 * i, amplitude=6000.0, snr_db=22.0,
            seed=600 + i)
        xs.append(x[:n_blocks * ocfg.block_len])
    data = np.stack(xs)
    fleet = ServingFleet(ocfg, n_streams, group_size=group)
    for b in range(n_blocks):
        out = fleet.process_blocks(
            data[:, b * ocfg.block_len:(b + 1) * ocfg.block_len])
    assert not fleet.sorted_once
    assert fleet.banded_groups() == []
    assert np.asarray(out.valid).shape[0] == n_streams


def test_serving_parked_straggler(cfg):
    """A never-locking stream inside a ServingFleet group (r5 review
    findings): it parks onto the host side-path, its group still sorts and
    bands (the straggler's donor-mirrored lane cannot veto the band), live
    streams stay bit-identical to unsorted park-free reference groups, and
    the straggler's host symbols drain through ServingFleet.parked_output
    in CALLER stream identity — including rows accumulated before a
    re-sort renumbered the live streams."""
    n_streams, group, n_blocks, straggler = 16, 8, 20, 5
    data = _clustered_fleet(cfg, n_streams, n_blocks)
    rng = np.random.default_rng(99)
    n = n_blocks * cfg.block_len
    data[straggler] = (500.0 * (rng.standard_normal(n)
                                + 1j * rng.standard_normal(n))
                       ).astype(np.complex64)

    # park_after=8: long enough that the slowest real locker (stream 14,
    # ~8 blocks to lock) is never parked — only the noise stream is.
    fleet = ServingFleet(cfg, n_streams, group_size=group, band=8,
                         park_after=8)
    refs = [FleetDemodulator(cfg, group, park=False) for _ in range(2)]
    outs, ref_outs = [], []
    resorted = False
    for b in range(n_blocks):
        blk = data[:, b * cfg.block_len:(b + 1) * cfg.block_len]
        outs.append(fleet.process_blocks(blk))
        ref_outs.append(
            [refs[g].process_blocks(blk[g * group:(g + 1) * group])
             for g in range(2)])
        # After the first sort, force one re-sort so the deferred-row
        # drain across renumbering is actually exercised.
        if fleet.sorted_once and not resorted:
            fleet._resort_wanted = True
            resorted = True

    g0, lane0 = fleet.assignment()[straggler]
    assert lane0 in fleet.groups[g0]._parked, "straggler never parked"
    assert fleet.sorted_once and resorted
    # The parked lane must not veto ITS group's banding (its donor-mirror
    # tau0 is excluded from the spread). The other group may legitimately
    # miss the band: the pinned parked slot leaves 15 live streams for two
    # 8-wide timing clusters, so one group mixes clusters.
    assert g0 in fleet.banded_groups()

    # Live streams bit-identical to unsorted park-free reference groups.
    others = [s for s in range(n_streams) if s != straggler]
    for b in range(n_blocks):
        got = outs[b]
        for name in ("sym_re", "sym_im", "valid", "locked_once"):
            ref_cat = np.concatenate(
                [np.asarray(getattr(ref_outs[b][g], name))
                 for g in range(2)])
            np.testing.assert_array_equal(
                np.asarray(getattr(got, name))[others], ref_cat[others],
                err_msg=f"block {b} {name}")
        # Parked lane's device output is masked invalid.
        if b == n_blocks - 1:
            assert np.asarray(got.valid)[straggler].sum() == 0

    # Host-path drain in caller identity across the re-sort: the exact
    # B=1 continuation from the carry at parking time.
    import time
    for _ in range(600):
        f = fleet.groups[g0]
        with f._plock:
            done = all(p.blocks_done == p.blocks_fed
                       for p in f._parked.values())
        if done:
            break
        time.sleep(0.05)
    drained = fleet.parked_output(straggler)
    n_parked_blocks = fleet.groups[g0]._parked[lane0].blocks_fed
    first = n_blocks - n_parked_blocks
    from meteor_demod_tpu.demod.backend import jit_batch_demod
    from meteor_demod_tpu.demod.pipeline import egress
    from meteor_demod_tpu.demod.state import DemodCarry
    from meteor_demod_tpu.dsp.fir import iq_to_f32
    # Parking precedes the first sort (the sort waits for all-locked
    # among non-parked), so the carry at park time comes from the INITIAL
    # assignment: straggler 5 was group 0, lane 5.
    chk = FleetDemodulator(cfg, group, park=False)
    for b in range(first):
        chk.process_blocks(
            data[:group, b * cfg.block_len:(b + 1) * cfg.block_len])
    leaves = {k: np.asarray(v)[straggler]
              for k, v in egress(chk.carry)._asdict().items()}
    carry = DemodCarry(**{k: np.asarray(v)[None] for k, v in leaves.items()})
    fn = jit_batch_demod(cfg, 1, "scan")
    ref_rows = {k: [] for k in ("sym_re", "sym_im", "valid", "locked_once")}
    for b in range(first, n_blocks):
        blk = iq_to_f32(data[straggler,
                             b * cfg.block_len:(b + 1) * cfg.block_len])
        carry, o = fn(carry, blk[None])
        for k in ref_rows:
            ref_rows[k].append(np.asarray(getattr(o, k))[0])
    for k in ref_rows:
        np.testing.assert_array_equal(
            drained[k], np.concatenate(ref_rows[k]), err_msg=k)
    # Drained means drained: a second pull returns nothing.
    assert len(fleet.parked_output(straggler)["valid"]) == 0


def test_serving_rejects_bad_shapes(cfg):
    with pytest.raises(ValueError):
        ServingFleet(cfg, 12, group_size=8)
    fleet = ServingFleet(cfg, 16, group_size=8)
    with pytest.raises(ValueError):
        fleet.process_blocks(np.zeros((8, cfg.block_len), np.complex64))
