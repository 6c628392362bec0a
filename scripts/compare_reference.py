"""SNR-sweep parity harness: this framework vs the compiled C reference.

Synthesizes QPSK/OQPSK fixtures across an SNR range, runs both demodulators,
and reports post-lock soft-symbol sign agreement and mean absolute int8
difference per SNR point — the quantitative form of BASELINE.json's
"soft-symbol agreement % vs reference at fixed SNR".

Usage:
    JAX_PLATFORMS=cpu python scripts/compare_reference.py [--oqpsk]

Builds the reference from /root/reference into /tmp/refbuild if needed.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def build_reference() -> str:
    ref_bin = "/tmp/refbuild/meteor_demod"
    if not os.path.exists(ref_bin):
        os.makedirs("/tmp/refbuild", exist_ok=True)
        subprocess.run(["cmake", "-DCMAKE_BUILD_TYPE=Release",
                        "-DENABLE_TUI=OFF", "/root/reference"],
                       cwd="/tmp/refbuild", check=True, capture_output=True)
        subprocess.run(["make", "-j4"], cwd="/tmp/refbuild", check=True,
                       capture_output=True)
    return ref_bin


def score_mod_ambiguity(ref: np.ndarray, ours: np.ndarray,
                        skip_frac: float = 0.2):
    """Score soft-symbol agreement modulo the QPSK 4-fold phase ambiguity.

    A Costas loop may lock at any of 4 carrier rotations (the downstream
    decoder resolves the ambiguity via sync words), so the comparison picks
    the rotation with the best post-lock sign agreement.
    """
    n = min(len(ref), len(ours)) // 2 * 2
    a = (ref[:n:2].astype(np.float32) + 1j * ref[1:n:2].astype(np.float32))
    b = (ours[:n:2].astype(np.float32) + 1j * ours[1:n:2].astype(np.float32))
    s = int(len(a) * skip_frac)
    a, b = a[s:], b[s:]
    best = (0.0, float("inf"), "1")
    for rot, name in ((1, "1"), (1j, "j"), (-1, "-1"), (-1j, "-j")):
        br = b * rot
        agree = float(np.mean(
            (np.sign(a.real) == np.sign(br.real))
            & (np.sign(a.imag) == np.sign(br.imag))))
        mad = float(np.mean(np.abs(a.real - br.real))
                    + np.mean(np.abs(a.imag - br.imag))) / 2
        if agree > best[0]:
            best = (agree, mad, name)
    return best


def run_point(ref_bin: str, snr_db: float, oqpsk: bool, seed: int,
              tmp: str):
    from meteor_demod_tpu.config import DemodConfig
    from meteor_demod_tpu.sim import synth_psk, write_wav
    from tests.test_golden_reference import run_ours, run_ref

    samplerate = 240000 if oqpsk else 230400
    symrate = 80000.0 if oqpsk else 72000.0
    x, _ = synth_psk(36000, samplerate, symrate=symrate, oqpsk=oqpsk,
                     carrier_hz=280.0, amplitude=6000.0, snr_db=snr_db,
                     seed=seed)
    wav = os.path.join(tmp, f"s{snr_db}.wav")
    write_wav(wav, x, samplerate, 16)
    args = (["-m", "oqpsk", "-r", "80k"] if oqpsk else []) + [wav]
    ref = run_ref(ref_bin, args, os.path.join(tmp, "ref.s"))
    ours = run_ours(DemodConfig(samplerate=samplerate, symrate=symrate,
                                oqpsk=oqpsk), wav, 16,
                    os.path.join(tmp, "ours.s"))
    return score_mod_ambiguity(ref, ours)


def main() -> None:
    oqpsk = "--oqpsk" in sys.argv
    ref_bin = build_reference()
    mode = "OQPSK 80k" if oqpsk else "QPSK 72k"
    print(f"# {mode}: post-lock agreement vs reference C binary")
    print(f"{'SNR dB':>7} {'sign agreement':>15} {'mean |diff| LSB':>16}"
          f" {'lock rotation':>14}")
    with tempfile.TemporaryDirectory() as tmp:
        for snr in (6, 9, 12, 15, 20, 30):
            agree, mad, rot = run_point(ref_bin, float(snr), oqpsk,
                                        seed=40 + snr, tmp=tmp)
            print(f"{snr:>7} {agree:>15.4f} {mad:>16.3f} {rot:>14}")


if __name__ == "__main__":
    main()
