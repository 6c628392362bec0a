"""Smoke test of the demodulator on an NVIDIA GPU.

Drives the main paths once through the entry points a user calls, at real
sizes, and compares each with the repository's reference
(meteor_demod_tpu/checks.py holds every check and its tolerances):

  fir         the FIR at the fleet shape vs fir_reference_np (<= 1e-5)
  recurrence  QPSK, OQPSK and hi-fi, 128 streams x 4 blocks, the chosen
              backend (and the scan beside the kernel) vs the numpy oracle
  cli         `python -m meteor_demod_tpu` on a 16-bit WAV of a LEO pass
              and on 8-bit raw stdin with --stdout
  serving     scripts/serve_fleet.py: 256 streams in 2 groups, a dead
              antenna, checkpoint + kill + resume, byte-identical .s files
  turbo       demod_array_turbo: decision parity with the sequential
              demodulator on 30 s, then a whole ~10-minute pass

    python chip_smoke.py             # one card
    python chip_smoke.py --cards 4   # only the paths that span 4 cards

Each phase prints its samples per second beside the card's name and power
limit. The last line is one JSON object with the device JAX reports. The
script exits non-zero, printing no result, when any phase fails, when JAX
finds no GPU, or when the package is not beside it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback


def _phases(cards: int, workdir: str):
    from meteor_demod_tpu import checks
    from meteor_demod_tpu.config import DemodConfig
    from meteor_demod_tpu.demod.backend import default_backend
    if cards > 1:
        return [(f"multicard/{cards}", lambda: checks.check_multicard(cards))]
    qpsk = DemodConfig(samplerate=230400, block_len=8192)
    configs = {
        "qpsk": qpsk,
        "oqpsk": DemodConfig(samplerate=230400, symrate=80000.0, oqpsk=True,
                             block_len=8192),
        "hifi": DemodConfig(samplerate=230400, rrc_order=64, interp=10,
                            block_len=8192),
    }
    backends = [default_backend()]
    if backends[0] == "kernel":
        backends.append("scan")
    phases = [(f"fir/{n}", lambda c=c: checks.check_fir(c))
              for n, c in configs.items() if n != "oqpsk"]
    phases += [(f"recurrence/{n}/{b}",
                lambda c=c, b=b: checks.check_recurrence(c, b))
               for n, c in configs.items() for b in backends]

    def sub(name):
        path = os.path.join(workdir, name)
        os.makedirs(path, exist_ok=True)
        return path

    phases += [
        ("cli", lambda: checks.check_cli(sub("cli"))),
        ("serving", lambda: checks.check_serving(sub("serving"))),
        ("turbo", lambda: checks.check_turbo()),
    ]
    return phases


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the paths that span four cards")
    args = ap.parse_args(argv)

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import meteor_demod_tpu
    except ImportError:
        print("chip_smoke.py must sit in a meteor_demod_tpu checkout",
              file=sys.stderr)
        return 2
    if os.path.dirname(os.path.dirname(
            os.path.abspath(meteor_demod_tpu.__file__))) != here:
        print("meteor_demod_tpu was imported from outside this checkout",
              file=sys.stderr)
        return 2

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices[0].platform!r}", file=sys.stderr)
        return 1
    if len(devices) < args.cards:
        print(f"{args.cards} cards asked, {len(devices)} found",
              file=sys.stderr)
        return 1
    from meteor_demod_tpu.checks import card_name_power
    from meteor_demod_tpu.demod.backend import default_backend
    from meteor_demod_tpu.utils import enable_compile_cache
    enable_compile_cache()
    smi = card_name_power()
    card = smi.splitlines()[0] if smi else smi
    print(f"card: {smi}", flush=True)
    print(f"device: {devices[0].device_kind} x{len(devices)}; "
          f"recurrence backend: {default_backend()}", flush=True)

    failed = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        for name, fn in _phases(args.cards, workdir):
            t0 = time.perf_counter()
            try:
                r = fn()
            except Exception:                  # noqa: BLE001 - reported
                failed.append(name)
                print(f"phase {name}: FAILED after "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
                traceback.print_exc()
                continue
            dt = time.perf_counter() - t0
            rate = ""
            if r.get("seconds"):
                rate = (f", {r['samples'] / r['seconds'] / 1e6:.1f} "
                        f"Msamples/s")
            print(f"phase {name}: ok in {dt:.1f} s{rate} [{card}] "
                  f"{json.dumps(r, default=float)}", flush=True)
    if failed:
        print(f"failed phases: {', '.join(failed)}", file=sys.stderr)
        return 1
    print(f"card: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
