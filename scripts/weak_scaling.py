"""Weak-scaling harness: fixed per-device fleet load vs device count.

BASELINE.md target: >=80% weak-scaling efficiency at >=2 hosts — the
scale-out answer to running N copies of the reference binary on N cores
(/root/reference/main.c:284-329). Three modes:

- `--mode pinned` (default): the honest dev-box measurement. Each "host"
  is a separate PROCESS pinned to its own DISJOINT physical cores (via
  sched_setaffinity), with ONE CPU device per process. Baseline: 1 process
  on cores {0..cpg-1}. Scaled: 2 processes in a real jax.distributed
  rendezvous (Gloo — the DCN analogue), process i on its own cpg cores,
  running one global MultiHostFleet whose only collective is the scalar
  telemetry psum. Per-device resources are constant by construction, so
  per-device throughput ratio IS weak-scaling efficiency.

- `--mode overhead`: per-block decomposition on one device — the fleet
  step (shard_map + psum telemetry + sharded I/O) vs the same batch demod
  without any of it. The difference bounds the per-block cost of
  everything weak scaling can lose to; the collective payload is a handful
  of scalars, so the bound is device-count-independent (psum latency grows
  ~log N at us scale against ms-scale blocks).

- `--mode virtual`: the old all-virtual-devices sweep (devices SHARE the
  host's cores — measures core contention, not the design; kept for
  comparison and for running on a real pod slice with --no-force).

Usage:
  python scripts/weak_scaling.py [--mode pinned|overhead|virtual]
      [--spd 8] [--block 4096] [--steps 4] [--devices 1,2,4,8] [--no-force]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _stream_fixture(cfg, g):
    from meteor_demod_tpu.sim import synth_psk
    x, _ = synth_psk(int(cfg.block_len / cfg.osf) + 64, cfg.samplerate,
                     carrier_hz=40.0 + 7.0 * g, amplitude=6000.0,
                     snr_db=22.0, seed=700 + g)
    return x[:cfg.block_len]


# ---------------------------------------------------------------------------
# Worker: one pinned process (invoked via --worker; not a user entry point).
# ---------------------------------------------------------------------------

def _worker(argv) -> None:
    (pid, nprocs, port, spd, block, steps, core0, ncores, tel_every,
     out) = argv
    pid, nprocs, spd, block, steps, core0, ncores, tel_every = map(
        int, (pid, nprocs, spd, block, steps, core0, ncores, tel_every))
    # Pin BEFORE jax initializes any thread pools: every thread this
    # process ever creates inherits the affinity mask, so the process can
    # use exactly its own cores no matter how many threads XLA spawns.
    os.sched_setaffinity(0, range(core0, core0 + ncores))
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from meteor_demod_tpu.config import DemodConfig

    cfg = DemodConfig(samplerate=230400, block_len=block)
    # The SAME MultiHostFleet code path at every process count — the 1 vs 2
    # ratio then isolates exactly what scaling adds (the Gloo/DCN psum and
    # the lockstep barrier), not incidental API differences.
    from meteor_demod_tpu.parallel.multihost import (MultiHostFleet,
                                                     init_distributed)
    if nprocs > 1:
        init_distributed(coordinator_address=f"localhost:{port}",
                         num_processes=nprocs, process_id=pid)
    fleet = MultiHostFleet(cfg, streams_per_device=spd,
                           telemetry_every=tel_every)
    sl = fleet.local_stream_slice()
    rows = np.stack([_stream_fixture(cfg, g)
                     for g in range(sl.start, sl.stop)])
    run = lambda: fleet.process_local_blocks(rows)

    # Warm until the fleet LOCKS so every timed step runs the same
    # steady-state regime in every process (mixing acquisition and
    # steady-state blocks across the baseline/scaled runs would skew the
    # ratio), then one whole telemetry period
    # (compiles the non-tick program). Timed steps cover whole periods,
    # so the mean holds exactly steps/tel_every refresh ticks regardless
    # of phase.
    steps = -(-steps // tel_every) * tel_every
    warm = 0
    while warm < 64 and not (
            fleet.telemetry is not None
            and int(fleet.telemetry["locked_streams"]) == fleet.n_streams):
        run()
        warm += 1
    for _ in range(max(2, tel_every)):
        run()
    t0 = time.perf_counter()
    for _ in range(steps):
        run()
    dt = (time.perf_counter() - t0) / steps   # refresh-tick psum syncs procs
    sps_dev = spd * cfg.block_len / dt
    with open(out, "w") as f:
        json.dump(dict(pid=pid, nprocs=nprocs, step_ms=round(dt * 1e3, 2),
                       msps_per_device=round(sps_dev / 1e6, 3)), f)
    print(f"worker {pid}/{nprocs} cores {core0}..{core0+ncores-1}: "
          f"{sps_dev/1e6:.3f} Msamp/s/device, step {dt*1e3:.1f} ms",
          file=sys.stderr)


def _spawn(args_list, env):
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--worker"] + [str(a) for a in args_list],
                            env=env, stdout=sys.stderr, stderr=sys.stderr)


def run_pinned(args) -> dict:
    """Baseline (1 process, cpg cores) vs 2 pinned processes (cpg cores
    EACH, disjoint) — per-device resources constant, psum rides Gloo."""
    import tempfile
    ncore = len(os.sched_getaffinity(0))
    cpg = max(1, ncore // 2)              # cores per "host"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    tmp = tempfile.mkdtemp(prefix="weakscale_")

    def one(n_procs):
        port = _free_port()
        outs = [os.path.join(tmp, f"p{n_procs}_{i}.json")
                for i in range(n_procs)]
        procs = [_spawn([i, n_procs, port, args.spd, args.block,
                         args.steps, i * cpg, cpg, args.telemetry_every,
                         outs[i]], env)
                 for i in range(n_procs)]
        for p in procs:
            assert p.wait(timeout=900) == 0
        return [json.load(open(o)) for o in outs]

    base = one(1)[0]
    scaled = one(2)
    per_dev = [r["msps_per_device"] for r in scaled]
    eff = round(min(per_dev) / base["msps_per_device"], 3)
    return dict(mode="pinned", host_cores=ncore, cores_per_process=cpg,
                spd=args.spd, block_len=args.block,
                telemetry_every=args.telemetry_every,
                baseline_msps_per_device=base["msps_per_device"],
                scaled_msps_per_device=per_dev,
                efficiency_2proc_vs_1proc=eff)


def run_overhead(args) -> dict:
    """Fleet step vs bare batch demod on ONE device: bounds the per-block
    cost of shard_map + psum + sharded I/O that scaling could lose to."""
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=1")
    import jax
    if not args.no_force:
        jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import jax.numpy as jnp
    from meteor_demod_tpu.config import DemodConfig
    from meteor_demod_tpu.demod.backend import jit_batch_demod
    from meteor_demod_tpu.demod.pipeline import egress
    from meteor_demod_tpu.demod.state import batch_carry
    from meteor_demod_tpu.dsp.fir import iq_to_f32
    from meteor_demod_tpu.parallel.mesh import FleetDemodulator, make_mesh

    cfg = DemodConfig(samplerate=230400, block_len=args.block)
    spd = args.spd
    te = args.telemetry_every
    rows = np.stack([_stream_fixture(cfg, g) for g in range(spd)])

    fleet = FleetDemodulator(cfg, spd, mesh=make_mesh(jax.devices()[:1]),
                             telemetry_every=te)
    # Warm until locked, then one whole period (tick + non-tick
    # programs).
    warm = 0
    while warm < 64 and not (
            fleet.telemetry is not None
            and int(fleet.telemetry["locked_streams"]) == spd):
        fleet.process_blocks(rows)
        warm += 1
    for _ in range(max(1, te)):
        fleet.process_blocks(rows)

    fn = jit_batch_demod(cfg, spd)
    carry = batch_carry(cfg, spd)
    xf = np.ascontiguousarray(iq_to_f32(rows), dtype=np.float32)
    carry, outs = fn(carry, jnp.asarray(xf))
    egress(outs)

    def timed(run, n):
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        return (time.perf_counter() - t0) / n * 1e3

    def plain_step():
        nonlocal carry
        carry, outs = fn(carry, jnp.asarray(xf))
        egress(outs)

    steps = -(-args.steps // te) * te         # whole telemetry periods
    fleet_ms = timed(lambda: fleet.process_blocks(rows), steps)
    plain_ms = timed(plain_step, steps)
    ovh = fleet_ms - plain_ms
    return dict(mode="overhead", spd=spd, block_len=args.block,
                telemetry_every=te,
                fleet_step_ms=round(fleet_ms, 2),
                plain_step_ms=round(plain_ms, 2),
                sharding_overhead_ms=round(ovh, 2),
                overhead_fraction=round(max(0.0, ovh) / fleet_ms, 4),
                efficiency_lower_bound=round(
                    plain_ms / fleet_ms, 3) if ovh > 0 else 1.0)


def run_virtual(args) -> dict:
    """The old sweep: N virtual devices sharing this host's cores."""
    sizes = [int(s) for s in args.devices.split(",")]
    if not args.no_force:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags
                + f" --xla_force_host_platform_device_count={max(sizes)}"
            ).strip()
    import jax
    if not args.no_force:
        jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from meteor_demod_tpu.config import DemodConfig
    from meteor_demod_tpu.parallel.mesh import FleetDemodulator, make_mesh

    cfg = DemodConfig(samplerate=230400, block_len=args.block)
    rows = []
    for k in sizes:
        n = args.spd * k
        blocks = np.stack([_stream_fixture(cfg, g) for g in range(n)])
        fleet = FleetDemodulator(cfg, n, mesh=make_mesh(jax.devices()[:k]))
        fleet.process_blocks(blocks)              # compile + warm
        t0 = time.perf_counter()
        for _ in range(args.steps):
            fleet.process_blocks(blocks)
        dt = (time.perf_counter() - t0) / args.steps
        sps = n * cfg.block_len / dt
        rows.append(dict(devices=k, streams=n,
                         msps_total=round(sps / 1e6, 2),
                         msps_per_device=round(sps / 1e6 / k, 2),
                         step_ms=round(dt * 1e3, 1)))
        print(f"devices={k:2d} streams={n:3d} "
              f"{rows[-1]['msps_total']:8.2f} Msamp/s total  "
              f"{rows[-1]['msps_per_device']:6.2f} /device", file=sys.stderr)
    base_row = min(rows, key=lambda r: r["devices"])
    key = f"efficiency_vs_{base_row['devices']}dev"
    for r in rows:
        r[key] = round(r["msps_per_device"] / base_row["msps_per_device"], 3)
    return dict(mode="virtual", host_cores=len(os.sched_getaffinity(0)),
                forced_virtual_cpu=not args.no_force,
                block_len=args.block, spd=args.spd, rows=rows)


def main() -> None:
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        _worker(sys.argv[2:])
        return
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="pinned",
                    choices=["pinned", "overhead", "virtual"])
    ap.add_argument("--devices", default="1,2,4,8",
                    help="virtual mode: device counts to sweep")
    ap.add_argument("--spd", type=int, default=8,
                    help="streams per device (fixed per-device load)")
    ap.add_argument("--block", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--telemetry-every", type=int, default=1,
                    help="fleet psum every K blocks (the reference polls "
                         "telemetry at the UI refresh interval, "
                         "main.c:231-237 — a 2000 ms batch refresh at "
                         "230 ksps / 8192-sample blocks is K~56); timed "
                         "steps round up to whole periods")
    ap.add_argument("--no-force", action="store_true",
                    help="use real devices instead of a virtual CPU mesh")
    args = ap.parse_args()
    out = {"pinned": run_pinned, "overhead": run_overhead,
           "virtual": run_virtual}[args.mode](args)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
