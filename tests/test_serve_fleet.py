"""End-to-end serving host (scripts/serve_fleet.py) through a subprocess:
kill/resume byte-identity and the chain-mismatch resume guard.

The host's contract (see its module docstring): with stable park
membership, a run killed mid-way and resumed from its checkpoint produces
byte-identical .s files to the uninterrupted run — the fleet state resume
is pinned by tests/test_fleet_checkpoint.py; this test pins the
OPERATIONAL layer on top (writer-ring side file, .s truncation, input
seeks in chain units)."""

import filecmp
import glob
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "serve_fleet.py")


def _run(out_dir, extra, timeout=600):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, SCRIPT, "--synth", "8", "--dead", "1",
         "--seconds", "1.5", "--group-size", "8", "--block-len", "2048",
         "--chain", "2", "--status-every", "1000",
         "--out-dir", out_dir] + extra,
        env=env, capture_output=True, text=True, timeout=timeout)


def test_serve_fleet_kill_resume_byte_identical(tmp_path):
    a_dir, b_dir = str(tmp_path / "a"), str(tmp_path / "b")
    ckpt = str(tmp_path / "ck.npz")

    r = _run(a_dir, [])
    assert r.returncode == 0, r.stderr[-2000:]

    r = _run(b_dir, ["--checkpoint", ckpt, "--checkpoint-every", "10",
                     "--max-blocks", "25"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(ckpt) and os.path.exists(ckpt + ".writers.npz")

    # Wrong --chain on resume: refused loudly BEFORE touching outputs.
    sizes = {f: os.path.getsize(f) for f in glob.glob(b_dir + "/*.s")}
    r = _run(b_dir, ["--checkpoint", ckpt, "--resume", "--chain", "4"])
    assert r.returncode != 0
    assert "--chain" in (r.stderr + r.stdout)
    assert sizes == {f: os.path.getsize(f)
                     for f in glob.glob(b_dir + "/*.s")}

    r = _run(b_dir, ["--checkpoint", ckpt, "--resume"])
    assert r.returncode == 0, r.stderr[-2000:]

    a_files = sorted(glob.glob(a_dir + "/*.s"))
    assert len(a_files) == 8
    for a in a_files:
        b = os.path.join(b_dir, os.path.basename(a))
        assert filecmp.cmp(a, b, shallow=False), os.path.basename(a)
