"""Safety-net fallback routing and a pty smoke test of the curses TUI."""

import os
import pty
import re
import select
import struct
import subprocess
import sys
import time

import numpy as np
import pytest

from meteor_demod_tpu.config import DemodConfig
from meteor_demod_tpu.demod import scalar
from meteor_demod_tpu.demod.pipeline import StreamDemodulator
from meteor_demod_tpu.demod.state import FLAG_WINDOW_MISS
from meteor_demod_tpu.sim import synth_psk, write_wav


def test_flagged_block_falls_back_to_oracle():
    """A block whose fast-path result carries a safety flag must be
    recomputed exactly by the scalar oracle, and the stream must continue
    from the oracle's carry."""
    cfg = DemodConfig(samplerate=230400, block_len=2048)
    x, _ = synth_psk(3000, cfg.samplerate, carrier_hz=100.0,
                     amplitude=6000.0, snr_db=22.0, seed=31)
    x = x[:2 * cfg.block_len]

    d = StreamDemodulator(cfg)
    real_fn = d._fn

    def poisoned(carry, block):
        carry, outs = real_fn(carry, block)
        return carry._replace(
            flags=carry.flags | FLAG_WINDOW_MISS), outs

    d._fn = poisoned
    got = np.concatenate([d.process(x), d.finish()])
    assert d.fallback_blocks == 2          # every block flagged -> oracle

    ref, _ = scalar.demod_stream_np(cfg, x)
    assert len(got) == len(ref)
    np.testing.assert_array_equal(got["re"], ref["re"])
    np.testing.assert_array_equal(got["im"], ref["im"])


@pytest.mark.skipif(not hasattr(pty, "openpty"), reason="no pty")
def test_tui_runs_in_pty(tmp_path):
    """Full-process TUI smoke test: runs under a pseudo-terminal, draws the
    interface, completes the file, and exits on a keypress."""
    import fcntl
    import termios

    x, _ = synth_psk(9000, 230400, carrier_hz=200.0, amplitude=6000.0,
                     snr_db=22.0, seed=32)
    wav = str(tmp_path / "t.wav")
    write_wav(wav, x, 230400, 16)
    out = str(tmp_path / "t.s")

    env = dict(os.environ, TERM="xterm-256color",
               JAX_PLATFORMS="cpu")
    master, slave = pty.openpty()
    fcntl.ioctl(slave, termios.TIOCSWINSZ, struct.pack("HHHH", 30, 100, 0, 0))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.Popen(
        [sys.executable, "-m", "meteor_demod_tpu", "-o", out, wav],
        stdin=slave, stdout=slave, stderr=subprocess.DEVNULL,
        env=env, cwd=repo)
    os.close(slave)

    buf = b""
    quit_sent = False
    deadline = time.time() + 240
    while time.time() < deadline and p.poll() is None:
        r, _, _ = select.select([master], [], [], 1.0)
        if r:
            try:
                data = os.read(master, 65536)
            except OSError:
                break
            buf += data
            if b"Press any key to exit" in buf and not quit_sent:
                os.write(master, b"x")
                quit_sent = True
    rc = p.wait(timeout=30)
    os.close(master)

    assert rc == 0, buf[-500:]
    assert b"LRPT Demodulator" in buf          # banner drawn
    assert b"PLL status" in buf                # status pane drawn
    # Pane-for-pane field parity with the reference TUI (tui.c:204-247):
    # "Data in" shows done/total durations as HH:MM:SS plus a percent
    # (tui_update_file_in), "Data out" a humanized byte count with the
    # bare-number <1k case (tui_update_data_out + utils.c humanize).
    assert b"Data in" in buf
    assert b"Data out" in buf
    assert re.search(rb"\d{2}:\d{2}:\d{2}/\d{2}:\d{2}:\d{2}\s*"
                     rb"\(\s*\d+\.\d%\)", buf), buf[-1000:]
    assert re.search(rb"\d+(\.\d+)?\s*[kMGT]?\s*B", buf), buf[-1000:]
    assert os.path.getsize(out) > 0
