"""I/O, writer, checkpoint, CLI-parsing, and utils tests (SURVEY.md section 4)."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

from meteor_demod_tpu.cli import Options, parse_args
from meteor_demod_tpu.config import DemodConfig
from meteor_demod_tpu.demod.pipeline import StreamDemodulator
from meteor_demod_tpu.io.checkpoint import load_checkpoint, save_checkpoint
from meteor_demod_tpu.io.wav import (decode_iq, open_input, read_sample_blocks,
                                     wav_parse)
from meteor_demod_tpu.io.writer import SymbolWriter
from meteor_demod_tpu.sim import encode_iq, synth_psk, write_wav
from meteor_demod_tpu.utils import human_to_float, humanize, seconds_to_str


# ---------------------------------------------------------------- wav ingest

def test_wav_parse_roundtrip(tmp_path):
    x = (np.arange(64) + 1j * np.arange(64)).astype(np.complex64)
    p = str(tmp_path / "a.wav")
    write_wav(p, x, 230400, 16)
    with open(p, "rb") as f:
        info = wav_parse(f)
        assert info is not None
        assert info.samplerate == 230400
        assert info.bps == 16
        blocks = list(read_sample_blocks(f, 16, drop_partial_buffer=False))
    got = np.concatenate(blocks)
    np.testing.assert_array_equal(got, x)


def test_wav_parse_rejects_raw():
    assert wav_parse(io.BytesIO(b"\x01\x02" * 100)) is None
    # mono WAV rejected (wavfile.c:42 requires 2 channels)
    import struct
    hdr = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36, b"WAVE", b"fmt ",
                      16, 1, 1, 48000, 96000, 2, 16, b"data", 0)
    assert wav_parse(io.BytesIO(hdr)) is None


@pytest.mark.parametrize("bps", [8, 16, 32])
def test_decode_iq_formats(bps):
    x = (np.array([1.0, -2.0, 100.0]) + 1j * np.array([-1.0, 3.0, -100.0]))
    raw = encode_iq(x.astype(np.complex64), bps)
    got = decode_iq(raw, bps)
    np.testing.assert_allclose(got, x, atol=0.5)


def test_read_sample_blocks_drops_partial_like_reference():
    # 32 KiB = 8192 16-bit IQ pairs; 10000 samples -> one full chunk, the
    # 1808-sample tail dropped (wavfile.c:55 fread semantics).
    x = np.ones(10000, dtype=np.complex64)
    raw = io.BytesIO(encode_iq(x, 16))
    blocks = list(read_sample_blocks(raw, 16))
    assert sum(len(b) for b in blocks) == 8192
    raw.seek(0)
    blocks = list(read_sample_blocks(raw, 16, drop_partial_buffer=False))
    assert sum(len(b) for b in blocks) == 10000


def test_open_input_raw_fallback(tmp_path):
    p = str(tmp_path / "x.raw")
    with open(p, "wb") as f:
        f.write(os.urandom(1000))
    f, info, is_stdin = open_input(p)
    assert info is None and not is_stdin
    assert f.tell() == 0          # rewound for raw processing (main.c:164-166)
    f.close()


# ---------------------------------------------------------------- writer

class _Sink:
    def __init__(self):
        self.data = b""

    def write(self, b):
        self.data += b


def test_writer_lock_gating_and_flush():
    sink = _Sink()
    w = SymbolWriter(sink)
    # 512 symbols pre-lock: ring fills, discarded.
    pre = np.arange(1024, dtype=np.int8)
    w.feed(pre, np.zeros(512, dtype=np.int32))
    assert sink.data == b""
    # 512 symbols post-lock: ring fills, written.
    post = np.arange(1024, dtype=np.int8)
    w.feed(post, np.ones(512, dtype=np.int32))
    assert sink.data == post.tobytes()
    # 10 more symbols then EOF: partial flush, unconditional.
    w.feed(np.ones(20, dtype=np.int8), np.ones(10, dtype=np.int32))
    w.flush_partial()
    assert len(sink.data) == 1024 + 20
    assert w.bytes_out == 1044


# ---------------------------------------------------------------- checkpoint

def test_checkpoint_resume_exact(tmp_path):
    cfg = DemodConfig(samplerate=230400, block_len=2048)
    x, _ = synth_psk(8000, 230400, carrier_hz=200.0, amplitude=6000.0,
                     snr_db=22.0, seed=7)
    x = x[:3 * cfg.block_len + 500]

    d1 = StreamDemodulator(cfg)
    out_full = np.concatenate([d1.process(x), d1.finish()])

    split = cfg.block_len + 123
    d2 = StreamDemodulator(cfg)
    part1 = d2.process(x[:split])
    ckpt = str(tmp_path / "state.npz")
    save_checkpoint(ckpt, d2)
    d3 = load_checkpoint(ckpt)
    assert d3.cfg == cfg
    part2 = np.concatenate([d3.process(x[split:]), d3.finish()])

    got = np.concatenate([part1, part2])
    np.testing.assert_array_equal(got["re"], out_full["re"])
    np.testing.assert_array_equal(got["im"], out_full["im"])
    np.testing.assert_array_equal(got["locked_once"], out_full["locked_once"])


# ---------------------------------------------------------------- CLI parsing

def test_cli_flag_parity():
    o = parse_args(["md", "-B", "-b", "2", "-d", "3.5k", "-f", "64",
                    "-m", "oqpsk", "-o", "out.s", "-O", "10", "-q",
                    "-R", "100", "-r", "80k", "-s", "140k", "--bps", "8",
                    "in.wav"])
    assert isinstance(o, Options)
    assert o.batch and o.quiet and o.oqpsk
    assert o.pll_bw == 2.0
    # Parity quirk: human_to_float truncates through an int (utils.c:62,80),
    # so fractional values below 1 collapse to 0 — in the reference too.
    assert parse_args(["md", "-b", "0.5", "x"]).pll_bw == 0.0
    assert o.rrc_order == 64 and o.interp_factor == 10
    assert o.symrate == 80000.0 and o.samplerate == 140000
    assert o.bps == 8 and o.update_interval == 100
    assert o.output_fname == "out.s"
    # -d 3.5k -> Hz then rad/sym via 2*pi/symrate (main.c:136)
    assert abs(o.freq_max_delta - 3500 * 2 * np.pi / 80000) < 1e-9


def test_cli_stdout_implies_batch_quiet():
    o = parse_args(["md", "--stdout", "in.wav"])
    assert o.stdout_mode and o.batch and o.quiet


def test_cli_unknown_mode_keeps_qpsk():
    o = parse_args(["md", "-m", "qqpsk", "in.wav"])
    assert not o.oqpsk


def test_cli_errors():
    assert parse_args(["md"]) == 1                 # no input file
    assert parse_args(["md", "-h"]) == 0
    assert parse_args(["md", "-v"]) == 0
    assert parse_args(["md", "--bogus", "in.wav"]) == 1


def test_cli_default_refresh():
    assert parse_args(["md", "-B", "x"]).update_interval == 2000
    assert parse_args(["md", "x"]).update_interval == 50


# ---------------------------------------------------------------- utils

def test_human_to_float():
    assert human_to_float("72k") == 72000.0
    assert human_to_float("1.5M") == 1500000.0
    assert human_to_float("140K") == 140000.0
    assert human_to_float("42") == 42.0
    # int-truncation parity quirk (utils.c:84 stores through an int)
    assert human_to_float("1.7") == 1.0


def test_humanize():
    assert humanize(999) == "999  "
    assert humanize(57342) == "57.3 k"
    assert humanize(1500000) == "1.50 M"


def test_seconds_to_str():
    assert seconds_to_str(3661) == "01:01:01"
    assert seconds_to_str(100 * 3600) == "00:00:00"   # utils.c:47 overflow guard


# ---------------------------------------------------------------- end-to-end

def test_cli_end_to_end_stdout(tmp_path):
    """Full CLI process: raw 8-bit stdin -> soft symbols on stdout."""
    x, _ = synth_psk(16000, 230400, carrier_hz=300.0, amplitude=90.0,
                     snr_db=20.0, seed=3)
    raw = encode_iq(x, 8)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "meteor_demod_tpu", "--stdout",
         "-s", "230400", "--bps", "8", "-"],
        input=raw, capture_output=True, timeout=300, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr.decode()[-500:]
    syms = np.frombuffer(proc.stdout, dtype=np.int8)
    assert len(syms) > 2000
    # Locked output: soft magnitudes around AGC target / 2 / 2.
    assert 30 < np.mean(np.abs(syms.astype(np.float32))) < 110


def test_cli_turbo_flag(tmp_path):
    """-T <chunks>: offline chunk-parallel demod through the CLI."""
    x, _ = synth_psk(16000, 230400, carrier_hz=300.0, amplitude=6000.0,
                     snr_db=20.0, seed=4)
    wav = str(tmp_path / "t.wav")
    out = str(tmp_path / "t.s")
    from meteor_demod_tpu.sim import write_wav
    write_wav(wav, x, 230400, 16)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "meteor_demod_tpu", "-B", "-q",
         "-T", "4", "-o", out, wav],
        capture_output=True, timeout=300, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr.decode()[-400:]
    syms = np.fromfile(out, dtype=np.int8)
    assert len(syms) > 2000
    assert parse_args(["md", "-T", "8", "x"]).turbo_chunks == 8
    # -T 0 = auto chunk count; no -T = turbo off.
    assert parse_args(["md", "-T", "0", "x"]).turbo_chunks == 0
    assert parse_args(["md", "x"]).turbo_chunks is None

    out0 = str(tmp_path / "t0.s")
    proc = subprocess.run(
        [sys.executable, "-m", "meteor_demod_tpu", "-B", "-q",
         "-T", "0", "-o", out0, wav],
        capture_output=True, timeout=300, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr.decode()[-400:]
    assert len(np.fromfile(out0, dtype=np.int8)) > 2000


def test_cli_turbo_ingest_parity(tmp_path):
    """-T consumes exactly the bytes -B does (wav_read full-32KiB-buffer
    semantics, wavfile.c:50-80): on a file whose payload is NOT a 32 KiB
    multiple the trailing short read is discarded by BOTH paths, so the
    two modes emit the same number of symbols with identical decisions."""
    x, _ = synth_psk(16000, 230400, carrier_hz=300.0, amplitude=6000.0,
                     snr_db=20.0, seed=4)
    wav = str(tmp_path / "p.wav")
    from meteor_demod_tpu.sim import write_wav
    write_wav(wav, x, 230400, 16)
    # payload = 51200 samples * 4 B = 204800 B = 6.25 x 32768: partial tail.
    assert (os.path.getsize(wav) - 44) % 32768 != 0
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    outs = {}
    for name, extra in (("batch", []), ("turbo", ["-T", "4"])):
        out = str(tmp_path / f"{name}.s")
        proc = subprocess.run(
            [sys.executable, "-m", "meteor_demod_tpu", "-B", "-q",
             *extra, "-o", out, wav],
            capture_output=True, timeout=300, env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        assert proc.returncode == 0, proc.stderr.decode()[-400:]
        outs[name] = np.fromfile(out, dtype=np.int8)
    assert outs["batch"].size == outs["turbo"].size
    # Decision parity: compare the SIGN BIT (v < 0), not np.sign — soft
    # values may differ by loop-noise LSBs on verified-prefix lanes (the
    # documented -T contract), so a 0 vs ±1 pair is the same decision.
    np.testing.assert_array_equal(outs["batch"] < 0, outs["turbo"] < 0)


def test_checkpoint_mid_flight_preserves_symbols(tmp_path):
    """Checkpointing while blocks are still in the dispatch pipeline must not
    lose their symbols: they are persisted as backlog and delivered by the
    resumed demodulator."""
    cfg = DemodConfig(samplerate=230400, block_len=2048)
    x, _ = synth_psk(8000, 230400, carrier_hz=200.0, amplitude=6000.0,
                     snr_db=22.0, seed=8)
    x = x[:3 * cfg.block_len]

    d1 = StreamDemodulator(cfg)
    full = np.concatenate([d1.process(x), d1.finish()])

    d2 = StreamDemodulator(cfg)
    part1 = d2.process(x[:cfg.block_len])          # 1 block, still in flight
    assert len(part1) == 0                         # lookahead > in-flight
    ckpt = str(tmp_path / "c.npz")
    save_checkpoint(ckpt, d2)
    d3 = load_checkpoint(ckpt)
    part2 = np.concatenate([d3.process(x[cfg.block_len:]), d3.finish()])

    got = np.concatenate([part1, part2])
    np.testing.assert_array_equal(got["re"], full["re"])
    np.testing.assert_array_equal(got["im"], full["im"])


def test_cli_degenerate_inputs_exit_clean(tmp_path):
    """Inputs shorter than one block, a WAV truncated mid-sample, and an
    empty stdin stream must all demodulate to an empty (lock-gated) output
    and exit 0 — the reference simply runs out of samples and stops
    (main.c worker loop); no backend dispatch should ever see a
    zero-length or ragged block."""
    from meteor_demod_tpu.sim import write_wav
    x, _ = synth_psk(64, 230400, amplitude=6000.0, snr_db=20.0, seed=1)
    tiny = str(tmp_path / "tiny.wav")
    write_wav(tiny, x[:100], 230400, 16)
    trunc = str(tmp_path / "trunc.wav")
    with open(trunc, "wb") as f:          # header + a partial sample
        f.write(open(tiny, "rb").read()[:51])
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    for src in (tiny, trunc):
        out = str(tmp_path / (os.path.basename(src) + ".s"))
        proc = subprocess.run(
            [sys.executable, "-m", "meteor_demod_tpu", "-B", "-q",
             "-o", out, src],
            capture_output=True, timeout=300, env=env, cwd=cwd)
        assert proc.returncode == 0, proc.stderr.decode()[-400:]
        assert os.path.getsize(out) == 0

    proc = subprocess.run(
        [sys.executable, "-m", "meteor_demod_tpu", "--stdout",
         "-s", "230400", "--bps", "8", "-"],
        input=b"", capture_output=True, timeout=300, env=env, cwd=cwd)
    assert proc.returncode == 0, proc.stderr.decode()[-400:]
    assert proc.stdout == b""


def test_cli_checkpoint_split_capture_bitwise(tmp_path):
    """--checkpoint: split captures demodulate as ONE continuous stream.

    A recording cut into two raw segments run as two CLI invocations
    sharing a checkpoint file; the concatenated .s outputs must be
    DECISION-identical to the single-file run: same symbol count, same
    signs, int8 levels within cross-program loop noise (the segment
    lengths group blocks into different chained-dispatch shapes, the same
    reason -T levels may drift — decisions are the bit-exact contract).
    The cut sits at a 32 KiB chunk
    multiple: the ingest drops partial trailing chunks (reference parity,
    wavfile.c:8,55), so that is the boundary at which a split loses no
    samples — the same rule the reference user already lives by when
    concatenating rtl_sdr segments."""
    x, _ = synth_psk(40000, 230400, carrier_hz=250.0, amplitude=6000.0,
                     snr_db=20.0, seed=7)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    raw_all = str(tmp_path / "all.raw")
    with open(raw_all, "wb") as f:
        f.write(encode_iq(x, 16))
    cut = 6 * 8192                  # a 32 KiB chunk multiple (16-bit)
    seg1, seg2 = str(tmp_path / "a.raw"), str(tmp_path / "b.raw")
    with open(seg1, "wb") as f:
        f.write(encode_iq(x[:cut], 16))
    with open(seg2, "wb") as f:
        f.write(encode_iq(x[cut:], 16))

    def run(inp, out, extra):
        proc = subprocess.run(
            [sys.executable, "-m", "meteor_demod_tpu", "-B", "-q",
             "-s", "230400", "-o", out] + extra + [inp],
            capture_output=True, timeout=300, env=env, cwd=cwd)
        assert proc.returncode == 0, proc.stderr.decode()[-400:]
        return np.fromfile(out, dtype=np.int8)

    ref = run(raw_all, str(tmp_path / "all.s"), [])
    ck = str(tmp_path / "state.ckpt.npz")
    a = run(seg1, str(tmp_path / "a.s"), ["--checkpoint", ck])
    assert os.path.exists(ck)
    b = run(seg2, str(tmp_path / "b.s"), ["--checkpoint", ck])
    got = np.concatenate([a, b])
    assert len(got) == len(ref), (len(got), len(ref))
    np.testing.assert_array_equal(np.sign(got), np.sign(ref))
    assert float(np.abs(got.astype(np.int32)
                        - ref.astype(np.int32)).mean()) < 0.5


def test_cli_checkpoint_rejects_config_mismatch(tmp_path):
    x, _ = synth_psk(8000, 230400, carrier_hz=250.0, amplitude=6000.0,
                     snr_db=20.0, seed=8)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    raw = str(tmp_path / "x.raw")
    with open(raw, "wb") as f:
        f.write(encode_iq(x, 16))
    ck = str(tmp_path / "s.npz")
    proc = subprocess.run(
        [sys.executable, "-m", "meteor_demod_tpu", "-B", "-q",
         "-s", "230400", "-o", str(tmp_path / "x.s"),
         "--checkpoint", ck, raw],
        capture_output=True, timeout=300, env=env, cwd=cwd)
    assert proc.returncode == 0, proc.stderr.decode()[-300:]
    # Different fir order -> refuse to resume.
    proc = subprocess.run(
        [sys.executable, "-m", "meteor_demod_tpu", "-B", "-q",
         "-s", "230400", "-f", "64", "-o", str(tmp_path / "y.s"),
         "--checkpoint", ck, raw],
        capture_output=True, timeout=300, env=env, cwd=cwd)
    assert proc.returncode == 1
    assert b"different configuration" in proc.stderr
    # --checkpoint + -T is refused.
    proc = subprocess.run(
        [sys.executable, "-m", "meteor_demod_tpu", "-B", "-q",
         "-s", "230400", "-T", "4", "-o", str(tmp_path / "z.s"),
         "--checkpoint", str(tmp_path / "t.npz"), raw],
        capture_output=True, timeout=300, env=env, cwd=cwd)
    assert proc.returncode == 1
