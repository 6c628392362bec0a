"""On-card checks (meteor_demod_tpu/checks.py) at test sizes. They run on an
NVIDIA GPU only and skip elsewhere; chip_smoke.py runs the same checks at
full size. On the card:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import pytest

from meteor_demod_tpu import checks
from meteor_demod_tpu.config import DemodConfig

pytestmark = pytest.mark.gpu

CONFIGS = {
    "qpsk": DemodConfig(samplerate=230400, block_len=8192),
    "oqpsk": DemodConfig(samplerate=230400, symrate=80000.0, oqpsk=True,
                         block_len=8192),
    "hifi": DemodConfig(samplerate=230400, rrc_order=64, interp=10,
                        block_len=8192),
}


@pytest.mark.parametrize("mode", ["qpsk", "hifi"])
def test_fir_full_precision_on_card(gpu, mode):
    checks.check_fir(CONFIGS[mode], n_streams=128)


@pytest.mark.parametrize("backend", ["kernel", "scan"])
@pytest.mark.parametrize("mode", ["qpsk", "oqpsk", "hifi"])
def test_recurrence_vs_oracle_on_card(gpu, mode, backend):
    checks.check_recurrence(CONFIGS[mode], backend, n_streams=16)


def test_cli_on_card(gpu, tmp_path):
    checks.check_cli(str(tmp_path), seconds=4.0)


def test_serving_kill_resume_on_card(gpu, tmp_path):
    checks.check_serving(str(tmp_path), n_streams=16, group=8,
                         seconds=2.0, n_distinct=4)


def test_turbo_on_card(gpu):
    checks.check_turbo(parity_seconds=8.0, pass_tiles=4, pass_chunks=64)
