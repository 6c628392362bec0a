"""Test configuration: the JAX CPU backend with 8 virtual devices, so
mesh/sharding tests run anywhere (SURVEY.md section 4, item 3), unless
JAX_PLATFORMS names another backend (the gpu-marked tests run on the card
with JAX_PLATFORMS=cuda)."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest

from meteor_demod_tpu.config import DemodConfig


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided here, at test
    time, never while a module is imported)."""
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda)")


@pytest.fixture(scope="session")
def qpsk_cfg():
    return DemodConfig(samplerate=230400, block_len=4096)


@pytest.fixture(scope="session")
def oqpsk_cfg():
    return DemodConfig(samplerate=230400, symrate=80000.0, oqpsk=True,
                       block_len=4096)
