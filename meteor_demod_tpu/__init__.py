"""meteor_demod_tpu — an LRPT (Meteor-M2) demodulator for NVIDIA GPUs.

A from-scratch JAX/XLA/Pallas re-design of the classic coherent PSK receive
chain (AGC -> RRC matched filter -> Costas carrier PLL -> Mueller & Muller
symbol timing), with the capabilities of the reference C implementation
(dbdexter-dev/meteor_demod): QPSK 72k and interleaved OQPSK 80k modes, WAV or
raw IQ input from files or stdin, 8-bit soft-symbol output, live telemetry,
batch/TUI frontends — restructured as block-streaming functional kernels that
scale over device meshes.
"""

__version__ = "0.1.0"

from .config import DemodConfig
from .constants import SYM_RATE, RRC_ALPHA, RRC_ORDER, INTERP_FACTOR, PLL_BW, SYM_BW
from .demod.pipeline import StreamDemodulator, demod_array, quantize_symbols
from .demod.turbo import demod_array_turbo

__all__ = [
    "DemodConfig", "StreamDemodulator", "demod_array", "demod_array_turbo",
    "quantize_symbols",
    "SYM_RATE", "RRC_ALPHA", "RRC_ORDER", "INTERP_FACTOR", "PLL_BW", "SYM_BW",
]
