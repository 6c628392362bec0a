"""Compile-time defaults and loop constants of the LRPT demodulator.

Parity notes: every constant here mirrors a #define in the reference
implementation (cited per line) so that the device pipeline reproduces the
reference's numeric behavior.
"""

# Satellite-specific settings (reference: demod.h:8-9)
RRC_ALPHA = 0.6
SYM_RATE = 72000.0

# Decoder-specific settings (reference: demod.h:12-15)
RRC_ORDER = 32
INTERP_FACTOR = 5
SYM_BW = 0.00005
PLL_BW = 1.0

# Carrier PLL loop constants (reference: pll.c:6-8)
FREQ_MAX_DEFAULT = 0.3      # default max carrier deviation, rad/sample
ERR_POLE = 0.001            # lock-detector EMA pole
DAMP_PLL = 0.7071067811865475  # 1/sqrt(2), critically damped (pll.c:8)
LOCK_THRESH = 85.0          # locked when EMA error drops below (pll.c:118)
UNLOCK_THRESH = 105.0       # unlocked when EMA error rises above (pll.c:121)
ERR_INIT = 1000.0           # initial EMA error (pll.c:36)
SWEEP_STEP = 1e-6           # acquisition sweep step per symbol (pll.c:127)

# Symbol-timing loop constants (reference: timing.c:7, timing.c:26)
FREQ_DEV_EXP = 12           # max timing freq deviation = center / 2**12
DAMP_TIMING = 1.0

# AGC constants (reference: agc.c:5-7)
AGC_TARGET = 190.0
AGC_BIAS_POLE = 0.001
AGC_GAIN_POLE = 0.0001

# Output quantization (reference: main.c:305-306)
SOFT_CLAMP = 127.0
SOFT_SCALE = 0.5            # soft byte = clamp(component / 2, +-127)

# Output ring buffer: 512 symbols = 1024 int8 bytes (reference: main.c:20,34)
RING_SYMBOLS = 512

# Input buffering: the reference reads fixed 32 KiB chunks and drops a
# trailing partial chunk (wavfile.c:8,55)
FILE_BUFFER_SIZE = 32768
