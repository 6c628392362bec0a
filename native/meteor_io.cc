// Native IO hot paths for meteor_demod_tpu.
//
// The reference implementation's entire I/O path is C (wavfile.c:50-80 sample
// decode; main.c:305-316 soft-symbol quantize + ring buffering). These are
// this framework's equivalents for the host-side runtime: branch-free, SIMD-
// vectorizable inner loops invoked through ctypes (io/native.py), with numpy
// fallbacks when the shared library is unavailable.
//
// Build: make -C native    (produces libmeteor_io.so)

#include <cstddef>
#include <cstdint>
#include <cstring>

extern "C" {

// Interleaved I/Q bytes -> float32 re/im pairs (raw counts, reference
// scaling: wavfile.c:57-73). Returns the number of complex samples written.
// nbytes may include a trailing partial sample, which is dropped.
size_t meteor_decode_iq8(const uint8_t* raw, size_t nbytes, float* out) {
    size_t n = nbytes / 2;
    for (size_t i = 0; i < 2 * n; ++i) {
        out[i] = static_cast<float>(static_cast<int>(raw[i]) - 128);
    }
    return n;
}

size_t meteor_decode_iq16(const uint8_t* raw, size_t nbytes, float* out) {
    size_t n = nbytes / 4;
    const int16_t* w = reinterpret_cast<const int16_t*>(raw);
    for (size_t i = 0; i < 2 * n; ++i) {
        out[i] = static_cast<float>(w[i]);
    }
    return n;
}

size_t meteor_decode_iq32(const uint8_t* raw, size_t nbytes, float* out) {
    size_t n = nbytes / 8;
    std::memcpy(out, raw, 8 * n);
    return n;
}

// Soft symbols -> interleaved int8 bytes (main.c:305-306 semantics:
// component / 2, clamped to +-127, truncated toward zero).
void meteor_quantize_soft(const float* re, const float* im, size_t n,
                          int8_t* out) {
    for (size_t i = 0; i < n; ++i) {
        float r = re[i] * 0.5f;
        float q = im[i] * 0.5f;
        r = r > 127.0f ? 127.0f : (r < -127.0f ? -127.0f : r);
        q = q > 127.0f ? 127.0f : (q < -127.0f ? -127.0f : q);
        out[2 * i] = static_cast<int8_t>(r);        // C truncation toward 0
        out[2 * i + 1] = static_cast<int8_t>(q);
    }
}

}  // extern "C"
