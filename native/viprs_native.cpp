// Native host-side data kernels for viprs_tpu.
//
// The framework's compute path is JAX/XLA/Pallas; this library accelerates
// the *data* path that feeds it: plink BED 2-bit decoding, LD block
// accumulation (X^T X), and int8 quantization of correlation tiles. All entry
// points are exposed C-style for ctypes (viprs_tpu/data/native.py) and have
// NumPy fallbacks, so the library is an optional accelerator.
//
// Build: make -C native   (produces libviprs_native.so)

#include <cstdint>
#include <cmath>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// Decode one variant-major BED row (2-bit codes) into dosages (count of A1).
// codes: 00 -> 2, 10 -> 1, 11 -> 0, 01 -> missing (NaN).
void bed_decode_variant(const uint8_t* row, int64_t stride, int64_t n_samples,
                        double* out) {
    static const double lut[4] = {2.0, std::nan(""), 1.0, 0.0};
    int64_t s = 0;
    for (int64_t b = 0; b < stride && s < n_samples; ++b) {
        uint8_t byte = row[b];
        for (int i = 0; i < 4 && s < n_samples; ++i, ++s) {
            out[s] = lut[(byte >> (2 * i)) & 0x3];
        }
    }
}

// Accumulate R += X^T X for a standardized (n x m) column-major-free (C-order)
// block; caller divides by n afterwards. Parallelized over output rows.
void ld_block_accumulate(const double* X, int64_t n, int64_t m, double* R) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < m; ++i) {
        for (int64_t j = i; j < m; ++j) {
            double acc = 0.0;
            for (int64_t s = 0; s < n; ++s) {
                acc += X[s * m + i] * X[s * m + j];
            }
            R[i * m + j] += acc;
            if (i != j) R[j * m + i] += acc;
        }
    }
}

// Symmetric int8 quantization of correlations in [-1, 1] (scale 1/127).
void quantize_int8(const double* x, int64_t n, int8_t* out) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n; ++i) {
        double v = x[i] * 127.0;
        v = v < -127.0 ? -127.0 : (v > 127.0 ? 127.0 : v);
        out[i] = static_cast<int8_t>(std::nearbyint(v));  // round-half-even, matches np.rint
    }
}

}  // extern "C"
