// Native host-side data-path ops for diga_tpu_torch (the port's own copy
// of native/host_ops.cpp, the same functions).
//
// The input pipeline's per-image hot loops — labelId->trainId remapping,
// BGR/mean/128 normalization, and the eval confusion histogram — run in
// C++ with OpenMP-free simple loops (they're memory-bound; the win over
// numpy is avoiding temporary allocations and extra passes).
//
// Exposed with a plain C ABI for ctypes (no pybind11 in this image).
// Python wrapper: diga_tpu_torch/utils/native.py, which compiles this file
// with g++ at first use and keeps the numpy forms as the plain versions.

#include <cstdint>
#include <cstddef>

extern "C" {

// labelId -> trainId via 256-entry LUT (uint8 labels).
void remap_u8(const uint8_t* in, uint8_t* out, size_t n, const uint8_t* lut) {
    for (size_t i = 0; i < n; ++i) out[i] = lut[in[i]];
}

// labelId -> trainId via LUT for int32 labels (SYNTHIA uint16 ids fit).
void remap_i32(const int32_t* in, uint8_t* out, size_t n,
               const uint8_t* lut, int lut_size) {
    for (size_t i = 0; i < n; ++i) {
        int32_t v = in[i];
        out[i] = (v >= 0 && v < lut_size) ? lut[v] : lut[lut_size - 1];
    }
}

// Fused uint8 RGB HWC -> float32 BGR HWC, mean-subtracted, /128.
// mean is BGR-ordered (3 floats).  One pass, no temporaries.
void normalize_bgr(const uint8_t* rgb, float* out, size_t npix,
                   const float* mean_bgr) {
    const float inv = 1.0f / 128.0f;
    const float m0 = mean_bgr[0], m1 = mean_bgr[1], m2 = mean_bgr[2];
    for (size_t i = 0; i < npix; ++i) {
        const uint8_t* p = rgb + 3 * i;
        float* q = out + 3 * i;
        q[0] = ((float)p[2] - m0) * inv;  // B
        q[1] = ((float)p[1] - m1) * inv;  // G
        q[2] = ((float)p[0] - m2) * inv;  // R
    }
}

// Confusion-matrix accumulation: hist[n_class*gt + pred] += 1 for valid gt.
// (host-side scorer; the device path uses ops/metrics.py)
void fast_hist(const int32_t* gt, const int32_t* pred, size_t n,
               int n_class, int64_t* hist) {
    for (size_t i = 0; i < n; ++i) {
        int32_t g = gt[i];
        if (g >= 0 && g < n_class) {
            int32_t p = pred[i];
            if (p >= 0 && p < n_class) hist[(size_t)n_class * g + p] += 1;
        }
    }
}

// Per-class pixel counts for the rare-class resampling gate
// (GTA5Loader.py:98-106 equivalent): counts has 256 slots.
void label_histogram_u8(const uint8_t* labels, size_t n, int64_t* counts) {
    for (size_t i = 0; i < n; ++i) counts[labels[i]] += 1;
}

}  // extern "C"
