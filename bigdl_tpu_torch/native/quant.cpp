// Native block-quantization kernels (C++ equivalent of the reference's
// llm.cpp quantize tools — the reference ships these as vendored
// llama.cpp-family .so, SURVEY.md §2.2); a copy of the JAX package's
// bigdl_tpu/native/quant.cpp. Host-side only: the card computes with the
// CUDA kernels; this accelerates checkpoint conversion (7B = 226M
// blocks), where the numpy path burns minutes of host time.
//
// Layouts match bigdl_tpu_torch/llm/ggml/quantize.py exactly:
//   q4_0: q uint8 (n, k/2) — low nibble = even-k plane, high = odd-k;
//         scale fp16 (n, k/32)
//   q8_0: q int8 (n, k); scale fp16 (n, k/32)
// Scales are rounded to fp16 BEFORE quantizing (bit-parity with the
// numpy implementation).

#include <cstdint>
#include <cmath>
#include <cfenv>
#include <cstring>

namespace {

constexpr int QK = 32;

// float -> half bits, round-to-nearest-even (matches numpy float16 cast)
inline uint16_t f32_to_f16_bits(float f) {
    uint32_t x;
    std::memcpy(&x, &f, 4);
    uint32_t sign = (x >> 16) & 0x8000u;
    int32_t exp = (int32_t)((x >> 23) & 0xFF) - 127 + 15;
    uint32_t mant = x & 0x7FFFFFu;
    if (((x >> 23) & 0xFF) == 0xFF) {              // inf/nan
        return (uint16_t)(sign | 0x7C00u | (mant ? 0x200u : 0));
    }
    if (exp >= 0x1F) return (uint16_t)(sign | 0x7C00u);   // overflow -> inf
    if (exp <= 0) {                                // subnormal half
        if (exp < -10) return (uint16_t)sign;
        mant |= 0x800000u;
        int shift = 14 - exp;
        uint32_t half_mant = mant >> shift;
        uint32_t rem = mant & ((1u << shift) - 1);
        uint32_t halfway = 1u << (shift - 1);
        if (rem > halfway || (rem == halfway && (half_mant & 1)))
            half_mant++;
        return (uint16_t)(sign | half_mant);
    }
    uint32_t half_mant = mant >> 13;
    uint32_t rem = mant & 0x1FFFu;
    if (rem > 0x1000u || (rem == 0x1000u && (half_mant & 1))) {
        half_mant++;
        if (half_mant == 0x400u) { half_mant = 0; exp++; }
        if (exp >= 0x1F) return (uint16_t)(sign | 0x7C00u);
    }
    return (uint16_t)(sign | ((uint32_t)exp << 10) | half_mant);
}

inline float f16_bits_to_f32(uint16_t h) {
    uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
    uint32_t exp = (h >> 10) & 0x1F;
    uint32_t mant = h & 0x3FFu;
    uint32_t x;
    if (exp == 0) {
        if (mant == 0) { x = sign; }
        else {
            // subnormal: normalize
            int e = -1;
            do { mant <<= 1; e++; } while (!(mant & 0x400u));
            mant &= 0x3FFu;
            x = sign | ((uint32_t)(127 - 15 - e) << 23) | (mant << 13);
        }
    } else if (exp == 0x1F) {
        x = sign | 0x7F800000u | (mant << 13);
    } else {
        x = sign | ((exp - 15 + 127) << 23) | (mant << 13);
    }
    float f;
    std::memcpy(&f, &x, 4);
    return f;
}

inline int8_t clampi(float v, int lo, int hi) {
    // nearbyint under the default FE rounding mode = round-half-to-even,
    // bit-matching numpy's np.round on the tie values
    int r = (int)std::nearbyint(v);
    if (r < lo) r = lo;
    if (r > hi) r = hi;
    return (int8_t)r;
}

}  // namespace

extern "C" {

// w: (n, k) fp32 row-major; q: (n, k/2) uint8; scale: (n, k/32) fp16 bits
void quantize_q4_0(const float* w, int64_t n, int64_t k,
                   uint8_t* q, uint16_t* scale) {
    const int64_t nb = k / QK;
    #pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < n; ++r) {
        const float* row = w + r * k;
        uint8_t* qrow = q + r * (k / 2);
        uint16_t* srow = scale + r * nb;
        for (int64_t b = 0; b < nb; ++b) {
            const float* blk = row + b * QK;
            float amax = 0.f;
            for (int i = 0; i < QK; ++i) {
                float a = std::fabs(blk[i]);
                if (a > amax) amax = a;
            }
            uint16_t sh = f32_to_f16_bits(amax / 7.0f);
            srow[b] = sh;
            float s = f16_bits_to_f32(sh);
            // divide (not multiply-by-reciprocal): bit-parity with np.divide
            float div = s > 0.f ? s : 1.0f;
            float z = s > 0.f ? 1.0f : 0.0f;
            uint8_t* qb = qrow + b * (QK / 2);
            for (int i = 0; i < QK / 2; ++i) {
                // plane-split packing: low nibble = even k, high = odd k
                int lo = clampi(blk[2 * i] * z / div, -7, 7) + 8;
                int hi = clampi(blk[2 * i + 1] * z / div, -7, 7) + 8;
                qb[i] = (uint8_t)((lo & 0xF) | (hi << 4));
            }
        }
    }
}

void dequantize_q4_0(const uint8_t* q, const uint16_t* scale,
                     int64_t n, int64_t k, float* w) {
    const int64_t nb = k / QK;
    #pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < n; ++r) {
        const uint8_t* qrow = q + r * (k / 2);
        const uint16_t* srow = scale + r * nb;
        float* row = w + r * k;
        for (int64_t b = 0; b < nb; ++b) {
            float s = f16_bits_to_f32(srow[b]);
            const uint8_t* qb = qrow + b * (QK / 2);
            float* blk = row + b * QK;
            for (int i = 0; i < QK / 2; ++i) {
                blk[2 * i] = ((int)(qb[i] & 0xF) - 8) * s;
                blk[2 * i + 1] = ((int)(qb[i] >> 4) - 8) * s;
            }
        }
    }
}

void quantize_q8_0(const float* w, int64_t n, int64_t k,
                   int8_t* q, uint16_t* scale) {
    const int64_t nb = k / QK;
    #pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < n; ++r) {
        const float* row = w + r * k;
        int8_t* qrow = q + r * k;
        uint16_t* srow = scale + r * nb;
        for (int64_t b = 0; b < nb; ++b) {
            const float* blk = row + b * QK;
            float amax = 0.f;
            for (int i = 0; i < QK; ++i) {
                float a = std::fabs(blk[i]);
                if (a > amax) amax = a;
            }
            uint16_t sh = f32_to_f16_bits(amax / 127.0f);
            srow[b] = sh;
            float s = f16_bits_to_f32(sh);
            // divide (not multiply-by-reciprocal): bit-parity with np.divide
            float div = s > 0.f ? s : 1.0f;
            float z = s > 0.f ? 1.0f : 0.0f;
            int8_t* qb = qrow + b * QK;
            for (int i = 0; i < QK; ++i)
                qb[i] = clampi(blk[i] * z / div, -127, 127);
        }
    }
}

void dequantize_q8_0(const int8_t* q, const uint16_t* scale,
                     int64_t n, int64_t k, float* w) {
    const int64_t nb = k / QK;
    #pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < n; ++r) {
        const int8_t* qrow = q + r * k;
        const uint16_t* srow = scale + r * nb;
        float* row = w + r * k;
        for (int64_t b = 0; b < nb; ++b) {
            float s = f16_bits_to_f32(srow[b]);
            for (int i = 0; i < QK; ++i)
                row[b * QK + i] = qrow[b * QK + i] * s;
        }
    }
}

// reference int4 matvec for host-side validation (y = x @ dequant(W)^T)
void matmul_q4_0(const float* x, const uint8_t* q, const uint16_t* scale,
                 int64_t m, int64_t k, int64_t n, float* y) {
    const int64_t nb = k / QK;
    #pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < n; ++r) {
        const uint8_t* qrow = q + r * (k / 2);
        const uint16_t* srow = scale + r * nb;
        for (int64_t i = 0; i < m; ++i) {
            const float* xi = x + i * k;
            float acc = 0.f;
            for (int64_t b = 0; b < nb; ++b) {
                float s = f16_bits_to_f32(srow[b]);
                const uint8_t* qb = qrow + b * (QK / 2);
                float bacc = 0.f;
                for (int j = 0; j < QK / 2; ++j) {
                    bacc += xi[b * QK + 2 * j] * ((int)(qb[j] & 0xF) - 8);
                    bacc += xi[b * QK + 2 * j + 1] * ((int)(qb[j] >> 4) - 8);
                }
                acc += bacc * s;
            }
            y[i * n + r] = acc;
        }
    }
}

}  // extern "C"
