// q4_1 and q8_0 dequant-matmul: y = x @ dequant(q, scale[, zero]).
//
// Replaces: bigdl_tpu/llm/kernels/int4_matmul.py
//   asym_int4_matmul (pl.pallas_call of _asym_int4_kernel): q4_1,
//     w = q * scale + zero, q a nibble in [0, 15];
//   int8_matmul (pl.pallas_call of _int8_kernel): q8_0, w = q * scale,
//     q an int8 in [-127, 127].
//
// Layout (the JAX package's k-major "TPU layout"): x (M, K) bf16 (the TPU
// kernels' cast point); q4_1: q (K/2, N) uint8, low nibble = row 2i, high
// nibble = row 2i+1; q8_0: q (K, N) int8; scale and zero (K/32, N) f32
// with row stride ``lds`` (N, or 0 for one row shared by every group:
// nn.quantized's per-channel scale, broadcast without a copy); out (M, N)
// bf16 or f32. Any M, any N, K % 32 == 0.
//
// What bounds it on the H100: the BERT linears it serves (M = 1024,
// K, N in {768, 3072}) need 1.2-4.8 GFLOP each against a few MB of
// weights, far above the card's ~295 bf16 FLOP per byte, so the bound is
// the arithmetic. This kernel runs on the CUDA cores (67 TFLOP/s f32),
// not the tensor cores (989 TFLOP/s bf16): it is a correct first kernel,
// not a fast one; wgmma on dequantized tiles is later work.
//
// Simple design:
// - a block computes a 64 x 64 output tile, 256 threads with 4 x 4
//   outputs each, and walks K in 32-row tiles — exactly one quantization
//   group, so each column of a tile has one scale (and one zero);
// - per tile, the x rows are widened from bf16 and the weights
//   dequantized in f32 (the TPU kernel's arithmetic under interpret mode,
//   and the plain version's: s * q, then + zero, each rounded once) into
//   shared memory; neighbouring threads read neighbouring columns, so the
//   weight bytes are read coalesced at any N and any alignment of N;
// - the TPU kernel folded the scale broadcast and the zero point into
//   extra MXU dots (_scale_expand, the z_exp dot); on CUDA cores the
//   dequant is one multiply (and one add) per weight per 64 rows of x;
// - each output element is one thread's f32 sum over k in order 0..K-1:
//   it depends on K only, never on M or on other rows. No split-K, no
//   atomics, no K chunking (_chunk_k was a TPU VMEM limit).

#include "common.cuh"

namespace {

constexpr int BM = 64;                          // rows of x per block
constexpr int BN = 64;                          // columns per block
constexpr int BK = 32;                          // k per tile = one group
constexpr int TM = 4;                           // rows per thread
constexpr int TN = 4;                           // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int XK = 8;                           // bf16 of x per load

enum class Fmt { Q4_1, Q8_0 };

template <Fmt F, typename OutT>
__global__ void __launch_bounds__(THREADS)
lowbit_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                     const uint8_t* __restrict__ q,
                     const float* __restrict__ scale,
                     const float* __restrict__ zero,
                     OutT* __restrict__ out, int M, int K, int N, int lds) {
  __shared__ __align__(16) float xs[BK][BM];
  __shared__ __align__(16) float ws[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // loader roles: x row xr, k offset xk; weight column wc, row slice wr
  const int xr = tid / (BK / XK), xk = (tid % (BK / XK)) * XK;
  const int wc = tid % BN, wr = tid / BN;
  const int xm = m0 + xr, wn = n0 + wc;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: one 16-byte load of 8 bf16 per thread, widened to f32
    float xv[XK];
    if (xm < M) {
      const uint4 raw = __ldg(
          reinterpret_cast<const uint4*>(x + (size_t)xm * K + k0 + xk));
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < XK / 2; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        xv[2 * i] = f.x, xv[2 * i + 1] = f.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < XK; ++i) xv[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < XK; ++i) xs[xk + i][xr] = xv[i];

    // weight tile, dequantized in f32; columns past N are zero
    const int g = k0 / BK;
    const bool live = wn < N;
    const float s = live ? __ldg(scale + (size_t)g * lds + wn) : 0.f;
    if constexpr (F == Fmt::Q8_0) {
      constexpr int R = BK / (THREADS / BN);    // 8 rows per thread
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = wr * R + i;
        const int8_t v =
            live ? (int8_t)__ldg(q + (size_t)(k0 + r) * N + wn) : 0;
        ws[r][wc] = __fmul_rn((float)v, s);
      }
    } else {
      constexpr int R = BK / 2 / (THREADS / BN);  // 4 packed rows
      const float z = live ? __ldg(zero + (size_t)g * lds + wn) : 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int p = wr * R + i;
        const uint32_t b =
            live ? __ldg(q + (size_t)(k0 / 2 + p) * N + wn) : 0u;
        ws[2 * p][wc] = __fadd_rn(__fmul_rn((float)(b & 0xFu), s), z);
        ws[2 * p + 1][wc] = __fadd_rn(__fmul_rn((float)(b >> 4), s), z);
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < N) bigdl::store(out + (size_t)m * N + n, acc[i][j]);
    }
  }
}

template <Fmt F, typename OutT>
int launch(const void* x, const void* q, const void* scale, const void* zero,
           void* out, long long M, long long K, long long N, long long lds,
           void* stream) {
  dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM));
  lowbit_matmul_kernel<F, OutT><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(x),
      reinterpret_cast<const uint8_t*>(q),
      reinterpret_cast<const float*>(scale),
      reinterpret_cast<const float*>(zero), reinterpret_cast<OutT*>(out),
      (int)M, (int)K, (int)N, (int)lds);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes). Preconditions, checked by the Python
// wrappers: K % 32 == 0; x contiguous and 16-byte aligned; q contiguous;
// scale (and zero) with unit column stride and row stride lds (N or 0);
// M, K, N > 0.
extern "C" int asym_int4_matmul_bf16out(const void* x, const void* q,
                                        const void* scale, const void* zero,
                                        void* out, long long M, long long K,
                                        long long N, long long lds,
                                        void* stream) {
  return launch<Fmt::Q4_1, __nv_bfloat16>(x, q, scale, zero, out, M, K, N,
                                          lds, stream);
}

extern "C" int asym_int4_matmul_f32out(const void* x, const void* q,
                                       const void* scale, const void* zero,
                                       void* out, long long M, long long K,
                                       long long N, long long lds,
                                       void* stream) {
  return launch<Fmt::Q4_1, float>(x, q, scale, zero, out, M, K, N, lds,
                                  stream);
}

extern "C" int int8_matmul_bf16out(const void* x, const void* q,
                                   const void* scale, void* out, long long M,
                                   long long K, long long N, long long lds,
                                   void* stream) {
  return launch<Fmt::Q8_0, __nv_bfloat16>(x, q, scale, nullptr, out, M, K,
                                          N, lds, stream);
}

extern "C" int int8_matmul_f32out(const void* x, const void* q,
                                  const void* scale, void* out, long long M,
                                  long long K, long long N, long long lds,
                                  void* stream) {
  return launch<Fmt::Q8_0, float>(x, q, scale, nullptr, out, M, K, N, lds,
                                  stream);
}
