// q4_0 dequant-matmul: y = x @ dequant(q, scale), w = scale * (q - 8).
//
// Replaces: bigdl_tpu/llm/kernels/int4_matmul.py, int4_matmul
//   (_int4_matmul_jit -> pl.pallas_call of _int4_kernel).
//
// Layout (the JAX package's k-major "TPU layout", kept as the port's
// public layout): x (M, K) bf16 (the TPU kernel's cast point), q (K/2, N)
// uint8 with the low nibble = row 2i and the high nibble = row 2i+1,
// scale (K/32, N) f32, out (M, N) bf16 or f32, f32 accumulation.
//
// What bounds it on the H100: at decode (M <= 8) the weight stream —
// 0.5 B of nibbles plus 4/32 B of f32 scale = 0.625 B per weight, about
// 4.05 GB per Llama-2-7B decode step, ~1.2 ms at 3.35 TB/s. At prefill
// (M = 128..512) the arithmetic: this kernel runs on the CUDA cores, not
// the tensor cores, so it is far from the bf16 roofline there.
//
// Simple design and what it does about that bound:
// - each thread owns 4 neighbouring output columns and reads their
//   packed bytes with one 32-bit load, so a warp's 8 threads of one
//   packed row read 32 contiguous bytes (the k-major layout makes the
//   weight stream coalesced without any transpose);
// - a block covers 32 columns and splits K over 32 slices (8 threads
//   each); each slice walks whole 32-row scale groups, unpacks each
//   packed row once and applies it to a tile of up to 8 rows of x held
//   in registers, so the weight stream is read once per 8 rows of x;
// - the -8 zero point and the scale are applied per group:
//   acc += s[g] * sum_{k in g} x_k * (q_k - 8); the nibble becomes a
//   float by an exponent trick (no integer-to-float conversion);
// - the 32 slices' partial sums are reduced through shared memory in a
//   fixed order: the summation order of an output element depends on K
//   only, never on M or on other rows (a request served alone gets the
//   same bits as in a batch). No split-K across blocks, no atomics.
// - any N: when N % 4 == 0 a thread's 4 packed bytes and 4 scales are
//   one aligned 32-bit and one 128-bit load; otherwise (BERT's 768->2
//   classifier) the same thread reads them byte by byte and treats the
//   columns past N as zero. The arithmetic, and so every bit of a valid
//   column, is the same on both paths.

#include "common.cuh"

namespace {

constexpr int COLS = 4;               // output columns per thread
constexpr int TN = 32;                // output columns per block
constexpr int TPR = TN / COLS;        // threads across one packed row
constexpr int KS = 32;                // K slices per block
constexpr int THREADS = TPR * KS;     // 256
constexpr int MT = 8;                 // rows of x per block
constexpr int HALF = 16;              // packed rows per 32-wide group

// float(nibble) - 8, exactly: 2^23 + n has n in its low mantissa bits
__device__ __forceinline__ float nib_m8(uint32_t n) {
  return __int_as_float(0x4B000000u | n) - 8388616.0f;
}

// the 4 packed bytes of columns n0..n0+3 (``left`` = N - n0 of them valid)
template <bool VEC>
__device__ __forceinline__ uint32_t load_q(const uint8_t* p, int left) {
  if (VEC) return __ldg(reinterpret_cast<const uint32_t*>(p));
  uint32_t w = 0;
#pragma unroll
  for (int c = 0; c < COLS; ++c)
    if (c < left) w |= (uint32_t)__ldg(p + c) << (8 * c);
  return w;
}

template <bool VEC>
__device__ __forceinline__ void load_s(const float* p, int left,
                                       float s[COLS]) {
  if (VEC) {
    const float4 s4 = __ldg(reinterpret_cast<const float4*>(p));
    s[0] = s4.x, s[1] = s4.y, s[2] = s4.z, s[3] = s4.w;
    return;
  }
#pragma unroll
  for (int c = 0; c < COLS; ++c) s[c] = c < left ? __ldg(p + c) : 0.f;
}

template <typename OutT, bool VEC>
__global__ void __launch_bounds__(THREADS)
int4_matmul_kernel(const __nv_bfloat162* __restrict__ x2,
                   const uint8_t* __restrict__ q,
                   const float* __restrict__ scale,
                   OutT* __restrict__ out, int M, int K, int N) {
  __shared__ float part[KS][MT][TN];
  const int tx = threadIdx.x % TPR;
  const int ks = threadIdx.x / TPR;
  const int n0 = blockIdx.x * TN + tx * COLS;
  const int m0 = blockIdx.y * MT;
  const int mrows = min(MT, M - m0);
  const int groups = K / 32;
  const int half_k = K / 2;

  float acc[MT][COLS];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[m][c] = 0.f;

  if (n0 < N) {
    const int left = N - n0;
    for (int g = ks; g < groups; g += KS) {
      float s[COLS];
      load_s<VEC>(scale + (size_t)g * N + n0, left, s);
      float gacc[MT][COLS];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < COLS; ++c) gacc[m][c] = 0.f;
#pragma unroll 4
      for (int r = 0; r < HALF; ++r) {
        const int row = g * HALF + r;
        const uint32_t w = load_q<VEC>(q + (size_t)row * N + n0, left);
        float lo[COLS], hi[COLS];
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          lo[c] = nib_m8((w >> (8 * c)) & 0xFu);
          hi[c] = nib_m8((w >> (8 * c + 4)) & 0xFu);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m < mrows) {
            const __nv_bfloat162 xp = x2[(size_t)(m0 + m) * half_k + row];
            const float xe = __low2float(xp), xo = __high2float(xp);
#pragma unroll
            for (int c = 0; c < COLS; ++c)
              gacc[m][c] = fmaf(xo, hi[c], fmaf(xe, lo[c], gacc[m][c]));
          }
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < COLS; ++c)
          acc[m][c] = fmaf(gacc[m][c], s[c], acc[m][c]);
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < COLS; ++c) part[ks][m][tx * COLS + c] = acc[m][c];
  __syncthreads();
  for (int e = threadIdx.x; e < MT * TN; e += THREADS) {
    const int m = e / TN, c = e % TN;
    const int n = blockIdx.x * TN + c;
    if (m < mrows && n < N) {
      float v = 0.f;
      for (int k = 0; k < KS; ++k) v += part[k][m][c];
      bigdl::store(out + (size_t)(m0 + m) * N + n, v);
    }
  }
}

template <typename OutT>
int launch(const void* x, const void* q, const void* scale, void* out,
           long long M, long long K, long long N, void* stream) {
  dim3 grid((unsigned)((N + TN - 1) / TN), (unsigned)((M + MT - 1) / MT));
  auto kernel = N % COLS ? int4_matmul_kernel<OutT, false>
                         : int4_matmul_kernel<OutT, true>;
  kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const __nv_bfloat162*>(x),
      reinterpret_cast<const uint8_t*>(q),
      reinterpret_cast<const float*>(scale), reinterpret_cast<OutT*>(out),
      (int)M, (int)K, (int)N);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes). Preconditions, checked by the Python
// wrapper: K % 32 == 0, all tensors contiguous and 16-byte aligned,
// M, K, N > 0.
extern "C" int int4_matmul_bf16out(const void* x, const void* q,
                                   const void* scale, void* out, long long M,
                                   long long K, long long N, void* stream) {
  return launch<__nv_bfloat16>(x, q, scale, out, M, K, N, stream);
}

extern "C" int int4_matmul_f32out(const void* x, const void* q,
                                  const void* scale, void* out, long long M,
                                  long long K, long long N, void* stream) {
  return launch<float>(x, q, scale, out, M, K, N, stream);
}
