// q4_0 dequant-matmul on the tensor cores: y = x @ dequant(q, scale),
// w = scale * (q - 8), for the prefill shapes (M >= TC_MIN_M rows, set in
// llm/kernels/int4_matmul.py; smaller M takes csrc/lowbit_gemv.cu).
//
// Replaces: bigdl_tpu/llm/kernels/int4_matmul.py, int4_matmul
//   (_int4_matmul_jit -> pl.pallas_call of _int4_kernel) at large M.
//
// Layout: the JAX package's k-major layout, as csrc/lowbit_gemv.cu:
// x (M, K) bf16, q (K/2, N) uint8 (low nibble = row 2i, high = row 2i+1),
// scale (K/32, N) f32, out (M, N) bf16 or f32.
//
// What bounds it on the H100: the arithmetic. 2*M*N*K bf16 operations
// against the weight stream of 0.625 B per weight: at M = 512 that is
// ~1600 operations per byte, far above the ~295 where the tensor cores,
// not the memory, become the limit.
//
// Design: the main loop of csrc/tc_gemm.cuh (TMA ring, dequant into a
// swizzled B tile, `wgmma` per 32-row group with an f32 rescale in group
// order, three block shapes). This file gives it the q4_0 loader: each
// nibble becomes the bf16 128 + q by a byte permute, then 136 is
// subtracted, leaving q - 8 exactly (-8..7).

#include "tc_gemm.cuh"

namespace {

struct Q4_0 {
  static constexpr int K_PER_BYTE = 2;
  static constexpr bool ZERO = false, PER_CHANNEL = false;
  template <int BN, int B_ATOM>
  static __device__ __forceinline__ void dequant_chunk(const uint8_t* raw,
                                                       uint8_t* b, int r,
                                                       int ch) {
    tc::nibble_chunk<136, BN, B_ATOM>(raw, b, r, ch);
  }
};

}  // namespace

// C interface (bound with ctypes). Preconditions, checked by the Python
// wrapper: K % 32 == 0, N % 16 == 0, all tensors contiguous and 16-byte
// aligned, M, K, N > 0; (rows, cols) the block's output tile: 128 x 128,
// 64 x 128 or 64 x 64.
extern "C" int int4_matmul_tc_bf16out(const void* x, const void* q,
                                      const void* scale, void* out,
                                      long long M, long long K, long long N,
                                      long long rows, long long cols,
                                      void* stream) {
  return tc::launch_tile<Q4_0, __nv_bfloat16>(x, q, scale, nullptr, out, M,
                                              K, N, rows, cols, stream);
}

extern "C" int int4_matmul_tc_f32out(const void* x, const void* q,
                                     const void* scale, void* out,
                                     long long M, long long K, long long N,
                                     long long rows, long long cols,
                                     void* stream) {
  return tc::launch_tile<Q4_0, float>(x, q, scale, nullptr, out, M, K, N,
                                      rows, cols, stream);
}
