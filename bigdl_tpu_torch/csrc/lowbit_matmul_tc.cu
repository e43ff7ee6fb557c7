// q4_1 and q8_0 dequant-matmuls on the tensor cores, for M >= TC_MIN_M
// rows and N % 16 == 0 (llm/kernels/int4_matmul.py, matmul_route; the
// other shapes take csrc/lowbit_gemv.cu):
//   q4_1: y = x @ (scale * q + zero), q a nibble in [0, 15];
//   q8_0: y = x @ (scale * q), q an int8 in [-127, 127].
//
// Replaces: bigdl_tpu/llm/kernels/int4_matmul.py
//   asym_int4_matmul (pl.pallas_call of _asym_int4_kernel) and
//   int8_matmul (pl.pallas_call of _int8_kernel), at large M.
//
// Layout (the JAX package's k-major layout): x (M, K) bf16; q4_1: q
// (K/2, N) uint8, low nibble = row 2i, high nibble = row 2i+1; q8_0: q
// (K, N) int8; scale and zero (K/32, N) f32 with row stride ``lds`` (N,
// or 0 for one row shared by every group: nn.quantized's per-channel
// scale, broadcast without a copy); out (M, N) bf16 or f32.
//
// What bounds it on the H100: the arithmetic. The BERT linears it serves
// (M = 1024, K, N in {768, 3072}) need 1.2-4.8 GFLOP each against at
// most 2.4 MB of weights, far above the card's ~295 bf16 operations a
// byte.
//
// Design: the main loop of csrc/tc_gemm.cuh (TMA ring, dequant into a
// swizzled B tile, `wgmma` per 32-row group with an f32 rescale in group
// order, three block shapes), with two loaders:
// - q4_1: the q4_0 nibble unpack without the -8 (bf16 128 + q minus 128:
//   q exactly); the zero plane comes in the same TMA stage as the scales,
//   and the zero point is the TPU kernel's separate dot: each group's row
//   sums X_g of x from a `wgmma` against bf16 ones, so that
//   y = sum_g s_g * (x_g @ q_g) + z_g * X_g, each term in f32;
// - q8_0: the int8 bytes stage as they are (twice q4's bytes a K row;
//   the ring has fewer stages where that would cost a 64-row block its
//   second place on the SM). Each byte becomes an exact bf16 integer: the
//   f32 2^23 + (q ^ 0x80) by a byte permute, minus 2^23 + 128, is q; an
//   integer of at most 8 bits leaves the low 16 bits of its f32 zero, so
//   the f32's high half is that bf16 exactly, and one more permute packs
//   two of them.
// A per-channel scale (lds = 0) cannot be described to TMA with its
// row stride 0: its instance (tc::PerChannel) stages the one row and
// rescales every group with it, so the result is the materialised
// scale's, bit for bit.

#include "tc_gemm.cuh"

namespace {

struct Q4_1 {
  static constexpr int K_PER_BYTE = 2;
  static constexpr bool ZERO = true, PER_CHANNEL = false;
  template <int BN, int B_ATOM>
  static __device__ __forceinline__ void dequant_chunk(const uint8_t* raw,
                                                       uint8_t* b, int r,
                                                       int ch) {
    tc::nibble_chunk<128, BN, B_ATOM>(raw, b, r, ch);
  }
};

// byte ``sel`` of w (already ^ 0x80) as the f32 2^23 + byte, minus
// 2^23 + 128: the signed byte, exactly
__device__ __forceinline__ float byte_f32(uint32_t w, uint32_t sel) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u | sel)) -
         8388736.f;
}

// two such f32 integers as a bf16 pair: their high halves (exact)
__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632u);
}

struct Q8_0 {
  static constexpr int K_PER_BYTE = 1;
  static constexpr bool ZERO = false, PER_CHANNEL = false;
  // 16 int8 of k-row r (columns 16 ch ..) into that row of the B tile
  template <int BN, int B_ATOM>
  static __device__ __forceinline__ void dequant_chunk(const uint8_t* raw,
                                                       uint8_t* b, int r,
                                                       int ch) {
    const uint4 v = *reinterpret_cast<const uint4*>(raw + r * BN + ch * 16);
    const uint32_t w[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u,
                           v.z ^ 0x80808080u, v.w ^ 0x80808080u};
    uint32_t o[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = bf16_pair(byte_f32(w[i], 0), byte_f32(w[i], 1));
      o[2 * i + 1] = bf16_pair(byte_f32(w[i], 2), byte_f32(w[i], 3));
    }
    tc::put_b<B_ATOM>(b, r, 2 * ch, make_uint4(o[0], o[1], o[2], o[3]));
    tc::put_b<B_ATOM>(b, r, 2 * ch + 1, make_uint4(o[4], o[5], o[6], o[7]));
  }
};

}  // namespace

// C interface (bound with ctypes). Preconditions, checked by the Python
// wrappers: K % 32 == 0, N % 16 == 0; x and q contiguous; scale (and
// zero) with unit column stride and row stride lds (N or 0); every
// tensor 16-byte aligned; M, K, N > 0; (rows, cols) the block's output
// tile: 128 x 128, 64 x 128 or 64 x 64.
extern "C" int asym_int4_matmul_tc_bf16out(const void* x, const void* q,
                                           const void* scale,
                                           const void* zero, void* out,
                                           long long M, long long K,
                                           long long N, long long lds,
                                           long long rows, long long cols,
                                           void* stream) {
  return tc::launch_shape<Q4_1, __nv_bfloat16>(x, q, scale, zero, out, M, K,
                                               N, lds, rows, cols, stream);
}

extern "C" int asym_int4_matmul_tc_f32out(const void* x, const void* q,
                                          const void* scale,
                                          const void* zero, void* out,
                                          long long M, long long K,
                                          long long N, long long lds,
                                          long long rows, long long cols,
                                          void* stream) {
  return tc::launch_shape<Q4_1, float>(x, q, scale, zero, out, M, K, N, lds,
                                       rows, cols, stream);
}

extern "C" int int8_matmul_tc_bf16out(const void* x, const void* q,
                                      const void* scale, void* out,
                                      long long M, long long K, long long N,
                                      long long lds, long long rows,
                                      long long cols, void* stream) {
  return tc::launch_shape<Q8_0, __nv_bfloat16>(x, q, scale, nullptr, out, M,
                                               K, N, lds, rows, cols, stream);
}

extern "C" int int8_matmul_tc_f32out(const void* x, const void* q,
                                     const void* scale, void* out,
                                     long long M, long long K, long long N,
                                     long long lds, long long rows,
                                     long long cols, void* stream) {
  return tc::launch_shape<Q8_0, float>(x, q, scale, nullptr, out, M, K, N,
                                       lds, rows, cols, stream);
}
