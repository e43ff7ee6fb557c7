// q4_0 dequant-matmul on the tensor cores: y = x @ dequant(q, scale),
// w = scale * (q - 8), for the prefill shapes (M >= TC_MIN_M rows, set in
// llm/kernels/int4_matmul.py; smaller M takes csrc/int4_matmul.cu).
//
// Replaces: bigdl_tpu/llm/kernels/int4_matmul.py, int4_matmul
//   (_int4_matmul_jit -> pl.pallas_call of _int4_kernel) at large M.
//
// Layout: the JAX package's k-major layout, as csrc/int4_matmul.cu:
// x (M, K) bf16, q (K/2, N) uint8 (low nibble = row 2i, high = row 2i+1),
// scale (K/32, N) f32, out (M, N) bf16 or f32.
//
// What bounds it on the H100: the arithmetic. 2*M*N*K bf16 operations
// against the weight stream of 0.625 B per weight: at M = 512 that is
// ~1600 operations per byte, far above the ~295 where the tensor cores,
// not the memory, become the limit.
//
// Design (one BM x BN output tile per block, one warpgroup of 128
// threads per 64 rows; K walked in tiles of BK = 64 or 128 columns, two
// or four quantization groups). Three block shapes, picked by the
// wrapper from the shape (tc_block_shape in llm/kernels/int4_matmul.py):
// 128 x 128 for large products, 64 x 64 and 64 x 128 (two blocks a SM)
// so that a small product still spreads over the card:
// - staging: x tiles (BM x BK bf16), the packed q bytes (BK/2 x BN) and
//   the scales (BK/32 x BN f32) of each K tile go into a ring in
//   shared memory by TMA (one thread issues the three copies of a stage
//   and an mbarrier counts their bytes); x lands in the 128-byte swizzled
//   K-major layout `wgmma` reads. Not cp.async: the proxy fence that
//   makes the dequantized tile visible to `wgmma` also waited for every
//   cp.async still in flight, so each K step took a memory latency
//   (measured on the H100, PERF.md); TMA writes through the async proxy
//   and leaves that fence nothing to wait for;
// - dequant: the threads unpack 16-byte chunks of q (16 columns of one
//   packed row), each into two rows of 16 bf16 values (q - 8), exact
//   integers -8..7 (the nibble becomes the bf16 128 + q by a byte
//   permute, then 136 is subtracted), written into a double-buffered B
//   tile (BK x BN bf16) in the 128-byte swizzled MN-major layout (N is
//   contiguous in q, so B is read with the transpose flag);
// - product: `wgmma.m64nBNk16` per warpgroup, both operands from shared
//   memory. Each 32-row quantization group g gives the f32 partial
//   P_g = sum_{k in g} x_k * (q_k - 8), its first k16 step issued with
//   scale-d = 0 (no zeroing); each group of a tile has its own partial
//   fragment, so a group's rescale runs while the later groups' products
//   are in flight; the epilogue of a group is acc = fma(P_g, s[g, n],
//   acc) in f32, the algebra of csrc/int4_matmul.cu. The scale is never
//   folded into bf16 weights: the weights the tensor cores see are exact;
// - overlap: while the tensor cores run tile t, the threads dequantize
//   tile t + 1 into the other B buffer, and TMA brings the next tiles;
// - no split-K: an output element's sum runs over K in one fixed order,
//   whatever M, the other rows or the block shape are (a row gives the
//   same bits in any batch that takes this route). Ragged M and N edges
//   are zero-filled on load and masked on store. Every warpgroup issues
//   every product, also on rows past M and on a K tile's zero-filled
//   groups: a `wgmma` under a branch makes ptxas serialise all of them
//   (its C7520 warning), which costs more than the wasted products. So
//   does reading a partial while a `wgmma` of the next tile is in flight
//   (C7514): every group is rescaled in its own tile.
// Preconditions (checked by the wrapper): N % 16 == 0 (16-byte rows of q
// for TMA), K % 32 == 0, contiguous 16-byte aligned tensors.

#include <cuda.h>

#include "common.cuh"

namespace {

// x is staged in boxes of 64 columns (128 bytes, the swizzle's width)
constexpr int XBOX = 64;
template <int WG, int BN>
struct Tile {
  static constexpr int BM = 64 * WG, THREADS = 128 * WG;
  // K per tile: 64 (two groups), or 128 (four) for 64-column tiles, whose
  // four partial fragments fit the registers and halve the barriers
  static constexpr int BK = BN == 64 ? 128 : 64, G = BK / 32;
  // the TMA ring: 384 columns of K ahead, in 159 / 111 / 96 KiB (128 x
  // 128, 64 x 128, 64 x 64), so 64-row tiles fit two blocks a SM
  static constexpr int STAGES = 384 / BK;
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int Q_BYTES = BK / 2 * BN;
  static constexpr int S_BYTES = G * BN * 4;
  static constexpr int STAGE_BYTES = A_BYTES + Q_BYTES + S_BYTES;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int B_ATOM = BK * 128;   // one 64-column swizzle atom
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * B_BYTES + 1024;
  static constexpr int FRAG = BN / 2;   // f32 of a 64 x BN tile a thread
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// a 2-D tile of ``map`` at (c0 innermost, c1) into shared memory at dst
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
// generic-proxy writes (st.shared) made visible to wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// D (64 x 128 f32, this thread's 64 values) = A * B (+ D if SCALE_D);
// A K-major, B MN-major (transpose flag 1), both bf16 in shared memory
template <int SCALE_D>
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(SCALE_D));
}

// the same for a 64 x 64 tile (32 values a thread)
template <int SCALE_D>
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "n"(SCALE_D));
}

// one thread: TMA of K tile ``kt`` (x, packed q, scales) into the stage
// at ``st``, its bytes counted on the stage's mbarrier ``bar``. Rows and
// columns past the tensors' edges are zero-filled by the copy.
template <class T>
__device__ __forceinline__ void load_stage(uint32_t st, uint32_t bar,
                                           const CUtensorMap* tx,
                                           const CUtensorMap* tq,
                                           const CUtensorMap* ts, int m0,
                                           int n0, int kt) {
  mbar_expect_tx(bar, T::STAGE_BYTES);
#pragma unroll
  for (int h = 0; h < T::BK / XBOX; ++h)
    tma_2d(st + h * T::BM * 128, tx, kt * T::BK + h * XBOX, m0, bar);
  tma_2d(st + T::A_BYTES, tq, n0, kt * T::BK / 2, bar);
  tma_2d(st + T::A_BYTES + T::Q_BYTES, ts, n0, kt * T::G, bar);
}

// (128 + n, 128 + n') as a bf16 pair, minus 136: (n - 8, n' - 8) exactly
__device__ __forceinline__ uint32_t pair_m8(uint32_t nib, uint32_t sel) {
  const uint32_t v = __byte_perm(nib, 0x43434343u, sel);
  __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v);
  b = __hsub2(b, __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&b);
}

// unpack 16 bytes of the packed q of the stage at ``raw`` (packed row r,
// chunk ch of BN / 16) into the B tile at ``b``
template <int BN, int B_ATOM>
__device__ __forceinline__ void dequant_chunk(const uint8_t* raw, uint8_t* b,
                                              int r, int ch) {
  const uint4 v = *reinterpret_cast<const uint4*>(raw + r * BN + ch * 16);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t lo[8], hi[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t l = w[i] & 0x0F0F0F0Fu, h = (w[i] >> 4) & 0x0F0F0F0Fu;
    lo[2 * i] = pair_m8(l, 0x4140);
    lo[2 * i + 1] = pair_m8(l, 0x4342);
    hi[2 * i] = pair_m8(h, 0x4140);
    hi[2 * i + 1] = pair_m8(h, 0x4342);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int nc = ch * 2 + half;          // 8-column chunk of the tile
    uint8_t* atom = b + (nc / 8) * B_ATOM;
#pragma unroll
    for (int e = 0; e < 2; ++e) {          // k-row 2r (low) or 2r+1 (high)
      const int kr = 2 * r + e;
      const uint32_t* src = e ? hi : lo;
      *reinterpret_cast<uint4*>(atom + kr * 128 +
                                (((nc % 8) ^ (kr & 7)) << 4)) =
          make_uint4(src[4 * half], src[4 * half + 1], src[4 * half + 2],
                     src[4 * half + 3]);
    }
  }
}

// the whole stage's q (BK / 2 packed rows x BN / 16 chunks of 16 bytes)
template <class T, int BN>
__device__ __forceinline__ void dequant(const uint8_t* raw, uint8_t* b) {
  constexpr int CH = BN / 16;
#pragma unroll
  for (int c = threadIdx.x; c < T::BK / 2 * CH; c += T::THREADS)
    dequant_chunk<BN, T::B_ATOM>(raw, b, c / CH, c % CH);
}

// acc += s[n] * p, over this thread's fragment (columns 8c + 2(lane%4) + j)
template <int F>
__device__ __forceinline__ void rescale(float (&acc)[F], const float (&p)[F],
                                        const float* s) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int c = 0; c < F / 4; ++c) {
    const float2 s2 =
        *reinterpret_cast<const float2*>(s + 8 * c + 2 * (lane % 4));
    acc[4 * c + 0] = fmaf(p[4 * c + 0], s2.x, acc[4 * c + 0]);
    acc[4 * c + 1] = fmaf(p[4 * c + 1], s2.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(p[4 * c + 2], s2.x, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(p[4 * c + 3], s2.y, acc[4 * c + 3]);
  }
}

// wait for the products of groups g.. of the tile (G - 1 - g commit
// groups may stay in flight) and fold each partial into acc in group
// order; a group past K (zero-filled) is skipped
template <int G, int g = 0, int F>
__device__ __forceinline__ void fold(float (&acc)[F], float (&p)[G][F],
                                     const float* sc, int groups_left) {
  if constexpr (g < G) {
    wgmma_wait<G - 1 - g>();
    if (g < groups_left) rescale(acc, p[g], sc + g * (2 * F));
    fold<G, g + 1>(acc, p, sc, groups_left);
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <int WG, int BN, typename OutT>
__global__ void __launch_bounds__(Tile<WG, BN>::THREADS, 2 / WG)
int4_matmul_tc_kernel(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_s,
                      OutT* __restrict__ out, int M, int K, int N) {
  using T = Tile<WG, BN>;
  constexpr int STAGES = T::STAGES, STAGE_BYTES = T::STAGE_BYTES,
                A_BYTES = T::A_BYTES, B_BYTES = T::B_BYTES, F = T::FRAG;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];   // a stage has landed
  // the swizzled tiles need 1024-byte alignment
  const uint32_t raw_addr = smem_addr(smem_raw);
  const uint32_t pad = (1024u - (raw_addr & 1023u)) & 1023u;
  uint8_t* smem = smem_raw + pad;
  const uint32_t base = raw_addr + pad;
  uint8_t* bbuf = smem + STAGES * STAGE_BYTES;

  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * BN;
  const int wg = threadIdx.x / 128;
  const int KT = (K + T::BK - 1) / T::BK;

  const uint32_t bar0 = smem_addr(full);
  const bool producer = threadIdx.x == 0;

  float acc[F], p[T::G][F];
#pragma unroll
  for (int i = 0; i < F; ++i) acc[i] = 0.f;

  if (producer) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bar0 + 8 * s, 1);
    fence_async_smem();
  }
  __syncthreads();
  if (producer)
    for (int s = 0; s < STAGES && s < KT; ++s)
      load_stage<T>(base + s * STAGE_BYTES, bar0 + 8 * s, &tm_x, &tm_q,
                    &tm_s, m0, n0, s);
  mbar_wait(bar0, 0);
  dequant<T, BN>(smem + A_BYTES, bbuf);
  fence_async_smem();
  __syncthreads();

  for (int kt = 0; kt < KT; ++kt) {
    const int slot = kt % STAGES, buf = kt & 1;
    // this warpgroup's 64 rows of each 64-column box of x
    const uint32_t sa = base + slot * STAGE_BYTES + wg * 64 * 128;
    const uint32_t sb = base + STAGES * STAGE_BYTES + buf * B_BYTES;
    wgmma_fence();
#pragma unroll
    for (int g = 0; g < T::G; ++g) {        // two k16 steps a group
      const int j = 2 * g;
      const uint32_t a0 = sa + (j / 4) * T::BM * 128 + (j % 4) * 32;
      wgmma<0>(p[g], desc(a0, 16, 1024),
               desc(sb + j * 16 * 128, T::B_ATOM, 1024));
      wgmma<1>(p[g], desc(a0 + 32, 16, 1024),
               desc(sb + (j + 1) * 16 * 128, T::B_ATOM, 1024));
      wgmma_commit();
    }
    if (kt + 1 < KT) {
      const int s1 = (kt + 1) % STAGES;
      mbar_wait(bar0 + 8 * s1, ((kt + 1) / STAGES) & 1);
      dequant<T, BN>(smem + s1 * STAGE_BYTES + A_BYTES,
                     bbuf + (buf ^ 1) * B_BYTES);
    }
    // group g's rescale runs while the later groups' products are in
    // flight; groups past K are zero-filled and skipped (block-uniform)
    fold<T::G>(acc, p,
               reinterpret_cast<const float*>(smem + slot * STAGE_BYTES +
                                              A_BYTES + T::Q_BYTES),
               (K - kt * T::BK) / 32);
    fence_async_smem();
    __syncthreads();
    // refill the stage tile kt used: every read of it is complete
    const int nk = kt + STAGES;
    if (producer && nk < KT)
      load_stage<T>(base + (nk % STAGES) * STAGE_BYTES,
                    bar0 + 8 * (nk % STAGES), &tm_x, &tm_q, &tm_s, m0, n0,
                    nk);
  }

  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int c = 0; c < F / 4; ++c) {
    const int n = n0 + 8 * c + 2 * (lane % 4);
    if (n < N) {
      if (r0 < M)
        store2(out + (size_t)r0 * N + n, acc[4 * c], acc[4 * c + 1]);
      if (r0 + 8 < M)
        store2(out + (size_t)(r0 + 8) * N + n, acc[4 * c + 2],
               acc[4 * c + 3]);
    }
  }
}

// cuTensorMapEncodeTiled of libcuda, found through the CUDA runtime (no
// link against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major (outer, inner) tensor read in (box_outer, box_inner) tiles;
// out-of-range elements read as zero
bool tile_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
              long long inner, long long outer, long long row_bytes,
              int box_inner, int box_outer, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t step[2] = {1, 1};
  return encoder()(map, type, 2, const_cast<void*>(base), dims, strides, box,
                   step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// returned when the tensors cannot be described for TMA
constexpr int TENSOR_MAP_FAILED = 10000;

template <int WG, int BN, typename OutT>
int launch(const void* x, const void* q, const void* scale, void* out,
           long long M, long long K, long long N, void* stream) {
  using T = Tile<WG, BN>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        int4_matmul_tc_kernel<WG, BN, OutT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  CUtensorMap tx, tq, ts;
  if (encoder() == nullptr ||
      !tile_map(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, K * 2, XBOX,
                T::BM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tile_map(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, N, K / 2, N, BN,
                T::BK / 2, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !tile_map(&ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scale, N, K / 32, N * 4,
                BN, T::G, CU_TENSOR_MAP_SWIZZLE_NONE))
    return TENSOR_MAP_FAILED;
  dim3 grid((unsigned)((M + T::BM - 1) / T::BM),
            (unsigned)((N + BN - 1) / BN));
  int4_matmul_tc_kernel<WG, BN, OutT>
      <<<grid, T::THREADS, T::SMEM_BYTES, (cudaStream_t)stream>>>(
          tx, tq, ts, reinterpret_cast<OutT*>(out), (int)M, (int)K, (int)N);
  return (int)cudaGetLastError();
}

// the block shape (rows x cols of the output tile) picks the instance
template <typename OutT>
int launch_shape(const void* x, const void* q, const void* scale, void* out,
                 long long M, long long K, long long N, long long rows,
                 long long cols, void* stream) {
  if (rows == 128 && cols == 128)
    return launch<2, 128, OutT>(x, q, scale, out, M, K, N, stream);
  if (rows == 64 && cols == 128)
    return launch<1, 128, OutT>(x, q, scale, out, M, K, N, stream);
  if (rows == 64 && cols == 64)
    return launch<1, 64, OutT>(x, q, scale, out, M, K, N, stream);
  return (int)cudaErrorInvalidValue;
}

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
  return launch_shape<__nv_bfloat16>(x, q, scale, out, M, K, N, rows, cols,
                                     stream);
}

extern "C" int int4_matmul_tc_f32out(const void* x, const void* q,
                                     const void* scale, void* out,
                                     long long M, long long K, long long N,
                                     long long rows, long long cols,
                                     void* stream) {
  return launch_shape<float>(x, q, scale, out, M, K, N, rows, cols, stream);
}
