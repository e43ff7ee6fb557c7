// Ragged paged-prefill attention on the tensor cores: suffix queries over
// in-place KV pages and their own K/V, bf16 operands, f32 softmax.
//
// Replaces: bigdl_tpu/llm/kernels/ragged_prefill.py,
//   ragged_prefill_attention (pl.pallas_call of _ragged_prefill_kernel),
//   on the bf16 route (``ragged_route`` in llm/kernels/ragged_prefill.py:
//   bf16 q, pools and suffix K/V, D % 16 == 0, D <= 128, a page size that
//   is a multiple of 8). csrc/ragged_prefill.cu keeps every other input.
//
// Contract: that of csrc/ragged_prefill.cu with q (B, Tq, Hq, D) bf16:
// row (b, j) at absolute position offsets[b] + j attends prefix positions
// pos < offset (by block table) and suffix positions offset + local with
// local < seq_len and pos <= qpos, and pos > qpos - window when window >=
// 0, in one online softmax normalised by max(l, 1e-30). Output
// (B, Tq, Hq, D) f32; rows j >= seq_lens[b] are written as 0.
//
// Precision, as the TPU kernel's DEFAULT-precision dots: q, K and V are
// read as bf16 (exact); S = Q K^T accumulates in f32; the softmax state
// (m, l, the rescale) is f32; P is rounded to bf16 for P V, which
// accumulates in f32. l sums the f32 P.
//
// What bounds it on the H100: at the served shapes, neither: a 7B prompt
// of 300 tokens (32 heads, D = 128) moves ~2.6 MB (0.0047 ms at the HBM
// rate; ~0.75 us of bf16 tensor-core work). The time is latency: each
// block walks its key tiles one after another.
//
// Design (one warpgroup of 128 threads a block):
// - a block owns 64 query rows of one (batch row b, kv head h), laid out
//   row = token * g + group as in the TPU kernel, so each K/V tile is read
//   once for the g query heads that share it; grid (B * Hkv,
//   ceil(Tq * g / 64)). A tile wholly past seq_len walks no key tile and
//   writes zeros;
// - Q (64 x D, zero columns up to DP = 64 or 128) is loaded once by the
//   threads into the 128-byte swizzled K-major layout;
// - keys go in tiles of 64, prefix first, then suffix, and a tile never
//   mixes the two. Prefix tiles cover absolute positions [64 i, 64 i + 64)
//   from the window's first key to the offset, as TMA boxes of
//   gcd(page, 64) rows, one box per page chunk through the block table (a
//   chunk at or past the offset re-reads the chunk holding position
//   offset - 1: finite data, masked); suffix tiles cover local positions
//   [64 i, 64 i + 64) up to the tile's last query, one 4-D box of the
//   (B, Tq, Hkv, D) suffix K/V (rows past Tq read as zero). Columns past
//   D read as zero. Tiles above the last query or below the window of
//   the first are never loaded;
// - a ring of 2 K/V stages, filled by one thread's TMA and completed by
//   mbarriers: the next tile loads while this one computes;
// - S = Q K^T is `wgmma.m64n64k16` with K K-major in shared memory; the
//   mask is applied to the scores (prefix: pos < offset; suffix: causal
//   and local < seq_len; both: the window), never as a branch around a
//   product: every `wgmma` runs unconditionally (a `wgmma` under a
//   branch serialises all of them, ptxas C7520). The online softmax runs
//   in the accumulator's registers: a row's max and sum over the quad of
//   threads that holds it. A row with no valid key in a tile keeps its
//   state bit for bit (alpha = 1, p = 0);
// - P V is `wgmma.m64n{DP}k16` with A = P, rounded to bf16, straight from
//   the S accumulator's registers (its layout is the A fragment's), and V
//   MN-major in shared memory (the transpose flag).
// Left for later: a producer warp, ping-pong warpgroups, a persistent
// grid (PERF.md).

#include <limits.h>

#include "tc_gemm.cuh"

namespace {

using tc::desc;

constexpr int BM = 64;         // query rows a block
constexpr int BN = 64;         // keys a tile
constexpr int THREADS = 128;   // one warpgroup
constexpr int STAGES = 2;      // K/V tiles in the ring
constexpr int ROW = 128;       // bytes of a swizzled row (64 bf16)

template <int DP>
struct Layout {
  static constexpr int BOXES = DP / 64;          // 64-column boxes a row
  static constexpr int Q_BYTES = BM * DP * 2;
  static constexpr int KV_BYTES = BN * DP * 2;   // K or V of a tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int SMEM_BYTES = Q_BYTES + STAGES * STAGE_BYTES + 1024;
  static constexpr int S_F = BN / 2;             // f32 of S a thread
  static constexpr int O_F = DP / 2;             // f32 of O a thread
};

// the key tiles of a block: n_pre prefix tiles from absolute tile pre0,
// then n_suf suffix tiles from local tile suf0
struct Walk {
  int n_pre, n_suf, pre0, suf0;
};

struct Maps {
  const CUtensorMap *kp, *vp, *ks, *vs;
};

// one thread: TMA of key tile t (K, then V) into the stage at st
template <int DP>
__device__ __forceinline__ void load_tile(uint32_t st, uint32_t bar, int t,
                                          const Walk& w, const Maps& m,
                                          const int* bt_row, int b, int h,
                                          int off, int page, int box_rows) {
  using L = Layout<DP>;
  tc::mbar_expect_tx(bar, L::STAGE_BYTES);
  if (t < w.n_pre) {
    const int p0 = (w.pre0 + t) * BN;
    for (int r = 0; r < BN; r += box_rows) {
      // a chunk at or past the offset re-reads the one holding off - 1
      const int pos =
          p0 + r < off ? p0 + r : (off - 1) / box_rows * box_rows;
      const int phys = bt_row[pos / page], slot = pos % page;
      for (int x = 0; x < L::BOXES; ++x) {
        const uint32_t o = x * BN * ROW + r * ROW;
        tc::tma_4d(st + o, m.kp, x * 64, slot, h, phys, bar);
        tc::tma_4d(st + L::KV_BYTES + o, m.vp, x * 64, slot, h, phys, bar);
      }
    }
  } else {
    const int s0 = (w.suf0 + t - w.n_pre) * BN;
    for (int x = 0; x < L::BOXES; ++x) {
      tc::tma_4d(st + x * BN * ROW, m.ks, x * 64, h, s0, b, bar);
      tc::tma_4d(st + L::KV_BYTES + x * BN * ROW, m.vs, x * 64, h, s0, b,
                 bar);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 2)
ragged_prefill_tc_kernel(const __grid_constant__ CUtensorMap tm_kp,
                         const __grid_constant__ CUtensorMap tm_vp,
                         const __grid_constant__ CUtensorMap tm_ks,
                         const __grid_constant__ CUtensorMap tm_vs,
                         const __nv_bfloat16* __restrict__ q,
                         const int* __restrict__ bt,
                         const int* __restrict__ offsets,
                         const int* __restrict__ seq_lens,
                         float* __restrict__ out, int Tq, int Hq, int Hkv,
                         int page, int box_rows, int D, int pages_max,
                         int window, float scale) {
  using L = Layout<DP>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];   // a stage has landed
  // the swizzled tiles need 1024-byte alignment
  const uint32_t raw_addr = tc::smem_addr(smem_raw);
  const uint32_t pad = (1024u - (raw_addr & 1023u)) & 1023u;
  uint8_t* smem = smem_raw + pad;
  const uint32_t sq = raw_addr + pad, skv = sq + L::Q_BYTES;
  const uint32_t bar0 = tc::smem_addr(full);

  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv, g = Hq / Hkv;
  const int r0 = blockIdx.y * BM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int off = offsets[b], slen = min(seq_lens[b], Tq);
  const int live = slen * g;                 // rows of live queries
  const Maps maps = {&tm_kp, &tm_vp, &tm_ks, &tm_vs};
  const int* bt_row = bt + (size_t)b * pages_max;

  Walk w = {0, 0, 0, 0};
  if (r0 < live) {
    const int j0 = r0 / g, j1 = (min(r0 + BM, live) - 1) / g;
    const int lo = window >= 0 ? max(0, off + j0 - window + 1) : 0;
    w.pre0 = lo / BN;
    w.n_pre = off > lo ? (off + BN - 1) / BN - w.pre0 : 0;
    w.suf0 = max(0, lo - off) / BN;
    w.n_suf = j1 / BN + 1 - w.suf0;
  }
  const int nt = w.n_pre + w.n_suf;

  // the first key tiles load while the threads stage Q
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) tc::mbar_init(bar0 + 8 * s, 1);
    tc::fence_async_smem();
    for (int t = 0; t < STAGES && t < nt; ++t)
      load_tile<DP>(skv + t * L::STAGE_BYTES, bar0 + 8 * t, t, w, maps,
                    bt_row, b, h, off, page, box_rows);
  }
  // Q: tile row r is token (r0 + r) / g, query head h * g + (r0 + r) % g
  for (int i = tid; i < BM * DP / 8; i += THREADS) {
    const int r = i / (DP / 8), c = i % (DP / 8), row = r0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < Tq * g && c * 8 < D)
      v = *reinterpret_cast<const uint4*>(
          q + (((size_t)b * Tq + row / g) * Hq + h * g + row % g) * D +
          c * 8);
    *reinterpret_cast<uint4*>(smem + (c / 8) * BM * ROW + r * ROW +
                              (((c % 8) ^ (r & 7)) << 4)) = v;
  }
  tc::fence_async_smem();
  __syncthreads();

  // this thread's two rows (lane / 4 of the warp's 16, and + 8)
  int qpos[2], lo_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + warp * 16 + lane / 4 + 8 * i;
    qpos[i] = off + row / g;
    lo_row[i] = window >= 0 ? qpos[i] - window + 1 : INT_MIN;
  }
  float o[L::O_F], m[2] = {bigdl::NEG_BIG, bigdl::NEG_BIG};
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < L::O_F; ++i) o[i] = 0.f;

  for (int t = 0; t < nt; ++t) {
    const int slot = t % STAGES;
    const uint32_t sk = skv + slot * L::STAGE_BYTES, sv = sk + L::KV_BYTES;
    tc::mbar_wait(bar0 + 8 * slot, (t / STAGES) & 1);

    // S = Q K^T, k16 steps over the (padded) head dim
    float s[L::S_F];
    tc::wgmma_fence();
    tc::wgmma<0, 0>(s, desc(sq, 16, 1024), desc(sk, 16, 1024));
#pragma unroll
    for (int kk = 1; kk < DP / 16; ++kk) {
      const uint32_t ko = (kk / 4) * BM * ROW + (kk % 4) * 32;
      tc::wgmma<1, 0>(s, desc(sq + ko, 16, 1024), desc(sk + ko, 16, 1024));
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();

    // mask, then the online softmax in the accumulator layout
    const bool pre = t < w.n_pre;
    const int pos0 = pre ? (w.pre0 + t) * BN
                         : off + (w.suf0 + t - w.n_pre) * BN;
    const int hi = pre ? off : off + slen;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int c = 0; c < BN / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2, pos = pos0 + 8 * c + 2 * (lane % 4) + e % 2;
        const bool ok = pos < hi && pos <= qpos[i] && pos >= lo_row[i];
        s[4 * c + e] = ok ? s[4 * c + e] * scale : -INFINITY;
        mx[i] = fmaxf(mx[i], s[4 * c + e]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(bigdl::FULL_MASK, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(bigdl::FULL_MASK, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
    // P (bf16) as the A fragments of the BN / 16 k16 steps of P V
    uint32_t pa[BN / 16][4];
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      const float p0 = expf(s[4 * c] - m[0]), p1 = expf(s[4 * c + 1] - m[0]);
      const float p2 = expf(s[4 * c + 2] - m[1]);
      const float p3 = expf(s[4 * c + 3] - m[1]);
      ps[0] += p0 + p1;
      ps[1] += p2 + p3;
      pa[c / 2][(c % 2) * 2] = pack_bf16(p0, p1);
      pa[c / 2][(c % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = fmaf(l[i], alpha[i], ps[i]);
#pragma unroll
    for (int c = 0; c < L::O_F / 4; ++c) {
      o[4 * c] *= alpha[0];
      o[4 * c + 1] *= alpha[0];
      o[4 * c + 2] *= alpha[1];
      o[4 * c + 3] *= alpha[1];
    }

    // O += P V, V MN-major: the next 64 columns of V are BN rows further
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      tc::wgmma_rs<1>(o, pa[kk], desc(sv + kk * 16 * ROW, BN * ROW, 1024));
    tc::wgmma_commit();
    tc::wgmma_wait<0>();

    // refill the stage tile t used: every read of it is complete
    __syncthreads();
    if (tid == 0 && t + STAGES < nt)
      load_tile<DP>(sk, bar0 + 8 * slot, t + STAGES, w, maps, bt_row, b, h,
                    off, page, box_rows);
  }

  // l over the quad, then the normalised rows; padding rows are 0
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(bigdl::FULL_MASK, l[i], 1);
    l[i] += __shfl_xor_sync(bigdl::FULL_MASK, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + warp * 16 + lane / 4 + 8 * i;
    if (row >= Tq * g) continue;
    const bool ok = row < live;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* dst =
        out + (((size_t)b * Tq + row / g) * Hq + h * g + row % g) * D;
#pragma unroll
    for (int c = 0; c < L::O_F / 4; ++c) {
      const int col = 8 * c + 2 * (lane % 4);
      if (col < D)
        *reinterpret_cast<float2*>(dst + col) =
            ok ? make_float2(o[4 * c + 2 * i] * inv,
                             o[4 * c + 2 * i + 1] * inv)
               : make_float2(0.f, 0.f);
    }
  }
}

template <int DP>
int launch(const void* q, const void* ks, const void* vs, const void* kp,
           const void* vp, const void* bt, const void* offs, const void* lens,
           void* out, long long B, long long Tq, long long Hq, long long Hkv,
           long long page, long long D, long long pages_max,
           long long num_pages, long long window, float scale,
           void* stream) {
  using L = Layout<DP>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ragged_prefill_tc_kernel<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  // a prefix box: the largest power of two <= 64 that divides the page
  int box_rows = BN;
  while (page % box_rows) box_rows /= 2;
  const cuuint64_t row = (cuuint64_t)D * 2;
  // pools (P, Hkv, page, D) read in (box_rows, 64) boxes of one page
  const cuuint64_t pdims[4] = {(cuuint64_t)D, (cuuint64_t)page,
                               (cuuint64_t)Hkv, (cuuint64_t)num_pages};
  const cuuint64_t pstr[3] = {row, row * page, row * page * Hkv};
  const cuuint32_t pbox[4] = {64, (cuuint32_t)box_rows, 1, 1};
  // suffix K/V (B, Tq, Hkv, D) read in (64 tokens, 64) boxes of one head
  const cuuint64_t sdims[4] = {(cuuint64_t)D, (cuuint64_t)Hkv,
                               (cuuint64_t)Tq, (cuuint64_t)B};
  const cuuint64_t sstr[3] = {row, row * Hkv, row * Hkv * Tq};
  const cuuint32_t sbox[4] = {64, 1, BN, 1};
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr CUtensorMapSwizzle SW = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap tkp, tvp, tks, tvs;
  if (tc::encoder() == nullptr ||
      !tc::tensor_map(&tkp, BF16, 4, kp, pdims, pstr, pbox, SW) ||
      !tc::tensor_map(&tvp, BF16, 4, vp, pdims, pstr, pbox, SW) ||
      !tc::tensor_map(&tks, BF16, 4, ks, sdims, sstr, sbox, SW) ||
      !tc::tensor_map(&tvs, BF16, 4, vs, sdims, sstr, sbox, SW))
    return tc::TENSOR_MAP_FAILED;
  const long long g = Hq / Hkv;
  dim3 grid((unsigned)(B * Hkv), (unsigned)((Tq * g + BM - 1) / BM));
  ragged_prefill_tc_kernel<DP>
      <<<grid, THREADS, L::SMEM_BYTES, (cudaStream_t)stream>>>(
          tkp, tvp, tks, tvs, reinterpret_cast<const __nv_bfloat16*>(q),
          reinterpret_cast<const int*>(bt),
          reinterpret_cast<const int*>(offs),
          reinterpret_cast<const int*>(lens), reinterpret_cast<float*>(out),
          (int)Tq, (int)Hq, (int)Hkv, (int)page, box_rows, (int)D,
          (int)pages_max, (int)window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface. Preconditions, checked by the Python wrapper: q, pools and
// suffix K/V bf16, contiguous and 16-byte aligned; Hq % Hkv == 0; D % 16
// == 0 and D <= 128; page % 8 == 0; num_pages = the pools' first dim;
// B * Hkv > 0 and Tq > 0; block_tables cover positions 0 .. offsets[b];
// window < 0 means no sliding window.
extern "C" int ragged_prefill_tc_bf16(
    const void* q, const void* ks, const void* vs, const void* kp,
    const void* vp, const void* bt, const void* offs, const void* lens,
    void* out, long long B, long long Tq, long long Hq, long long Hkv,
    long long page, long long D, long long pages_max, long long num_pages,
    long long window, float scale, void* stream) {
  if (D <= 64)
    return launch<64>(q, ks, vs, kp, vp, bt, offs, lens, out, B, Tq, Hq, Hkv,
                      page, D, pages_max, num_pages, window, scale, stream);
  return launch<128>(q, ks, vs, kp, vp, bt, offs, lens, out, B, Tq, Hq, Hkv,
                     page, D, pages_max, num_pages, window, scale, stream);
}
