// Ragged paged-prefill attention: suffix queries over in-place KV pages.
//
// Replaces: bigdl_tpu/llm/kernels/ragged_prefill.py,
//   ragged_prefill_attention (pl.pallas_call of _ragged_prefill_kernel).
//
// Contract: q (B, Tq, Hq, D) f32, row (b, j) at absolute position
// offsets[b] + j; k_suf/v_suf (B, Tq, Hkv, D) the suffix's own K/V (not
// yet in the pool) in the pool dtype; pools (P, Hkv, page, D) bf16 or
// f32 (flat L*P view, table pre-offset by l*P); block_tables
// (B, pages_max) int32 covering positions 0 .. offsets[b]; offsets,
// seq_lens (B,) int32. A query attends prefix positions pos < offset (by
// block table) and suffix positions offset + local with
// local < seq_len and pos <= qpos, and pos > qpos - window when
// window >= 0 — one online softmax, normalised by max(l, 1e-30).
// Output (B, Tq, Hq, D) f32. Rows j >= seq_lens[b] are padding: they are
// written as 0 (finite, which is all the callers need; they slice them
// off).
//
// What bounds it on the H100: at the served shapes (one prompt of up to
// a few hundred tokens) neither bytes nor FLOPs are large; the CUDA-core
// dot products dominate (4 * D FLOPs per (query, key) pair).
//
// Simple design and what it does about that bound:
// - one block per (row b, query head, tile of 16 queries); 4 warps own
//   4 queries each; keys are walked in chunks of 32 positions, from the
//   window's first position to the tile's last query position only
//   (causal: nothing above the diagonal is read);
// - a key's position decides its source: below the offset it is read
//   from its physical page through the block table, above it from the
//   dense suffix; the chunk is staged as f32 in shared memory (rows
//   padded by one float so the lane-per-key dot product has no bank
//   conflicts) and shared by the 16 queries of the tile;
// - masked keys and keys past seq_len are skipped, never multiplied by
//   zero — the kernel does not read uninitialised K/V, so it needs no
//   zeroing of dead lanes (the TPU kernel had to), and a chunk with no
//   valid key for a query leaves that query's state untouched;
// - no padding of Tq to a power of two and no padding of D to 128: the
//   TPU kernel's Mosaic artefacts do not apply.

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int NW = THREADS / 32;
constexpr int QT = 16;                // queries per block
constexpr int RPW = QT / NW;          // queries per warp
constexpr int CHUNK = 32;             // keys per step
constexpr int MAXD = 128;
constexpr int DPL = MAXD / 32;
constexpr int LDS = MAXD + 1;

template <typename KV>
__global__ void __launch_bounds__(THREADS)
ragged_prefill_kernel(const float* __restrict__ q,
                      const KV* __restrict__ k_suf,
                      const KV* __restrict__ v_suf,
                      const KV* __restrict__ k_pages,
                      const KV* __restrict__ v_pages,
                      const int* __restrict__ bt,
                      const int* __restrict__ offsets,
                      const int* __restrict__ seq_lens,
                      float* __restrict__ out, int Tq, int Hq, int Hkv,
                      int page, int D, int pages_max, int window,
                      float scale) {
  __shared__ float Ks[CHUNK][LDS];
  __shared__ float Vs[CHUNK][LDS];
  __shared__ float Qs[QT][MAXD];
  __shared__ const KV* s_k[CHUNK];
  __shared__ const KV* s_v[CHUNK];

  const int b = blockIdx.x / Hq, hq = blockIdx.x % Hq;
  const int hkv = hq / (Hq / Hkv);
  const int j0 = blockIdx.y * QT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int off = offsets[b];
  const int slen = seq_lens[b];
  // live query rows of this tile: j0 .. jend-1
  const int jend = min(min(j0 + QT, Tq), slen);

  if (j0 >= jend) {                           // padding rows only
    for (int e = threadIdx.x; e < QT * D; e += THREADS) {
      const int j = j0 + e / D;
      if (j < Tq) out[(((size_t)b * Tq + j) * Hq + hq) * D + e % D] = 0.f;
    }
    return;
  }
  for (int e = threadIdx.x; e < QT * D; e += THREADS) {
    const int r = e / D, d = e % D, j = j0 + r;
    Qs[r][d] = j < Tq ? q[(((size_t)b * Tq + j) * Hq + hq) * D + d] : 0.f;
  }
  const int kv_hi = off + jend;               // last live query pos + 1
  const int kv_lo = window >= 0 ? max(0, off + j0 - window + 1) : 0;

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = bigdl::NEG_BIG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[i][j] = 0.f;
  }

  for (int kv0 = kv_lo; kv0 < kv_hi; kv0 += CHUNK) {
    if (threadIdx.x < CHUNK) {
      const int pos = kv0 + threadIdx.x;
      const KV* kp = nullptr;
      const KV* vp = nullptr;
      if (pos < kv_hi) {
        size_t base;
        if (pos < off) {
          const size_t phys = bt[(size_t)b * pages_max + pos / page];
          base = ((phys * Hkv + hkv) * page + pos % page) * D;
          kp = k_pages + base;
          vp = v_pages + base;
        } else {
          base = (((size_t)b * Tq + (pos - off)) * Hkv + hkv) * D;
          kp = k_suf + base;
          vp = v_suf + base;
        }
      }
      s_k[threadIdx.x] = kp;
      s_v[threadIdx.x] = vp;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < CHUNK * D; e += THREADS) {
      const int t = e / D, d = e % D;
      const KV* kp = s_k[t];
      Ks[t][d] = kp ? bigdl::to_f32(kp[d]) : 0.f;
      Vs[t][d] = kp ? bigdl::to_f32(s_v[t][d]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp * RPW + i;
      const int j = j0 + r;
      if (j >= jend) continue;                // warp-uniform
      const int qpos = off + j;
      const int pos = kv0 + lane;
      const bool valid = pos < kv_hi && pos <= qpos &&
                         (window < 0 || pos > qpos - window);
      float s = -INFINITY;
      if (valid) {
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(Qs[r][d], Ks[lane][d], dot);
        s = dot * scale;
      }
      const float m_cur = bigdl::warp_max(s);
      if (m_cur == -INFINITY) continue;       // no valid key: skip
      const float m_new = fmaxf(m[i], m_cur);
      const float alpha = expf(m[i] - m_new);
      const float p = valid ? expf(s - m_new) : 0.f;
      l[i] = l[i] * alpha + bigdl::warp_sum(p);
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < DPL; ++jd) acc[i][jd] *= alpha;
      for (int t = 0; t < CHUNK; ++t) {
        const float pt = __shfl_sync(bigdl::FULL_MASK, p, t);
#pragma unroll
        for (int jd = 0; jd < DPL; ++jd) {
          const int d = lane + 32 * jd;
          if (d < D) acc[i][jd] = fmaf(pt, Vs[t][d], acc[i][jd]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int j = j0 + warp * RPW + i;
    if (j >= Tq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jd = 0; jd < DPL; ++jd) {
      const int d = lane + 32 * jd;
      if (d < D)
        out[(((size_t)b * Tq + j) * Hq + hq) * D + d] =
            j < jend ? acc[i][jd] * inv : 0.f;
    }
  }
}

template <typename KV>
int launch(const void* q, const void* ks, const void* vs, const void* kp,
           const void* vp, const void* bt, const void* offs,
           const void* lens, void* out, long long B, long long Tq,
           long long Hq, long long Hkv, long long page, long long D,
           long long pages_max, long long window, float scale,
           void* stream) {
  dim3 grid((unsigned)(B * Hq), (unsigned)((Tq + QT - 1) / QT));
  ragged_prefill_kernel<KV><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float*>(q), reinterpret_cast<const KV*>(ks),
      reinterpret_cast<const KV*>(vs), reinterpret_cast<const KV*>(kp),
      reinterpret_cast<const KV*>(vp), reinterpret_cast<const int*>(bt),
      reinterpret_cast<const int*>(offs), reinterpret_cast<const int*>(lens),
      reinterpret_cast<float*>(out), (int)Tq, (int)Hq, (int)Hkv, (int)page,
      (int)D, (int)pages_max, (int)window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface. Preconditions, checked by the Python wrapper: Hq % Hkv ==
// 0, D <= 128, contiguous tensors, B * Hq > 0 and Tq > 0; window < 0
// means no sliding window.
#define BIGDL_RAGGED_ENTRY(NAME, KV)                                        \
  extern "C" int NAME(const void* q, const void* ks, const void* vs,        \
                      const void* kp, const void* vp, const void* bt,       \
                      const void* offs, const void* lens, void* out,        \
                      long long B, long long Tq, long long Hq,              \
                      long long Hkv, long long page, long long D,           \
                      long long pages_max, long long window, float scale,   \
                      void* stream) {                                       \
    return launch<KV>(q, ks, vs, kp, vp, bt, offs, lens, out, B, Tq, Hq,    \
                      Hkv, page, D, pages_max, window, scale, stream);      \
  }

BIGDL_RAGGED_ENTRY(ragged_prefill_bf16, __nv_bfloat16)
BIGDL_RAGGED_ENTRY(ragged_prefill_f32, float)
