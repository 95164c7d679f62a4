// Paged decode attention for Hopper (sm_90a), CUDA C++ with a plain C
// interface, loaded by mxnet_tpu_torch/ops/_build.py through ctypes.
//
// Replaces no TPU kernel: the JAX decode step gathers each row's whole
// paged context (max_pages * page_size keys) and attends with einsums and a
// masked softmax that XLA fuses (mxnet_tpu/serving/decode/model.py:113-155
// `_kv_gather`, :303-315 and :374-384 `attend`).  Here the row's page table
// is read in place and no gathered context ever reaches device memory.
//
// Function.  For row b, head h and query j (0 <= j < nq: 1 in the decode
// step, K + 1 in the speculative verify), the query sits at position
// p = positions[b] + j and sees the keys at positions 0 .. p (at most the
// table's n_tab * page_size):
//     s_l = q . k_l,  e_l = exp(s_l - max_l s_l),  out = sum_l (e_l / sum e) v_l
// with k_l, v_l read from page tables[b, l / page_size], offset
// l % page_size, in the pools' (pages, page_size, heads, head_dim) layout:
// fp32, int8 (dequantised as q * scale + mid, both fp32 sidecars of shape
// (pages, page_size)), or fp8 e4m3 (q * scale), each with two roundings as
// the plain version has them.  A query with no key (p < 0) gives 0.
//
// What bounds it.  Bytes: every live key and value head row is read once
// a call, for all the call's queries.  GPT-2 small at batch 8, positions
// 200-639 (3,817 live keys over the batch) reads 2 x 3,817 x 768 x 4 B =
// 23.5 MB a layer in fp32 (7.0 us at 3.35 TB/s); int8 and fp8 pools read a
// quarter of that plus their sidecars (8 B or 4 B a key).  The operations
// (4 flops a key and column, 11.7 MFLOP) take 0.2 us at the fp32 rate.
//
// Design: flash-decoding made row-stable.  Each row's context is cut into
// chunks of kChunk = 64 keys fixed in absolute position (keys 64c ..
// 64c + 63, four 16-token pages), whatever the batch, the query count, the
// positions or where the pages lie.  The grid runs over (chunk slot, head,
// row), sized from the table (n_tab * page_size / 64 slots) so that the
// host never reads the positions; a block whose chunk lies past its row's
// last query exits at once.  At the served shape that is 756 live blocks
// of 128 threads where one block per (row, head) gave 96.  64 keys a chunk
// keep a block's staged K and V at 32 KB (fp32, D 64); with registers
// capped at 80 a thread six blocks share an SM, so the 756 live chunks run
// in one wave with a chunk's loads in flight in each.
//  - Loads.  A chunk's K and V head rows (D x 4 B in fp32, D B in int8 or
//    fp8) are copied into shared memory with 16-byte cp.async, neighbouring
//    lanes on neighbouring addresses of a row, K and V in two groups: the
//    scores run while V is still in flight.  Keys past the block's last
//    live position are never read (their table entries may be stale);
//    their slots are zero-filled.  int8 and fp8 codes land at the start of
//    the rows they become and are dequantised in place after the copy
//    (codes to registers, a barrier, values back).  Every query of the call
//    is computed from the same staged chunk, so the verify reads its
//    context once, not K + 1 times.
//  - Order inside a chunk.  Warp w owns keys 16w .. 16w + 15 and takes
//    the queries one after another with no block barrier between them.
//    Lane (half, k) sums q . k over its half of D in increasing d (float4
//    reads of a padded row, no bank conflict), and the halves are added
//    (a + b, the same bits on either lane).  Per query the warp takes its
//    max, e = exp(s - max) (0 for a key past p), and the sum of e by a
//    fixed butterfly; P V sums its live keys in key order, one column a
//    lane.  The four warps' (m, l, o) are merged in warp order:
//    m = max m_w, l = sum l_w exp(m_w - m), o = sum o_w exp(m_w - m).
//    Each step depends on a key's place in its chunk and on p alone: a key
//    past p adds an exact zero or is skipped, in the step and the verify
//    alike.
//  - Partials and the fold, one launch a call.  Each (row, query, head,
//    chunk) writes (m_c, l_c, o_c[D]) to the stream's scratch.  After a
//    barrier one thread takes the (row, head)'s ticket with an acq_rel
//    atomic (a release cumulative over the block's writes); the last block
//    to arrive resets it and folds each query's chunks 0 .. p / 64 in
//    chunk order, one output a thread, all its chunks' partials in one
//    round of loads: m = max m_c, l = sum l_c exp(m_c - m),
//    out = (sum o_c exp(m_c - m)) / l.
//
// Row stability.  A query's chunks, and every sum inside and across them,
// are a function of its position, its row's pages and the pools alone: not
// of the other rows, of nq or j, of the block's live range, or of where the
// pages lie.  So a row alone equals the row in a batch, a permuted batch
// and moved pages give the same bits, and the verify's query j equals a
// 1-query step at p + j, bit for bit.  The outputs differ from a
// one-pass softmax by rounding only (the sum's order).

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;                   // keys a chunk
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpKeys = kChunk / kWarps;   // 16: a warp's keys
constexpr int kQGroup = 8;                   // queries staged at a time
constexpr int kFoldBatch = 16;               // chunk partials in flight
constexpr int kMaxDevices = 64;

enum Quant { kFp32 = 0, kInt8 = 1, kFp8 = 2 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes, or 16 zeros when !in
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a pool code to fp32, with the plain version's two roundings
template <int Q>
__device__ __forceinline__ float dequant(unsigned char code, float scale,
                                         float mid) {
  if (Q == kInt8)
    return __fadd_rn(__fmul_rn(static_cast<float>(
                                   static_cast<signed char>(code)), scale),
                     mid);
  const __half_raw hr = __nv_cvt_fp8_to_halfraw(
      static_cast<__nv_fp8_storage_t>(code), __NV_E4M3);
  return __fmul_rn(__half2float(__half(hr)), scale);
}

// shared memory of a block, in floats: K (kChunk rows of kD + 4), V
// (kChunk x kD), int8 and fp8's 4 x kChunk sidecars, then per staged query
// q (kD), e (kChunk), the warps' m and l, and, when the queries take more
// than one group, the warps' o (kWarps x kD); in one group o takes the K
// rows, free once every score is taken.  int8 and fp8 codes are staged at
// the start of the K and V rows they become.
template <int Q, int kD>
__host__ __device__ constexpr size_t smem_bytes(int ng, bool own_o) {
  return sizeof(float) * ((size_t)kChunk * (kD + 4) + kChunk * kD +
                          (Q == kFp32 ? 0 : 4 * kChunk) +
                          (size_t)ng * (kD + kChunk + 2 * kWarps +
                                        (own_o ? kWarps * kD : 0)));
}

// Dequantise a chunk's codes, staged at the start of `f` (kChunk rows of
// kD bytes), into fp32 rows of `ld` floats in place: every thread takes
// its 16-byte granules into registers, then, after a barrier, writes their
// values (0 past d); ends with a barrier
template <int Q, int kD>
__device__ __forceinline__ void dequant_rows(float* f, int ld,
                                             const float* scale,
                                             const float* mid, int d) {
  constexpr int kGrans = kChunk * kD / 16;
  constexpr int kPer = (kGrans + kThreads - 1) / kThreads;
  uint4 g[kPer];
  const uint4* src = reinterpret_cast<const uint4*>(f);
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int gi = threadIdx.x + u * kThreads;
    if (gi < kGrans) g[u] = src[gi];
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int gi = threadIdx.x + u * kThreads;
    if (gi < kGrans) {
      const int r = gi * 16 / kD, e0 = gi * 16 - r * kD;
      const uint32_t w[4] = {g[u].x, g[u].y, g[u].z, g[u].w};
      const float sc = scale[r], md = Q == kInt8 ? mid[r] : 0.f;
#pragma unroll
      for (int x = 0; x < 16; x += 4) {
        float o[4];
#pragma unroll
        for (int y = 0; y < 4; ++y)
          o[y] = e0 + x + y < d
                     ? dequant<Q>((w[x / 4] >> (8 * y)) & 0xffu, sc, md)
                     : 0.f;
        *reinterpret_cast<float4*>(f + r * ld + e0 + x) =
            make_float4(o[0], o[1], o[2], o[3]);
      }
    }
  }
  __syncthreads();
}

// Copy one chunk's head rows of a pool (K or V) into shared memory: rows
// of `ld` elements (4 B fp32, else 1 B codes), zeros past `nlive` keys.
// vec: 16-byte cp.async granules (d * elem % 16 == 0, 16-byte aligned
// pool); else plain loads.
template <int Q>
__device__ __forceinline__ void stage_rows(void* dst, int ld,
                                           const void* pool,
                                           const int* table, int k0,
                                           int nlive, int page_size,
                                           size_t row, int h, int d,
                                           bool vec) {
  constexpr int kEs = Q == kFp32 ? 4 : 1;
  const char* src = static_cast<const char*>(pool);
  char* out = static_cast<char*>(dst);
  if (vec) {
    const int g_row = d * kEs / 16;            // granules a head row
    for (int i = threadIdx.x; i < kChunk * g_row; i += kThreads) {
      const int r = i / g_row, g = i - r * g_row;
      const bool in = r < nlive;
      size_t off = 0;
      if (in) {
        const int l = k0 + r;
        const size_t slot =
            (size_t)table[l / page_size] * page_size + l % page_size;
        off = (slot * row + (size_t)h * d) * kEs + (size_t)g * 16;
      }
      cp_async16(out + ((size_t)r * ld) * kEs + g * 16, src + off, in);
    }
  } else {
    for (int i = threadIdx.x; i < kChunk * d; i += kThreads) {
      const int r = i / d, e = i - r * d;
      const bool in = r < nlive;
      size_t idx = 0;
      if (in) {
        const int l = k0 + r;
        const size_t slot =
            (size_t)table[l / page_size] * page_size + l % page_size;
        idx = slot * row + (size_t)h * d + e;
      }
      if (Q == kFp32)
        reinterpret_cast<float*>(out)[(size_t)r * ld + e] =
            in ? __ldg(reinterpret_cast<const float*>(src) + idx) : 0.f;
      else
        reinterpret_cast<unsigned char*>(out)[(size_t)r * ld + e] =
            in ? __ldg(reinterpret_cast<const unsigned char*>(src) + idx)
               : (unsigned char)0;
    }
  }
  cp_async_commit();
}

// blocks an SM the register budget must allow: six blocks of the step's
// fp32 D <= 64 kernel fit the shared memory of an SM, and 756 live chunks
// (the served shape) then run in one wave
template <int kD>
__host__ __device__ constexpr int min_blocks() {
  return kD <= 64 ? 6 : 4;
}

// grid (chunk slots, heads, rows); see the design note above
template <int Q, int kD>
__global__ void __launch_bounds__(kThreads, (min_blocks<kD>()))
paged_attention_chunk_kernel(
    const float* __restrict__ q, const void* __restrict__ k_pool,
    const void* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ k_mid, const float* __restrict__ v_scale,
    const float* __restrict__ v_mid, const int* __restrict__ tables,
    const int* __restrict__ positions, float* __restrict__ out,
    float* __restrict__ part, int* __restrict__ tickets, int nq, int heads,
    int d, int page_size, int n_tab, int vec) {
  constexpr int kLdK = kD + 4;               // padded K row: no bank conflict
  constexpr int kCols = (kD + 31) / 32;      // a lane's columns in P V
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lctx = n_tab * page_size;
  const int p0 = positions[b];
  const int lim = min(p0 + nq - 1, lctx - 1);  // the row's last live key
  const int k0 = c * kChunk;
  if (k0 > lim) {
    if (c == 0)                              // no key at all: zeros
      for (int i = tid; i < nq * d; i += kThreads) {
        const int j = i / d, dd = i - j * d;
        out[(((size_t)b * nq + j) * heads + h) * d + dd] = 0.f;
      }
    return;
  }
  const int nlive = min(lim - k0 + 1, kChunk);
  const int slots = gridDim.x;
  const int* table = tables + (size_t)b * n_tab;
  const size_t row = (size_t)heads * d;      // one token's K (or V) row

  extern __shared__ __align__(16) float smem[];
  const int ng_max = min(nq, kQGroup);
  float* ks = smem;                          // [kChunk][kLdK]
  float* vs = ks + kChunk * kLdK;            // [kChunk][kD]
  float* sd = vs + kChunk * kD;              // [4][kChunk] sidecars
  float* qs = sd + (Q == kFp32 ? 0 : 4 * kChunk);  // [ng][kD]
  float* es = qs + ng_max * kD;              // [ng][kChunk]
  float* ms = es + ng_max * kChunk;          // [ng][kWarps]
  float* ls = ms + ng_max * kWarps;          // [ng][kWarps]
  float* os = nq <= kQGroup ? ks             // [ng][kWarps][kD]
                            : ls + ng_max * kWarps;

  // K then V, each its own cp.async group
  if (Q == kFp32) {
    stage_rows<Q>(ks, kLdK, k_pool, table, k0, nlive, page_size, row, h, d,
                  vec);
    stage_rows<Q>(vs, kD, v_pool, table, k0, nlive, page_size, row, h, d,
                  vec);
    if (d < kD)                              // padded columns
      for (int i = tid; i < kChunk * (kD - d); i += kThreads) {
        const int r = i / (kD - d), e = d + i - r * (kD - d);
        ks[r * kLdK + e] = 0.f;
        vs[r * kD + e] = 0.f;
      }
  } else {
    stage_rows<Q>(ks, kD, k_pool, table, k0, nlive, page_size, row, h, d,
                  vec);
    stage_rows<Q>(vs, kD, v_pool, table, k0, nlive, page_size, row, h, d,
                  vec);
    if (tid < kChunk) {
      const bool in = tid < nlive;
      size_t slot = 0;
      if (in) {
        const int l = k0 + tid;
        slot = (size_t)table[l / page_size] * page_size + l % page_size;
      }
      sd[tid] = in ? k_scale[slot] : 0.f;
      sd[kChunk + tid] = in && Q == kInt8 ? k_mid[slot] : 0.f;
      sd[2 * kChunk + tid] = in ? v_scale[slot] : 0.f;
      sd[3 * kChunk + tid] = in && Q == kInt8 ? v_mid[slot] : 0.f;
    }
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int half = lane >> 4, key = warp * kWarpKeys + (lane & 15);
  const int wk0 = k0 + warp * kWarpKeys;     // the warp's first key
  for (int j0 = 0; j0 < nq; j0 += kQGroup) {
    const int ng = min(nq - j0, kQGroup);
    for (int i = tid; i < ng * kD; i += kThreads) {
      const int j = i / kD, e = i - j * kD;
      qs[i] = e < d ? q[(((size_t)b * nq + j0 + j) * heads + h) * d + e]
                    : 0.f;
    }
    if (j0 == 0) cp_async_wait<1>();         // K has landed
    __syncthreads();
    if (Q != kFp32 && j0 == 0)
      dequant_rows<Q, kD>(ks, kLdK, sd, sd + kChunk, d);
    // per query, warp by warp with no block barrier: lane (half, key) dots
    // its half of D in increasing d, the halves are added, then the warp's
    // max, e = exp(s - max) (0 past p) and the sum of e by a fixed butterfly
    const float* krow = ks + key * kLdK + half * (kD / 2);
    for (int j = 0; j < ng; ++j) {
      const int pj = min(p0 + j0 + j, lctx - 1);
      const float* qv = qs + j * kD + half * (kD / 2);
      float sj = 0.f;
#pragma unroll
      for (int e = 0; e < kD / 2; e += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(krow + e);
        const float4 q4 = *reinterpret_cast<const float4*>(qv + e);
        sj = fmaf(q4.x, k4.x, sj);
        sj = fmaf(q4.y, k4.y, sj);
        sj = fmaf(q4.z, k4.z, sj);
        sj = fmaf(q4.w, k4.w, sj);
      }
      sj = sj + __shfl_xor_sync(0xffffffffu, sj, 16);
      const bool live = k0 + key <= pj;
      float m = live ? sj : -INFINITY;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      const float ev = live ? expf(sj - m) : 0.f;
      float l = ev;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        l = l + __shfl_xor_sync(0xffffffffu, l, off);
      if (half == 0) es[j * kChunk + key] = ev;
      if (lane == 0) {
        ms[j * kWarps + warp] = m;
        ls[j * kWarps + warp] = l;
      }
    }
    if (j0 == 0) cp_async_wait<0>();         // V has landed
    __syncthreads();
    if (Q != kFp32 && j0 == 0)
      dequant_rows<Q, kD>(vs, kD, sd + 2 * kChunk, sd + 3 * kChunk, d);
    // P V per query: the warp's live keys in key order, one column a lane
    const float* vw = vs + warp * kWarpKeys * kD;
    for (int j = 0; j < ng; ++j) {
      const int pj = min(p0 + j0 + j, lctx - 1);
      const int n = min(max(pj - wk0 + 1, 0), kWarpKeys);
      const float* ew = es + j * kChunk + warp * kWarpKeys;
      float acc[kCols];
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
#pragma unroll
      for (int k = 0; k < kWarpKeys; ++k)
        if (k < n) {
          const float w = ew[k];
#pragma unroll
          for (int i = 0; i < kCols; ++i) {
            const int col = lane + 32 * i;
            if (col < kD) acc[i] = fmaf(w, vw[k * kD + col], acc[i]);
          }
        }
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int col = lane + 32 * i;
        if (col < kD) os[(j * kWarps + warp) * kD + col] = acc[i];
      }
    }
    __syncthreads();
    // the chunk's partial per query: the warps merged in warp order
    for (int i = tid; i < ng * d; i += kThreads) {
      const int j = i / d, dd = i - j * d;
      const int pj = min(p0 + j0 + j, lctx - 1);
      if (k0 > pj) continue;                 // no key of this chunk is seen
      const float* mw = ms + j * kWarps;
      float m = mw[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) m = fmaxf(m, mw[w]);
      float l = 0.f, o = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float a = mw[w] == -INFINITY ? 0.f : expf(mw[w] - m);
        l = fmaf(ls[j * kWarps + w], a, l);
        o = fmaf(os[(j * kWarps + w) * kD + dd], a, o);
      }
      float* pc = part + ((((size_t)b * nq + j0 + j) * heads + h) * slots +
                          c) * (d + 2);
      pc[2 + dd] = o;
      if (dd == 0) {
        pc[0] = m;
        pc[1] = l;
      }
    }
    __syncthreads();                         // the partials are written, and
                                             // the next group reuses smem
  }

  // the last chunk of (row, head) to finish folds every query's chunks.
  // The barrier above orders the block's partials before thread 0's
  // acq_rel ticket at gpu scope (a release cumulative over them); the
  // last block's acquire, then its barrier, orders its reads after every
  // other block's release.
  __shared__ int last;
  if (tid == 0) {
    int old;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(old)
                 : "l"(tickets + (size_t)b * heads + h)
                 : "memory");
    last = old == lim / kChunk;
  }
  __syncthreads();
  if (!last) return;
  const size_t pstride = d + 2;
  for (int i = tid; i < nq * d; i += kThreads) {
    const int j = i / d, dd = i - j * d;
    const int pj = min(p0 + j, lctx - 1);
    float r = 0.f;
    if (pj >= 0) {
      const int nc = pj / kChunk + 1;
      const float* pq =
          part + (((size_t)b * nq + j) * heads + h) * slots * pstride;
      // m = max m_c, then l and o in chunk order; up to kFoldBatch chunks
      // take one round of loads, more take two passes
      float m = -INFINITY, l = 0.f, o = 0.f;
      if (nc <= kFoldBatch) {
        float mv[kFoldBatch], lv[kFoldBatch], ov[kFoldBatch];
#pragma unroll
        for (int t = 0; t < kFoldBatch; ++t) {
          const bool in = t < nc;
          const float* pc = pq + t * pstride;
          mv[t] = in ? __ldcg(pc) : -INFINITY;
          lv[t] = in ? __ldcg(pc + 1) : 0.f;
          ov[t] = in ? __ldcg(pc + 2 + dd) : 0.f;
        }
#pragma unroll
        for (int t = 0; t < kFoldBatch; ++t) m = fmaxf(m, mv[t]);
#pragma unroll
        for (int t = 0; t < kFoldBatch; ++t)
          if (t < nc) {
            const float a = expf(mv[t] - m);
            l = fmaf(lv[t], a, l);
            o = fmaf(ov[t], a, o);
          }
      } else {
        for (int k = 0; k < nc; ++k) m = fmaxf(m, __ldcg(pq + k * pstride));
        for (int k = 0; k < nc; ++k) {
          const float* pc = pq + k * pstride;
          const float a = expf(__ldcg(pc) - m);
          l = fmaf(__ldcg(pc + 1), a, l);
          o = fmaf(__ldcg(pc + 2 + dd), a, o);
        }
      }
      r = o / l;
    }
    out[(((size_t)b * nq + j) * heads + h) * d + dd] = r;
  }
  if (tid == 0) tickets[(size_t)b * heads + h] = 0;   // ready for the next call
}

template <int Q, int kD>
cudaError_t launch(const float* q, const void* kp, const void* vp,
                   const float* ks, const float* km, const float* vs,
                   const float* vm, const int* tables, const int* positions,
                   float* out, float* part, int* tickets, int b, int nq,
                   int heads, int d, int page_size, int n_tab, bool vec,
                   int device, cudaStream_t stream) {
  static bool raised[kMaxDevices];           // the smem limit, per device
  const size_t smem = smem_bytes<Q, kD>(min(nq, kQGroup), nq > kQGroup);
  const size_t most = smem_bytes<Q, kD>(kQGroup, true);
  if (smem > 48 * 1024 &&
      (device < 0 || device >= kMaxDevices || !raised[device])) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_chunk_kernel<Q, kD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < kMaxDevices) raised[device] = true;
  }
  const int slots = (n_tab * page_size + kChunk - 1) / kChunk;
  const dim3 grid(slots, heads, b);
  paged_attention_chunk_kernel<Q, kD>
      <<<grid, kThreads, smem, stream>>>(q, kp, vp, ks, km, vs, vm, tables,
                                         positions, out, part, tickets, nq,
                                         heads, d, page_size, n_tab,
                                         vec ? 1 : 0);
  return cudaGetLastError();
}

template <int Q>
cudaError_t launch_d(const float* q, const void* kp, const void* vp,
                     const float* ks, const float* km, const float* vs,
                     const float* vm, const int* tables, const int* positions,
                     float* out, float* part, int* tickets, int b, int nq,
                     int heads, int d, int page_size, int n_tab, bool vec,
                     int device, cudaStream_t stream) {
#define MXT_PA_LAUNCH(KD)                                                    \
  return launch<Q, KD>(q, kp, vp, ks, km, vs, vm, tables, positions, out,    \
                       part, tickets, b, nq, heads, d, page_size, n_tab, vec, \
                       device, stream)
  if (d <= 16) MXT_PA_LAUNCH(16);
  if (d <= 32) MXT_PA_LAUNCH(32);
  if (d <= 64) MXT_PA_LAUNCH(64);
  MXT_PA_LAUNCH(128);
#undef MXT_PA_LAUNCH
}

}  // namespace

extern "C" {

// Keys a chunk: the wrapper sizes the scratch by it.
int mxt_paged_attention_chunk() { return kChunk; }

// out (b, nq, heads, d) fp32 from q (b, nq, heads, d) fp32 (already scaled)
// and one layer's pools k_pool / v_pool (pages, page_size, heads, d):
// quant 0 fp32; 1 int8 with k_scale, k_mid, v_scale, v_mid (pages,
// page_size) fp32; 2 fp8 e4m3 (bytes) with k_scale, v_scale.  tables
// (b, n_tab) and positions (b,) int32.  All contiguous, d <= 128.
// partials: at least b * nq * heads * ceil(n_tab * page_size / 64) *
// (d + 2) floats; tickets: at least b * heads int32, zero on entry and
// left at zero.  One launch on `stream`.  Returns a cudaError_t (0 on
// success).
int mxt_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                        const void* k_scale, const void* k_mid,
                        const void* v_scale, const void* v_mid,
                        const void* tables, const void* positions, void* out,
                        int b, int nq, int heads, int d, int page_size,
                        int n_tab, int quant, void* partials,
                        long long partial_cap, void* tickets, int ticket_cap,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0 || nq <= 0 || heads <= 0) return 0;
  if (d < 1 || d > 128 || page_size < 0 || n_tab < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long lctx = (long long)n_tab * page_size;
  if (lctx == 0)                             // no key at all: zeros
    return static_cast<int>(cudaMemsetAsync(
        out, 0, sizeof(float) * (size_t)b * nq * heads * d, s));
  const long long slots = (lctx + kChunk - 1) / kChunk;
  if (lctx > (1LL << 30) || slots > 0x7fffffffLL ||
      (long long)b * nq * heads * slots * (d + 2) > partial_cap ||
      (long long)b * heads > ticket_cap || b > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int es = quant == kFp32 ? 4 : 1;
  const bool vec = (d * es) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k_pool) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v_pool) % 16 == 0;
  const float* qf = static_cast<const float*>(q);
  const float* ks = static_cast<const float*>(k_scale);
  const float* km = static_cast<const float*>(k_mid);
  const float* vs = static_cast<const float*>(v_scale);
  const float* vm = static_cast<const float*>(v_mid);
  const int* t = static_cast<const int*>(tables);
  const int* p = static_cast<const int*>(positions);
  float* o = static_cast<float*>(out);
  float* part = static_cast<float*>(partials);
  int* tk = static_cast<int*>(tickets);
  switch (quant) {
    case kFp32:
      err = launch_d<kFp32>(qf, k_pool, v_pool, ks, km, vs, vm, t, p, o, part,
                            tk, b, nq, heads, d, page_size, n_tab, vec,
                            device, s);
      break;
    case kInt8:
      err = launch_d<kInt8>(qf, k_pool, v_pool, ks, km, vs, vm, t, p, o, part,
                            tk, b, nq, heads, d, page_size, n_tab, vec,
                            device, s);
      break;
    case kFp8:
      err = launch_d<kFp8>(qf, k_pool, v_pool, ks, km, vs, vm, t, p, o, part,
                           tk, b, nq, heads, d, page_size, n_tab, vec,
                           device, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"
