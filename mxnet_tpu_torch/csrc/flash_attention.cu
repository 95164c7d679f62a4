// Flash-attention forward for Hopper (sm_90a) on the tensor cores, CUDA C++
// with a plain C interface, loaded by mxnet_tpu_torch/ops/_build.py through
// ctypes.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py `_fa_kernel` (:35-77), launched
// by `_fa_forward` (:101).  Same function: out = softmax(scale * Q K^T) V per
// (batch, head), optionally causal, with an online softmax in fp32 so that
// no T x T matrix ever reaches device memory.
//
// What bounds it.  BERT-base serving runs it once per encoder layer at
// (B, H, T, D) = (8, 12, 128, 64) in fp32.  It must read q, k, v and write
// out: 4 * 8*12*128*64 * 4 B = 12.6 MB, 3.8 us at 3.35 TB/s.  It does
// 4*B*H*T^2*D = 0.40 GFLOP: 2.4 us at 165 TFLOP/s, the rate of fp32-accurate
// products on the tensor cores (3xTF32 below: 495 TFLOP/s of TF32 over three
// products), against 6.0 us on the 67 TFLOP/s fp32 FMA pipes.  On the tensor
// cores the bytes bound it; at a few hundred blocks, about one wave, launch
// latency, load latency and fill decide the time.
//
// 3xTF32.  One TF32 product keeps 10 mantissa bits, too few for fp32's 1e-4.
// Each fp32 operand is split once, x = hi + lo: hi is x rounded to TF32
// (nearest, ties away, done on the bits: two integer instructions where
// cvt.rna.tf32.f32 takes four), lo = x - hi is exact in fp32 and goes to the
// tensor core whole, which reads its top 19 bits (|lo| <= 2^-11 |x|, so
// that cut costs at most 2^-21 |x|).  a*b ~ hi_a*hi_b + hi_a*lo_b +
// lo_a*hi_b: three tensor-core products accumulated in fp32, the two small
// ones in accumulators of their own so that the large sum rounds once per
// k-step.  The dropped lo_a*lo_b is below 2^-22 |a*b|.  At scores of +-100
// the result stays closer to the float64 answer than the plain fp32
// version's (flash_bench.py).  bf16/fp16 go to the
// tensor cores as they are (one m16n8k16 product) with fp32 accumulators;
// P is rounded to the input type.
//
// Design.  The Pallas grid walks 128-row q blocks in order on one TPU core
// with D padded to 128 lanes; here q tiles run in parallel over the 132 SMs
// and D is never padded in memory.
//  - A block of kWarps warps owns 16 * kWarps query rows of one
//    (batch, head); each warp owns 16 rows and computes S = Q K^T and
//    O += P V for them with warp-level mma.sync: m16n8k8 TF32 for fp32
//    (three per product), m16n8k16 for bf16/fp16.
//  - Q, then K/V in 64-row tiles, arrive in shared memory by 16-byte
//    cp.async copies into a double-buffered ring: tile j+1 is in flight while
//    tile j is computed.  Rows past T and columns past D (up to the head
//    bucket) are zero-filled by the copy itself (source size 0), so V's tail
//    contributes 0 and the mask covers K's.  D not a multiple of 16 bytes, or
//    inputs not 16-byte aligned, take an element-by-element load into the
//    same ring.
//  - Shared-memory rows are 16 bytes wider than the head bucket, so the
//    fragment reads Q[g][t], K[g][t] and V[2t][g] (g = lane / 4,
//    t = lane % 4) hit 32 distinct banks.
//  - The online softmax runs on the accumulator fragments: a thread holds
//    two rows of each 16x8 score tile, a row's 4 owners (a quad) reduce its
//    max with shuffles, and the running sum stays per thread until the end.
//    Causal mode stops at the last K tile the block's rows can see.
//  - The mma loops carry no branch (the ring holds zeros past D up to the
//    head bucket and past T), and each k-step issues its products in three
//    passes over the 8 independent accumulator tiles, so back-to-back mmas
//    never wait on each other.  Skipping tiles per warp (branches) cost
//    more than the work it saved.
//  - exp2 runs on ex2.approx (about 2^-22 relative error) in log2 units:
//    scores are scaled by scale * log2(e) in fp32.
//  - P feeds P V from registers.  S's accumulator fragment holds keys 2t and
//    2t+1 where TF32's A operand wants t and t+4; the fp32 path reorders the
//    8 keys of each k-step instead (key 2t to column t, key 2t+1 to column
//    t+4, and V's rows the same way), so no value moves between threads.
//    For bf16/fp16 the two layouts agree already; V's fragments come from
//    ldmatrix.trans.
//  - The head width is a template bucket (64, 128) with the true D as a
//    runtime bound, so the accumulators stay in registers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

// 64 query rows a block: 27-31 % faster in fp32 than 32 rows (PERF.md)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;   // query rows per block
constexpr int kBK = 64;            // key rows per shared-memory tile
constexpr int kNT = kBK / 8;       // 8-key score tiles per K tile
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
__host__ __device__ constexpr bool is_f32() { return std::is_same<T, float>::value; }
// elements per 16-byte copy; the k depth of one mma
template <typename T>
__host__ __device__ constexpr int chunk() { return 16 / (int)sizeof(T); }
template <typename T>
__host__ __device__ constexpr int kdepth() { return is_f32<T>() ? 8 : 16; }
// shared-memory row stride: 16 bytes past the head bucket, 4 banks apart
template <typename T, int DMAX>
__host__ __device__ constexpr int row_ld() { return DMAX + chunk<T>(); }
// q tile, then two stages of (K tile, V tile)
template <typename T, int DMAX>
constexpr size_t smem_bytes() {
  return (size_t)(kBQ + 4 * kBK) * row_ld<T, DMAX>() * sizeof(T);
}

template <typename T>
__device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16(0.f); }
template <> __device__ __forceinline__ __half zero<__half>() { return __float2half(0.f); }

__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void from_f32(float v, __half* p) { *p = __float2half(v); }

// two adjacent outputs, p aligned to two elements
__device__ __forceinline__ void from_f32x2(float a, float b, float* p) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void from_f32x2(float a, float b, __nv_bfloat16* p) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void from_f32x2(float a, float b, __half* p) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// a, b in one 32-bit register, a in the low half (the lower column)
__device__ __forceinline__ uint32_t pack2(float a, float b, __nv_bfloat16*) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack2(float a, float b, __half*) {
  __half2 h = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 2^x, flushing results below 2^-126 to 0
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: cvt.rna.tf32.f32's result for finite x
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo exactly; the mma reads lo's top 19 bits
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b, one 16x8x8 TF32 product
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// c += a b, one 16x8x16 product of bf16 or fp16
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2], __nv_bfloat16*) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2], __half*) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the B fragment of a 16x8 slab of row-major 16-bit data, transposed:
// lanes 0-15 give the addresses of its 16 rows
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&b)[2],
                                                  const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1]) : "r"(smem_addr(row)));
}

__device__ __forceinline__ uint32_t lds32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows [row0, row0 + NROWS) of a (t, d) slab into shared memory with row
// stride LD, columns [0, DMAX): zeros past row t and column d, so the mma
// loops run over the whole bucket without a bound.  vec: 16-byte cp.async
// copies (d a multiple of chunk<T>() and the slab 16-byte aligned); else
// element by element, synchronously.
template <typename T, int DMAX, int NROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int t, int d, bool vec) {
  constexpr int LD = row_ld<T, DMAX>();
  if (vec) {
    constexpr int C = chunk<T>(), NC = DMAX / C;
    for (int i = threadIdx.x; i < NROWS * NC; i += kThreads) {
      const int r = i / NC, c = (i % NC) * C;
      const int row = row0 + r;
      const bool full = row < t && c < d;
      cp_async16(dst + r * LD + c, full ? src + (size_t)row * d + c : src,
                 full ? 16 : 0);
    }
    return;
  }
  for (int i = threadIdx.x; i < NROWS * DMAX; i += kThreads) {
    const int r = i / DMAX, c = i % DMAX;
    const int row = row0 + r;
    dst[r * LD + c] = row < t && c < d ? src[(size_t)row * d + c] : zero<T>();
  }
}

// s = Q K^T for the warp's 16 rows (qw) and the 64 keys of ks.  No branch
// inside, so the scheduler interleaves the 8 independent score tiles.
template <typename T, int DMAX>
__device__ __forceinline__ void scores(float (&s)[kNT][4], const T* qw,
                                       const T* ks, int g, int tq) {
  constexpr int LD = row_ld<T, DMAX>();
  constexpr int KD = kdepth<T>();
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
  if constexpr (is_f32<T>()) {
    // the two small products go to their own accumulators, so the large
    // one's sum rounds once per k-step, not three times
    float small[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) small[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DMAX / KD; ++kk) {
      // A: rows g, g+8 x columns t, t+4 of this k-step
      const float* qa = qw + g * LD + kk * KD + tq;
      uint32_t ah[4], al[4];
      split_tf32(qa[0], ah[0], al[0]);
      split_tf32(qa[8 * LD], ah[1], al[1]);
      split_tf32(qa[4], ah[2], al[2]);
      split_tf32(qa[8 * LD + 4], ah[3], al[3]);
      uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        // B[k][n] = K[n][k]: key 8n + g, columns t, t+4
        const float* kb = ks + (8 * n + g) * LD + kk * KD + tq;
        split_tf32(kb[0], bh[n][0], bl[n][0]);
        split_tf32(kb[4], bh[n][1], bl[n][1]);
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n) mma_tf32(small[n], al, bh[n]);
#pragma unroll
      for (int n = 0; n < kNT; ++n) mma_tf32(small[n], ah, bl[n]);
#pragma unroll
      for (int n = 0; n < kNT; ++n) mma_tf32(s[n], ah, bh[n]);
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] += small[n][e];
  } else {
#pragma unroll
    for (int kk = 0; kk < DMAX / KD; ++kk) {
      // A: rows g, g+8 x column pairs 2t, 2t+8 of this k-step
      const T* qa = qw + g * LD + kk * KD + 2 * tq;
      const uint32_t a[4] = {lds32(qa), lds32(qa + 8 * LD), lds32(qa + 8),
                             lds32(qa + 8 * LD + 8)};
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const T* kb = ks + (8 * n + g) * LD + kk * KD + 2 * tq;
        const uint32_t b[2] = {lds32(kb), lds32(kb + 8)};
        mma_16816(s[n], a, b, (T*)nullptr);
      }
    }
  }
}

// o += p V over the 64 keys of vs and the whole head bucket
template <typename T, int DMAX>
__device__ __forceinline__ void accumulate(float (&o)[DMAX / 8][4],
                                           const float (&p)[kNT][4],
                                           const T* vs, int g, int tq,
                                           int lane) {
  constexpr int LD = row_ld<T, DMAX>();
  if constexpr (is_f32<T>()) {
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      // k-step over keys 8n..8n+7 in the order 0,2,4,6,1,3,5,7: A column
      // t is key 2t, column t+4 key 2t+1, which is where S's fragment left
      // them (c0, c1 = row g, keys 2t, 2t+1; c2, c3 = row g+8)
      uint32_t ah[4], al[4];
      split_tf32(p[n][0], ah[0], al[0]);
      split_tf32(p[n][2], ah[1], al[1]);
      split_tf32(p[n][1], ah[2], al[2]);
      split_tf32(p[n][3], ah[3], al[3]);
      // B rows in the same order: V[8n + 2t][col], V[8n + 2t + 1][col]
      const float* vb = vs + (8 * n + 2 * tq) * LD + g;
#pragma unroll
      for (int c0 = 0; c0 < DMAX / 8; c0 += 8) {
        uint32_t bh[8][2], bl[8][2];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          split_tf32(vb[8 * (c0 + c)], bh[c][0], bl[c][0]);
          split_tf32(vb[LD + 8 * (c0 + c)], bh[c][1], bl[c][1]);
        }
#pragma unroll
        for (int c = 0; c < 8; ++c) mma_tf32(o[c0 + c], al, bh[c]);
#pragma unroll
        for (int c = 0; c < 8; ++c) mma_tf32(o[c0 + c], ah, bl[c]);
#pragma unroll
        for (int c = 0; c < 8; ++c) mma_tf32(o[c0 + c], ah, bh[c]);
      }
    }
  } else {
#pragma unroll
    for (int n = 0; n < kNT; n += 2) {
      // k-step over keys 8n..8n+15: S's tiles n and n+1 are its A fragment
      // as they stand
      const uint32_t a[4] = {pack2(p[n][0], p[n][1], (T*)nullptr),
                             pack2(p[n][2], p[n][3], (T*)nullptr),
                             pack2(p[n + 1][0], p[n + 1][1], (T*)nullptr),
                             pack2(p[n + 1][2], p[n + 1][3], (T*)nullptr)};
      const T* vrow = vs + (8 * n + (lane & 15)) * LD;
#pragma unroll
      for (int c = 0; c < DMAX / 8; ++c) {
        uint32_t b[2];
        ldmatrix_x2_trans(b, vrow + 8 * c);
        mma_16816(o[c], a, b, (T*)nullptr);
      }
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
fa_forward_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, int t, int d,
                  float scale, int causal, int vec) {
  constexpr int LD = row_ld<T, DMAX>();
  constexpr int NO = DMAX / 8;   // 8-column output tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);   // (kBQ, LD)
  T* ring = qs + kBQ * LD;                  // 2 x [(kBK, LD) K, (kBK, LD) V]

  const size_t slab = (size_t)blockIdx.y * t * d;
  const T* qb = q + slab;
  const T* kb = k + slab;
  const T* vb = v + slab;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;  // fragment row and column groups
  const int wrow = q0 + 16 * warp;         // the warp's first query row
  const float c = scale * kLog2e;          // scores in log2 units

  const int last_q = min(q0 + kBQ, t) - 1;
  const int k_end = causal ? min(t, last_q + 1) : t;
  const int ntiles = (k_end + kBK - 1) / kBK;

  load_tile<T, DMAX, kBQ>(qs, qb, q0, t, d, vec);
  load_tile<T, DMAX, kBK>(ring, kb, 0, t, d, vec);
  load_tile<T, DMAX, kBK>(ring + kBK * LD, vb, 0, t, d, vec);
  cp_async_commit();

  float o[NO][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * kBK;
    if (j + 1 < ntiles) {   // the stage tile j-1 used, emptied by the sync
      T* next = ring + ((j + 1) & 1) * 2 * kBK * LD;
      load_tile<T, DMAX, kBK>(next, kb, k0 + kBK, t, d, vec);
      load_tile<T, DMAX, kBK>(next + kBK * LD, vb, k0 + kBK, t, d, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile j (and the q tile) visible to every warp

    if (wrow < t) {
      const T* ks = ring + (j & 1) * 2 * kBK * LD;
      const T* vs = ks + kBK * LD;
      float s[kNT][4];
      scores<T, DMAX>(s, qs + 16 * warp * LD, ks, g, tq);

      // s[n][e]: row wrow + g + 8 (e >> 1), key k0 + 8n + 2tq + (e & 1);
      // keys past t (zero rows) and, when causal, past the row are masked
      const bool edge = k0 + kBK > t || (causal && k0 + kBK - 1 > wrow);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * c;
          if (edge) {
            const int key = k0 + 8 * n + 2 * tq + (e & 1);
            const int row = wrow + g + 8 * (e >> 1);
            if (key >= t || (causal && key > row)) x = -INFINITY;
          }
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2], base[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        // m_new == -inf: nothing live yet in this row, keep the (empty) state
        corr[r] = m_new == -INFINITY ? 1.f : exp2f(m[r] - m_new);
        base[r] = m_new == -INFINITY ? 0.f : m_new;
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(s[n][e] - base[e >> 1]);
          l[e >> 1] += p;
          s[n][e] = p;
        }
#pragma unroll
      for (int i = 0; i < NO; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][e] *= corr[e >> 1];
      accumulate<T, DMAX>(o, s, vs, g, tq, lane);
    }
    __syncthreads();   // every warp is done with this stage
  }

  if (wrow >= t) return;
  T* ob = out + slab;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = wrow + g + 8 * r;
    if (row >= t) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* orow = ob + (size_t)row * d;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      const int col = 8 * i + 2 * tq;
      const float a = o[i][2 * r] * inv, b = o[i][2 * r + 1] * inv;
      if (vec && col + 1 < d) {   // d even, out aligned
        from_f32x2(a, b, orow + col);
      } else {
        if (col < d) from_f32(a, orow + col);
        if (col + 1 < d) from_f32(b, orow + col + 1);
      }
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int t, int d, float scale, int causal, int vec,
                   cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<T, DMAX>();
  // above 48 KB a block's shared memory has to be opted into, per kernel
  cudaError_t err = cudaFuncSetAttribute(
      fa_forward_kernel<T, DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((t + kBQ - 1) / kBQ, bh);
  fa_forward_kernel<T, DMAX><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), t, d, scale, causal, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int bh, int t, int d, float scale, int causal,
                     cudaStream_t stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(o);
  const int vec = d % chunk<T>() == 0 && addr % 16 == 0;
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, bh, t, d, scale, causal, vec, stream);
  return launch<T, 128>(q, k, v, o, bh, t, d, scale, causal, vec, stream);
}

}  // namespace

extern "C" {

// q, k, v, out: contiguous (bh, t, d) on `device`; dtype 0 = fp32,
// 1 = bf16, 2 = fp16; 1 <= d <= 128.  Launches on `stream` without
// synchronising and returns cudaGetLastError() (0 on success).
int mxt_flash_attention_fwd(const void* q, const void* k, const void* v,
                            void* out, int bh, int t, int d, float scale,
                            int causal, int dtype, int device, void* stream) {
  if (bh < 1 || t < 1 || d < 1 || d > 128 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: err = launch_d<float>(q, k, v, out, bh, t, d, scale, causal, s); break;
    case 1: err = launch_d<__nv_bfloat16>(q, k, v, out, bh, t, d, scale, causal, s); break;
    case 2: err = launch_d<__half>(q, k, v, out, bh, t, d, scale, causal, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* mxt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
