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
// fp32, int8 (dequantised in the load as q * scale + mid, both fp32
// sidecars of shape (pages, page_size)), or fp8 e4m3 (q * scale).  The
// masked keys of the plain version weigh exactly 0 there, so stopping at p
// changes no result beyond the order of the softmax's sum.
//
// Row stability.  One block per (row, head) handles its queries one after
// another, each with the same code: a query's result depends on its
// position, its row's table and the pools, and on nothing else (not on
// the other rows, on nq, on j or on where the pages lie).  The sums run in
// an order fixed by the key count and the block size.  So the step and
// the verify give the same bits for the same position, and a row's bits do
// not depend on the batch.
//
// What bounds it.  Bytes: every live key and value row is read once per
// (row, head).  GPT-2 small at batch 8 and 640 live positions reads
// 2 x 8 x 640 x 768 x 4 B = 31 MB a layer, 9.4 us at 3.35 TB/s.
//
// Design.  256 threads a block.  Scores: a thread a key, its dot product
// over D in increasing d (one fma chain), into shared memory.  Max and sum:
// per-thread strided partials, then warp shuffles and a fixed fold of the
// warps.  P V: the threads split into 256 / D groups; group g sums keys
// l = g, g + G, ... for its column d, and the groups' partials are folded
// in group order.

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPA = kThreads / 32;

enum Quant { kFp32 = 0, kInt8 = 1, kFp8 = 2 };

template <int Q>
__device__ __forceinline__ float load_kv(const void* pool, size_t idx,
                                         float scale, float mid) {
  if (Q == kFp32) return __ldg(static_cast<const float*>(pool) + idx);
  if (Q == kInt8) {
    const float qv = static_cast<float>(
        __ldg(static_cast<const signed char*>(pool) + idx));
    // two roundings, as the plain version's q * scale + mid
    return __fadd_rn(__fmul_rn(qv, scale), mid);
  }
  const __nv_fp8_storage_t b = static_cast<__nv_fp8_storage_t>(
      __ldg(static_cast<const unsigned char*>(pool) + idx));
  const __half_raw hr = __nv_cvt_fp8_to_halfraw(b, __NV_E4M3);
  return __fmul_rn(__half2float(__half(hr)), scale);
}

// sum (op = 0) or max (op = 1) of one value per thread, in a fixed order;
// every thread gets the result
template <int kOp>
__device__ __forceinline__ float block_reduce(float val, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, val, off);
    val = kOp ? fmaxf(val, o) : val + o;
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = val;
  __syncthreads();
  float t = red[0];
  for (int i = 1; i < kWarpsPA; ++i) t = kOp ? fmaxf(t, red[i]) : t + red[i];
  __syncthreads();
  return t;
}

template <int Q>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q, const void* k_pool,
                       const void* v_pool, const float* __restrict__ k_scale,
                       const float* __restrict__ k_mid,
                       const float* __restrict__ v_scale,
                       const float* __restrict__ v_mid,
                       const int* __restrict__ tables,
                       const int* __restrict__ positions,
                       float* __restrict__ out, int nq, int heads, int d,
                       int page_size, int n_tab) {
  extern __shared__ float smem[];
  const int lctx = n_tab * page_size;
  float* sc = smem;                      // [lctx] scores, then weights
  float* qs = sc + lctx;                 // [d]
  float* part = qs + d;                  // [kThreads]
  float* red = part + kThreads;          // [kWarpsPA]
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int* table = tables + (size_t)b * n_tab;
  const size_t row = (size_t)heads * d;  // one token's K (or V) row
  const int groups = kThreads / d;       // P V groups (d <= 128)
  const int gi = tid / d, dd = tid % d;

  for (int j = 0; j < nq; ++j) {
    const int p = positions[b] + j;
    const int nk = max(0, min(p + 1, lctx));
    const size_t qoff = (((size_t)b * nq + j) * heads + h) * d;
    for (int i = tid; i < d; i += kThreads) qs[i] = q[qoff + i];
    __syncthreads();
    // scores
    float m = -INFINITY;
    for (int l = tid; l < nk; l += kThreads) {
      const int page = table[l / page_size];
      const int off = l % page_size;
      const size_t slot = (size_t)page * page_size + off;
      const float ks = Q == kFp32 ? 1.f : k_scale[slot];
      const float km = Q == kInt8 ? k_mid[slot] : 0.f;
      const size_t base = slot * row + (size_t)h * d;
      float s = 0.f;
      for (int e = 0; e < d; ++e)
        s = fmaf(qs[e], load_kv<Q>(k_pool, base + e, ks, km), s);
      sc[l] = s;
      m = fmaxf(m, s);
    }
    m = block_reduce<1>(m, red);
    float sum = 0.f;
    for (int l = tid; l < nk; l += kThreads) {
      const float e = expf(sc[l] - m);
      sc[l] = e;
      sum += e;
    }
    sum = block_reduce<0>(sum, red);
    // P V
    float acc = 0.f;
    if (gi < groups) {
      for (int l = gi; l < nk; l += groups) {
        const int page = table[l / page_size];
        const int off = l % page_size;
        const size_t slot = (size_t)page * page_size + off;
        const float vs = Q == kFp32 ? 1.f : v_scale[slot];
        const float vm = Q == kInt8 ? v_mid[slot] : 0.f;
        const float vv = load_kv<Q>(v_pool, slot * row + (size_t)h * d + dd,
                                    vs, vm);
        acc = fmaf(sc[l] / sum, vv, acc);
      }
    }
    part[tid] = acc;
    __syncthreads();
    if (tid < d) {
      float t = 0.f;
      for (int g = 0; g < groups; ++g) t = t + part[g * d + tid];
      out[qoff + tid] = t;
    }
    __syncthreads();
  }
}

template <int Q>
cudaError_t launch(const float* q, const void* kp, const void* vp,
                   const float* ks, const float* km, const float* vs,
                   const float* vm, const int* tables, const int* positions,
                   float* out, int b, int nq, int heads, int d, int page_size,
                   int n_tab, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)n_tab * page_size + d + kThreads + kWarpsPA);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<Q>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(heads, b);
  paged_attention_kernel<Q><<<grid, kThreads, smem, stream>>>(
      q, kp, vp, ks, km, vs, vm, tables, positions, out, nq, heads, d,
      page_size, n_tab);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (b, nq, heads, d) fp32 from q (b, nq, heads, d) fp32 (already scaled)
// and one layer's pools k_pool / v_pool (pages, page_size, heads, d):
// quant 0 fp32; 1 int8 with k_scale, k_mid, v_scale, v_mid (pages,
// page_size) fp32; 2 fp8 e4m3 (bytes) with k_scale, v_scale.  tables
// (b, n_tab) and positions (b,) int32.  All contiguous, d <= 128.
// Returns a cudaError_t (0 on success).
int mxt_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                        const void* k_scale, const void* k_mid,
                        const void* v_scale, const void* v_mid,
                        const void* tables, const void* positions, void* out,
                        int b, int nq, int heads, int d, int page_size,
                        int n_tab, int quant, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0 || nq <= 0 || heads <= 0) return 0;
  if (d < 1 || d > 128) return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const float* ks = static_cast<const float*>(k_scale);
  const float* km = static_cast<const float*>(k_mid);
  const float* vs = static_cast<const float*>(v_scale);
  const float* vm = static_cast<const float*>(v_mid);
  const int* t = static_cast<const int*>(tables);
  const int* p = static_cast<const int*>(positions);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (quant) {
    case kFp32:
      err = launch<kFp32>(qf, k_pool, v_pool, ks, km, vs, vm, t, p, o, b, nq,
                          heads, d, page_size, n_tab, s);
      break;
    case kInt8:
      err = launch<kInt8>(qf, k_pool, v_pool, ks, km, vs, vm, t, p, o, b, nq,
                          heads, d, page_size, n_tab, s);
      break;
    case kFp8:
      err = launch<kFp8>(qf, k_pool, v_pool, ks, km, vs, vm, t, p, o, b, nq,
                         heads, d, page_size, n_tab, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"
