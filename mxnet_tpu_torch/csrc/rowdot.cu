// Row-stable fp32 contraction y = x . w (+ bias) for Hopper (sm_90a), CUDA
// C++ with a plain C interface, loaded by mxnet_tpu_torch/ops/_build.py
// through ctypes.
//
// Replaces no TPU kernel: the JAX package's `rowdot`
// (mxnet_tpu/serving/decode/model.py:41-47) is a broadcast-multiply and
// reduce that XLA fuses.  It exists because decode serving promises that a
// request's tokens do not depend on who shares its batch, and neither
// cuBLAS (kernel and split-K chosen by shape) nor torch's reductions (split
// chosen by the number of outputs) keep a row's bits when the row count
// changes.
//
// The contract.  Every output y[r, c] is
//     t = 0;  for k = 0 .. ceil(U / 64) - 1:  t = t + p_k
//     p_k = fma chain over u = 64k .. min(64k + 64, U) - 1, in increasing u,
//           starting from 0:  p = fmaf(x[r, u], w[u, c], p)
//     y = t (+ bias[c])
// a sequence of fp32 operations fixed by U alone: not by N, by the row's
// index, by the tile it lands in, by the row-block size R or by the
// orientation of w.  So row r of an N-row call equals a 1-row call bit for
// bit.  FMA in fp32 throughout, no TF32.
//
// Both regimes below keep that order exactly.  Tiles are staged in shared
// memory with zeros past U (and past N and V); an fma over a zero pair
// leaves a partial unchanged but for the sign of a zero, and t, which
// starts at +0 and only ever adds, is never -0, so t + p is the same for
// either zero.  Which regime runs, and how its work is cut into blocks,
// changes which block computes an output, never its operations.
//
// What bounds it on an H100 (132 SMs, 3.35 TB/s, 67 TFLOP/s fp32 FMA).
//
// Decode and verify (N <= 40 rows): bytes.  The weights are read once per
// call, 2 N flops a weight against the card's 20 flops a byte at the
// balance point; GPT-2 small's step reads 494 MB in 49 calls (0.15 ms).
// A byte-bound call needs every SM streaming with many loads in flight:
// a layer's matrix has only 12-48 column tiles of 64, too few for 132
// SMs.  So a block owns 64 columns and a run of the 64-long chunks of U
// (the split): each block stages its chunks of w (and of x) through a
// four-deep cp.async ring of 16-byte copies along the contiguous axis of
// either orientation, so up to three chunks (48 KB of w) are in flight a
// block.  The split is chosen so that the grid is about two blocks an SM
// and is used only where the column tiles alone do not fill the card (the
// logits product has 786 tiles and does not split).  The chunk partials
// of a split column tile are folded in chunk order inside the same
// launch: split 0 folds its own chunks into t as it goes (the contract's
// prefix); the others write each chunk's partial to a workspace; the last
// block of the tile to finish (a ticket counter, reset by that block)
// continues the fold from split 0's t over the other chunks in order.
// Thread (c, g) of 256 owns column c of 64 and rows g, g + 4, ...: it
// reads its column's w from shared memory once for all its rows, and x as
// a broadcast.
//
// Prefill (N = B x S rows, up to 4096): operations on the FMA pipes, the
// tensor cores being excluded by the contract.  A register-tiled SGEMM:
// a block of 256 threads owns a 96 x 128 output tile, each thread 6 x 8
// outputs (rows ty + 16 i; columns 4 tx + 64 h + q of a row-major w, or
// tx + 16 j of the transposed view, read along u), so no read of shared
// memory conflicts in the row-major case.  x and w tiles of 32 u (half a
// chunk) are staged in shared memory through a double-buffered cp.async
// ring.  Each 4 u a thread reads 6 float4 of x (two distinct addresses a
// warp: a broadcast) and 8 float4 of a row-major w (32 floats of the
// transposed view), for 192 FMAs.  The 48
// accumulators restart at 0 at each chunk and are added into the
// thread's 48 running totals at its end: the contract's p_k and t.  The
// totals live in shared memory (a float4 read and write per 4 outputs
// per chunk), so a thread needs at most 128 registers and two blocks
// share an SM: 16 warps hide the loads' latency, and the 96-row tile
// fills the last wave of GPT-2's prefill shapes (258 tiles of 768
// columns on 264 slots) where 128 rows left a third of it idle.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;           // the contract's chunk length
constexpr int kThreads = 256;

// --------------------------------------------------------------- cp.async
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// kVec: 16 bytes (src_bytes 0 writes zeros); else 4 bytes
template <bool kVec>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool in) {
  if (kVec)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(smem_addr(dst)), "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 ::"r"(smem_addr(dst)), "l"(src), "r"(in ? 4 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy a tile of `rows` x `cols` floats at (r0, c0) of a row-major
// (nr, nc) matrix into shared memory with row stride `ld`, zeros outside
// the matrix.  kVec: 16-byte granules (nc % 4 == 0, 16-byte aligned base).
template <bool kVec, int kRows, int kCols>
__device__ __forceinline__ void stage(float* dst, int ld,
                                      const float* __restrict__ src, int nr,
                                      int nc, int r0, int c0) {
  constexpr int kG = kVec ? 4 : 1;
  constexpr int kPerRow = kCols / kG;
  for (int i = threadIdx.x; i < kRows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kG;
    const int gr = r0 + r, gc = c0 + c;
    const bool in = gr < nr && gc < nc;
    cp_async<kVec>(dst + r * ld + c,
                   in ? src + (size_t)gr * nc + gc : src, in);
  }
}

// ------------------------------------------------------ decode and verify
constexpr int kDCols = 64;           // columns a block
constexpr int kDStages = 4;
constexpr int kDLdT = kChunk + 4;    // row stride of a transposed w tile

template <bool kTrans>
__host__ __device__ constexpr int d_w_floats() {
  return kTrans ? kDCols * kDLdT : kChunk * kDCols;
}
template <bool kTrans, int RT>
__host__ __device__ constexpr int d_stage_floats() {
  return d_w_floats<kTrans>() + 4 * RT * kChunk;
}

// grid (column tiles, splits); split s takes chunks [s cps, (s + 1) cps)
template <bool kTrans, bool kVec, int RT>
__global__ void __launch_bounds__(kThreads)
rowdot_split_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ y,
                    float* __restrict__ ws, int* __restrict__ tickets, int n,
                    int u, int v, int cps) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kStage = d_stage_floats<kTrans, RT>();
  const int tile = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int c0 = tile * kDCols;
  const int n_chunks = (u + kChunk - 1) / kChunk;
  const int kb = split * cps;
  const int nk = min(cps, n_chunks - kb);
  const int c = threadIdx.x % kDCols, g = threadIdx.x / kDCols;

  auto fetch = [&](int i) {
    float* s = smem + (i % kDStages) * kStage;
    const int u0 = (kb + i) * kChunk;
    if (kTrans)       // w is (v, u) row-major: 64 columns' runs of u
      stage<kVec, kDCols, kChunk>(s, kDLdT, w, v, u, c0, u0);
    else              // w is (u, v) row-major: 64 rows of 64 columns
      stage<kVec, kChunk, kDCols>(s, kDCols, w, u, v, u0, c0);
    stage<kVec, 4 * RT, kChunk>(s + d_w_floats<kTrans>(), kChunk, x, n, u,
                                0, u0);
  };

  for (int i = 0; i < kDStages - 1; ++i) {
    if (i < nk) fetch(i);
    cp_async_commit();
  }
  float t[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) t[i] = 0.f;
  float* part = ws + (size_t)tile * n_chunks * n * kDCols;

  for (int i = 0; i < nk; ++i) {
    if (i + kDStages - 1 < nk) fetch(i + kDStages - 1);
    cp_async_commit();
    cp_async_wait<kDStages - 1>();
    __syncthreads();
    const float* sw = smem + (i % kDStages) * kStage;
    const float* sx = sw + d_w_floats<kTrans>();
    float p[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) p[r] = 0.f;
#pragma unroll 4
    for (int uu = 0; uu < kChunk; uu += 4) {
      float w0, w1, w2, w3;
      if (kTrans) {
        const float4 w4 = *reinterpret_cast<const float4*>(
            sw + c * kDLdT + uu);
        w0 = w4.x; w1 = w4.y; w2 = w4.z; w3 = w4.w;
      } else {
        w0 = sw[uu * kDCols + c];
        w1 = sw[(uu + 1) * kDCols + c];
        w2 = sw[(uu + 2) * kDCols + c];
        w3 = sw[(uu + 3) * kDCols + c];
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float4 x4 = *reinterpret_cast<const float4*>(
            sx + (g + 4 * r) * kChunk + uu);
        float a = p[r];
        a = fmaf(x4.x, w0, a);
        a = fmaf(x4.y, w1, a);
        a = fmaf(x4.z, w2, a);
        a = fmaf(x4.w, w3, a);
        p[r] = a;
      }
    }
    if (split == 0) {                    // the contract's prefix: fold now
#pragma unroll
      for (int r = 0; r < RT; ++r) t[r] = t[r] + p[r];
    } else {
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int row = g + 4 * r;
        if (row < n) part[((size_t)(kb + i) * n + row) * kDCols + c] = p[r];
      }
    }
    __syncthreads();                     // the slot is refilled next
  }

  if (splits > 1) {
    __shared__ int last;
    if (split == 0) {                    // hand t over in its last slot
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int row = g + 4 * r;
        if (row < n) part[((size_t)(nk - 1) * n + row) * kDCols + c] = t[r];
      }
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      last = atomicAdd(tickets + tile, 1) == splits - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    const int k0 = min(cps, n_chunks);   // split 0's chunks
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int row = g + 4 * r;
      t[r] = row < n ? __ldcg(part + ((size_t)(k0 - 1) * n + row) * kDCols
                              + c) : 0.f;
    }
    // the adds are serial, the loads are not: kBatch chunks' partials in
    // flight at a time, then added in chunk order
    constexpr int kBatch = RT >= 8 ? 2 : 16 / RT;
    for (int k = k0; k < n_chunks; k += kBatch) {
      float q[kBatch][RT];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const int row = g + 4 * r;
          q[j][r] = row < n && k + j < n_chunks
              ? __ldcg(part + ((size_t)(k + j) * n + row) * kDCols + c)
              : 0.f;
        }
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
#pragma unroll
        for (int r = 0; r < RT; ++r)
          if (k + j < n_chunks) t[r] = t[r] + q[j][r];
    }
    if (threadIdx.x == 0) tickets[tile] = 0;   // ready for the next call
  }
  const int col = c0 + c;
  if (col >= v) return;
  const float b = bias != nullptr ? bias[col] : 0.f;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int row = g + 4 * r;
    if (row < n) y[(size_t)row * v + col] = bias != nullptr ? t[r] + b : t[r];
  }
}

// ---------------------------------------------------------------- prefill
constexpr int kPCols = 128, kPK = 32, kPStages = 2, kRI = 6;
constexpr int kPRows = 16 * kRI;     // a thread's rows: ty + 16 i, i < kRI
constexpr int kPLd = kPK + 4;        // row stride of a tile read along u
constexpr int kPOut = kRI * 8;       // a thread's outputs

template <bool kTrans>
__host__ __device__ constexpr int p_w_floats() {
  return kTrans ? kPCols * kPLd : kPK * kPCols;
}
template <bool kTrans>
__host__ __device__ constexpr int p_stage_floats() {
  return kPRows * kPLd + p_w_floats<kTrans>();
}
// the ring, then each thread's running totals t
template <bool kTrans>
__host__ __device__ constexpr int p_smem_floats() {
  return kPStages * p_stage_floats<kTrans>() + kPOut * kThreads;
}

// grid (column tiles, row tiles); two blocks an SM (registers capped at
// 128 a thread), so the running totals live in shared memory
template <bool kTrans, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
rowdot_tiled_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ y,
                    int n, int u, int v) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kStage = p_stage_floats<kTrans>();
  float4* ts = reinterpret_cast<float4*>(smem + kPStages * kStage) +
               threadIdx.x;            // t[4 k .. 4 k + 3] at ts[k * 256]
  const int c0 = blockIdx.x * kPCols, r0 = blockIdx.y * kPRows;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_tiles = (u + kPK - 1) / kPK;

  auto fetch = [&](int kt) {
    float* s = smem + (kt % kPStages) * kStage;
    const int u0 = kt * kPK;
    stage<kVec, kPRows, kPK>(s, kPLd, x, n, u, r0, u0);
    if (kTrans)
      stage<kVec, kPCols, kPK>(s + kPRows * kPLd, kPLd, w, v, u, c0, u0);
    else
      stage<kVec, kPK, kPCols>(s + kPRows * kPLd, kPCols, w, u, v, u0, c0);
  };

  for (int i = 0; i < kPStages - 1; ++i) {
    if (i < n_tiles) fetch(i);
    cp_async_commit();
  }
#pragma unroll
  for (int k = 0; k < kPOut / 4; ++k)
    ts[k * kThreads] = make_float4(0.f, 0.f, 0.f, 0.f);
  float acc[kRI][8];

  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + kPStages - 1 < n_tiles) fetch(kt + kPStages - 1);
    cp_async_commit();
    cp_async_wait<kPStages - 1>();
    __syncthreads();
    const float* sx = smem + (kt % kPStages) * kStage;
    const float* sw = sx + kPRows * kPLd;
    if (kt % 2 == 0) {                   // a chunk starts: p = 0
#pragma unroll
      for (int i = 0; i < kRI; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
#pragma unroll
    for (int uu = 0; uu < kPK; uu += 4) {
      float4 a[kRI];
#pragma unroll
      for (int i = 0; i < kRI; ++i)
        a[i] = *reinterpret_cast<const float4*>(sx + (ty + 16 * i) * kPLd
                                                + uu);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float bj[8];
        if (kTrans) {                    // column tx + 16 j, along u
#pragma unroll
          for (int j = 0; j < 8; ++j)
            bj[j] = sw[(tx + 16 * j) * kPLd + uu + q];
        } else {                         // columns 4 tx + (0, 64) + 0..3
          const float4 b0 = *reinterpret_cast<const float4*>(
              sw + (uu + q) * kPCols + 4 * tx);
          const float4 b1 = *reinterpret_cast<const float4*>(
              sw + (uu + q) * kPCols + 4 * tx + 64);
          bj[0] = b0.x; bj[1] = b0.y; bj[2] = b0.z; bj[3] = b0.w;
          bj[4] = b1.x; bj[5] = b1.y; bj[6] = b1.z; bj[7] = b1.w;
        }
#pragma unroll
        for (int i = 0; i < kRI; ++i) {
          const float ai = q == 0 ? a[i].x : q == 1 ? a[i].y
                         : q == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(ai, bj[j], acc[i][j]);
        }
      }
    }
    if (kt % 2 == 1 || kt == n_tiles - 1) {   // the chunk ends: t += p
#pragma unroll
      for (int k = 0; k < kPOut / 4; ++k) {
        float4 t4 = ts[k * kThreads];
        const int i = 4 * k / 8, j = 4 * k % 8;
        t4.x = t4.x + acc[i][j];
        t4.y = t4.y + acc[i][j + 1];
        t4.z = t4.z + acc[i][j + 2];
        t4.w = t4.w + acc[i][j + 3];
        ts[k * kThreads] = t4;
      }
    }
    __syncthreads();                     // the slot is refilled next
  }

#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= n) break;
    float* yr = y + (size_t)row * v;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 t4 = ts[(2 * i + h) * kThreads];
      const float tv[4] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = 4 * h + q;
        const int col = c0 + (kTrans ? tx + 16 * j : 4 * tx + 64 * h + q);
        if (col < v) yr[col] = bias != nullptr ? tv[q] + bias[col] : tv[q];
      }
    }
  }
}

// ------------------------------------------------------------------ host
int sm_count(int device) {
  static int cache[64];
  if (device < 0 || device >= 64) return 132;
  if (!cache[device]) {
    int val = 0;
    if (cudaDeviceGetAttribute(&val, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess || val < 1)
      val = 132;
    cache[device] = val;
  }
  return cache[device];
}

// above 48 KB a block's shared memory has to be opted into, per kernel and
// device
template <auto kKernel>
cudaError_t allow_smem(int bytes, int device) {
  static uint64_t done = 0;             // one per kernel
  const uint64_t bit = device < 64 ? 1ull << device : 0;
  if (bit && (done & bit)) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done |= bit;
  return err;
}

template <bool kTrans, bool kVec, int RT>
cudaError_t launch_split(const float* x, const float* w, const float* bias,
                         float* y, float* ws, int* tickets, int n, int u,
                         int v, int splits, int device, cudaStream_t s) {
  const int n_chunks = (u + kChunk - 1) / kChunk;
  const int cps = (n_chunks + splits - 1) / splits;
  splits = (n_chunks + cps - 1) / cps;
  const int stages = cps < kDStages ? cps : kDStages;
  const int bytes = stages * d_stage_floats<kTrans, RT>() * 4;
  cudaError_t err = allow_smem<rowdot_split_kernel<kTrans, kVec, RT>>(
      kDStages * d_stage_floats<kTrans, RT>() * 4, device);
  if (err != cudaSuccess) return err;
  const dim3 grid((v + kDCols - 1) / kDCols, splits);
  rowdot_split_kernel<kTrans, kVec, RT><<<grid, kThreads, bytes, s>>>(
      x, w, bias, y, ws, tickets, n, u, v, cps);
  return cudaGetLastError();
}

template <bool kTrans, bool kVec>
cudaError_t launch_tiled(const float* x, const float* w, const float* bias,
                         float* y, int n, int u, int v, int device,
                         cudaStream_t s) {
  const int bytes = p_smem_floats<kTrans>() * 4;
  cudaError_t err = allow_smem<rowdot_tiled_kernel<kTrans, kVec>>(bytes,
                                                                  device);
  if (err != cudaSuccess) return err;
  const dim3 grid((v + kPCols - 1) / kPCols, (n + kPRows - 1) / kPRows);
  rowdot_tiled_kernel<kTrans, kVec><<<grid, kThreads, bytes, s>>>(
      x, w, bias, y, n, u, v);
  return cudaGetLastError();
}

template <bool kTrans, bool kVec>
cudaError_t launch_split_rt(const float* x, const float* w,
                            const float* bias, float* y, float* ws,
                            int* tickets, int n, int u, int v, int splits,
                            int device, cudaStream_t s) {
  if (n <= 8)
    return launch_split<kTrans, kVec, 2>(x, w, bias, y, ws, tickets, n, u,
                                         v, splits, device, s);
  if (n <= 16)
    return launch_split<kTrans, kVec, 4>(x, w, bias, y, ws, tickets, n, u,
                                         v, splits, device, s);
  return launch_split<kTrans, kVec, 10>(x, w, bias, y, ws, tickets, n, u, v,
                                        splits, device, s);
}

constexpr int kMaxSplitRows = 40;

}  // namespace

extern "C" {

// y (n, v) = x (n, u) . w (+ bias (v,), may be null), all fp32 and
// contiguous.  trans = 0: w is (u, v) row-major; trans = 1: w is (v, u)
// row-major (the product with its transpose).  ws (ws_floats floats) and
// tickets (n_tickets ints, all zero, left zero) are the caller's scratch
// for split column tiles.  plan: 0 chooses the regime (split for
// n <= 40, else tiled) and the split; k > 0 asks for k splits (cut to
// the chunks and to what the scratch holds), -1 the tiled regime for any
// n.  Writes the regime (0 split, 1 tiled) and the splits used to
// used[0..1] when used is not null.
// Returns a cudaError_t (0 on success).
int mxt_rowdot(const void* x, const void* w, const void* bias, void* y,
               int n, int u, int v, int trans, void* ws,
               long long ws_floats, void* tickets, int n_tickets, int plan,
               int* used, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || v <= 0) return 0;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  float* yf = static_cast<float*>(y);
  float* wsf = static_cast<float*>(ws);
  int* tk = static_cast<int*>(tickets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte copies along the contiguous axis of x and of w
  const bool vec = u % 4 == 0 && (trans || v % 4 == 0) &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bool tiled = plan < 0 || n > kMaxSplitRows;
  int splits = 1;
  if (!tiled) {
    const int tiles = (v + kDCols - 1) / kDCols;
    const int n_chunks = (u + kChunk - 1) / kChunk;
    const int sms = sm_count(device);
    if (plan > 0)
      splits = plan;
    else if (tiles < sms)                // two blocks an SM
      splits = (2 * sms + tiles - 1) / tiles;
    if (splits > n_chunks) splits = n_chunks;
    if (tiles > n_tickets ||
        (long long)tiles * n_chunks * n * kDCols > ws_floats)
      splits = 1;
    if (splits > 1) {                    // as launch_split rounds it
      const int cps = (n_chunks + splits - 1) / splits;
      splits = (n_chunks + cps - 1) / cps;
    }
  }
  if (used != nullptr) {
    used[0] = tiled ? 1 : 0;
    used[1] = tiled ? 1 : splits;
  }
  if (tiled) {
    err = trans ? (vec ? launch_tiled<true, true>(xf, wf, bf, yf, n, u, v,
                                                  device, s)
                       : launch_tiled<true, false>(xf, wf, bf, yf, n, u, v,
                                                   device, s))
                : (vec ? launch_tiled<false, true>(xf, wf, bf, yf, n, u, v,
                                                   device, s)
                       : launch_tiled<false, false>(xf, wf, bf, yf, n, u, v,
                                                    device, s));
  } else if (trans) {
    err = vec ? launch_split_rt<true, true>(xf, wf, bf, yf, wsf, tk, n, u, v,
                                            splits, device, s)
              : launch_split_rt<true, false>(xf, wf, bf, yf, wsf, tk, n, u,
                                             v, splits, device, s);
  } else {
    err = vec ? launch_split_rt<false, true>(xf, wf, bf, yf, wsf, tk, n, u,
                                             v, splits, device, s)
              : launch_split_rt<false, false>(xf, wf, bf, yf, wsf, tk, n, u,
                                              v, splits, device, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
