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
// What bounds it.  Decode (N <= 8 rows) must read the weights once:
// GPT-2 small's logits product over the tied embedding reads 50257 x 768
// fp32 = 154 MB, 46 us at 3.35 TB/s, for 2 N U V = 0.6 GFLOP (9 us on the
// 67 TFLOP/s FMA pipes).  Bytes bound it.  Prefill (N = B x S rows) is
// bound by operations on the FMA pipes: this kernel keeps the fixed chain
// and does not use the tensor cores.
//
// Design.  A block owns 32 output columns and R rows and loads each weight
// once for its R rows.  Its 8 warps take the 64-long chunks of U in turns
// (warp g takes chunks g, g + 8, ...): lane c keeps R partial sums p_k for
// column c in registers, one round of 8 chunks at a time; the round's
// partials go to shared memory, and one thread per output folds them into
// its running total t in chunk order.  w comes in either orientation:
// (U, V) row-major, where a warp reads 32 neighbouring columns of one row
// (128 coalesced bytes), or (V, U) row-major (the tied embedding, used as
// embed.T for the logits, never transposed in memory), where a lane walks
// its own column's row of U in 16-byte loads.  x rows are read with
// warp-uniform (broadcast) loads, 16 bytes at a time when U % 4 == 0 and
// every row is 16-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;              // output columns a block
constexpr int kWarps = 8;              // chunk groups
constexpr int kThreads = kCols * kWarps;
constexpr int kChunk = 64;             // the contract's chunk length

template <bool kTrans>
__device__ __forceinline__ float load_w(const float* __restrict__ w, int u,
                                        int v, int uu, int col) {
  return kTrans ? __ldg(w + (size_t)col * u + uu)
                : __ldg(w + (size_t)uu * v + col);
}

template <int R, bool kTrans, bool kVec>
__global__ void __launch_bounds__(kThreads)
rowdot_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ bias, float* __restrict__ y, int n,
              int u, int v) {
  constexpr int kOut = R * kCols / kThreads > 0 ? R * kCols / kThreads : 1;
  __shared__ float part[kWarps][R][kCols + 1];
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  const int c0 = blockIdx.x * kCols;
  const int r0 = blockIdx.y * R;
  // this lane's column, clamped so that the last block's spare lanes read
  // a valid column (their sums are never written)
  const int col = min(c0 + lane, v - 1);
  const int n_chunks = (u + kChunk - 1) / kChunk;
  const float* xr[R];
#pragma unroll
  for (int r = 0; r < R; ++r)            // spare rows re-read the last row
    xr[r] = x + (size_t)min(r0 + r, n - 1) * u;

  float total[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) total[i] = 0.f;

  for (int round = 0; round * kWarps < n_chunks; ++round) {
    const int k = round * kWarps + g;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    if (k < n_chunks) {
      const int ub = k * kChunk;
      const int ue = min(ub + kChunk, u);
      if (kVec) {
        for (int uu = ub; uu < ue; uu += 4) {
          float w0, w1, w2, w3;
          if (kTrans) {
            const float4 w4 = __ldg(reinterpret_cast<const float4*>(
                w + (size_t)col * u + uu));
            w0 = w4.x; w1 = w4.y; w2 = w4.z; w3 = w4.w;
          } else {
            w0 = load_w<false>(w, u, v, uu, col);
            w1 = load_w<false>(w, u, v, uu + 1, col);
            w2 = load_w<false>(w, u, v, uu + 2, col);
            w3 = load_w<false>(w, u, v, uu + 3, col);
          }
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float4 x4 = __ldg(reinterpret_cast<const float4*>(
                xr[r] + uu));
            float a = acc[r];
            a = fmaf(x4.x, w0, a);
            a = fmaf(x4.y, w1, a);
            a = fmaf(x4.z, w2, a);
            a = fmaf(x4.w, w3, a);
            acc[r] = a;
          }
        }
      } else {
        for (int uu = ub; uu < ue; ++uu) {
          const float wv = load_w<kTrans>(w, u, v, uu, col);
#pragma unroll
          for (int r = 0; r < R; ++r)
            acc[r] = fmaf(__ldg(xr[r] + uu), wv, acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) part[g][r][lane] = acc[r];
    __syncthreads();
    const int groups = min(kWarps, n_chunks - round * kWarps);
#pragma unroll
    for (int i = 0; i < kOut; ++i) {
      const int o = threadIdx.x + i * kThreads;
      if (o < R * kCols) {
        const int r = o / kCols, c = o % kCols;
        float t = total[i];
        for (int gg = 0; gg < groups; ++gg) t = t + part[gg][r][c];
        total[i] = t;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kOut; ++i) {
    const int o = threadIdx.x + i * kThreads;
    if (o < R * kCols) {
      const int r = r0 + o / kCols, c = c0 + o % kCols;
      if (r < n && c < v) {
        float t = total[i];
        if (bias != nullptr) t = t + bias[c];
        y[(size_t)r * v + c] = t;
      }
    }
  }
}

template <int R, bool kTrans, bool kVec>
cudaError_t launch(const float* x, const float* w, const float* bias,
                   float* y, int n, int u, int v, cudaStream_t stream) {
  const dim3 grid((v + kCols - 1) / kCols, (n + R - 1) / R);
  rowdot_kernel<R, kTrans, kVec><<<grid, kThreads, 0, stream>>>(
      x, w, bias, y, n, u, v);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_r(const float* x, const float* w, const float* bias,
                     float* y, int n, int u, int v, int trans, int vec,
                     cudaStream_t s) {
  if (trans)
    return vec ? launch<R, true, true>(x, w, bias, y, n, u, v, s)
               : launch<R, true, false>(x, w, bias, y, n, u, v, s);
  return vec ? launch<R, false, true>(x, w, bias, y, n, u, v, s)
             : launch<R, false, false>(x, w, bias, y, n, u, v, s);
}

}  // namespace

extern "C" {

// y (n, v) = x (n, u) . w (+ bias (v,), may be null), all fp32 and
// contiguous.  trans = 0: w is (u, v) row-major; trans = 1: w is (v, u)
// row-major (the product with its transpose).  vec = 1 asks for 16-byte
// loads along u: u % 4 == 0 and x (and w when trans) 16-byte aligned; the
// wrapper checks.  Returns a cudaError_t (0 on success).
int mxt_rowdot(const void* x, const void* w, const void* bias, void* y,
               int n, int u, int v, int trans, int vec, int device,
               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || v <= 0) return 0;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  float* yf = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the row block: decode's few rows in one block, more rows in blocks
  // of 32 (the arithmetic per output is the same for every R)
  if (n == 1) err = launch_r<1>(xf, wf, bf, yf, n, u, v, trans, vec, s);
  else if (n == 2) err = launch_r<2>(xf, wf, bf, yf, n, u, v, trans, vec, s);
  else if (n <= 4) err = launch_r<4>(xf, wf, bf, yf, n, u, v, trans, vec, s);
  else if (n <= 8) err = launch_r<8>(xf, wf, bf, yf, n, u, v, trans, vec, s);
  else err = launch_r<32>(xf, wf, bf, yf, n, u, v, trans, vec, s);
  return static_cast<int>(err);
}

}  // extern "C"
