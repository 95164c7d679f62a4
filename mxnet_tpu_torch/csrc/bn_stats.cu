// BatchNorm batch statistics for Hopper (sm_90a), CUDA C++ with a plain C
// interface, loaded by mxnet_tpu_torch/ops/_build.py through ctypes.
//
// Replaces: benchmark/pallas_bn_stats.py `bn_stats_kernel` (:62-85), launched
// through `pl.pallas_call` by `pallas_stats` (:91).  Same function: per
// channel c of an NCHW activation, sum(x - p) and sum((x - p)^2) over N*H*W
// in one pass with fp32 accumulation, folded into mean = p + E[x - p] and the
// biased var = max(E[(x - p)^2] - E[x - p]^2, 0).  p is an optional
// per-channel shift: p = 0 is the TPU kernel's function exactly; the
// training path passes p = x[0, c, 0, 0] (the pivot of
// mxnet_tpu/ops/nn.py:285-296), which keeps the subtraction from cancelling
// when |mean| >> std.
//
// What bounds it.  One read of the activation and nothing else: at
// ResNet-50's largest BatchNorm input, (32, 64, 112, 112) fp32, 103 MB, 31 us
// at 3.35 TB/s; the outputs are a few KB.  Three flops an element are far
// below the fp32 rate, so bytes bound it.
//
// Design.  The TPU kernel walks one sequential grid and carries (C, 128)
// accumulators from step to step; blocks here run in parallel and in no
// order, so the sum is split in two deterministic stages instead of atomics
// (two runs give the same bits):
//  - stage 1: a (C, S) grid.  Block (c, s) reduces the s-th of S equal
//    slices of channel c's N*H*W elements.  S is chosen by the wrapper so
//    that C*S fills the card: at (32, 64, 112, 112) one block per channel
//    would be 64 blocks on 132 SMs.  Each thread strides over the slice in
//    V-element vectors (16 bytes: V = 4 fp32 or 8 bf16/fp16 when H*W and the
//    base address allow it, else 2 or 1: 7x7 = 49 takes the scalar path,
//    still coalesced), accumulates in fp32 registers, and the block reduces
//    with warp shuffles and one shared-memory step in a fixed order.  Each
//    block writes its (sum, sumsq) pair to a partials buffer.
//  - stage 2: one thread per channel adds its S partials in order, in
//    double, and writes mean and var.
// Simple and correct; no TMA or persistent blocks yet.
//
// Channels-last entry (mxt_bn_stats_cl).  NHWC data, or NCHW-shaped data in
// torch.channels_last memory format, is a row-major (M, C) matrix with
// M = N*H*W, which the TPU kernel never read.  The same function is computed
// with the same pivot (the first row, x[0, 0, 0, c], the element the NCHW
// route uses), the same stage 2 and so the same determinism:
//  - stage 1: a (ceil(C / (W*V)), S) grid of 256-thread blocks.  A block
//    spans W*V consecutive channels (W a power of two <= 256, V elements a
//    16/8/4/2/1-byte load): thread t loads vector t % W of rows t / W,
//    t / W + 256 / W, ... of its row slice, so neighbouring lanes read
//    neighbouring addresses and a warp reads whole lines (at C = 64 fp32,
//    W = 16: two adjacent 256-byte rows a warp).  Each thread carries its V
//    channels' sums in registers; the block folds its 256 / W row lanes
//    through shared memory in a fixed order and writes its (sum, sumsq)
//    pairs to partial[(s * C + c) * 2], channel-minor, so that stage 2 reads
//    them in whole lines.
//  - stage 2 (bn_stats_fold_cl): where NCHW folds at most a few dozen
//    partials a channel, a small C here takes S ~ 1,000 row slices to fill
//    the card (C = 64 at M = 401,408: one column block, so S = 1,056), and
//    one thread adding 1,056 partials in a row waits on 1,056 loads: the
//    first version of this entry did that and took 0.09-0.19 ms a tensor,
//    4-10x its NCHW twin (H100 80GB HBM3, 700 W).  So a block of 32 x 32
//    threads folds 32 channels:
//    thread (c, r) adds partials r, r + 32, ... in double, in order, and
//    the 32 row lanes are then added in order, in double: still a fixed
//    order, so two runs give the same bits.
// S is chosen by the wrapper, as for NCHW, so that the grid fills the card:
// C = 64 at M = 401,408 takes many row slices, C = 2048 at M = 1,568 few.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// partial[(c * S + s) * 2 + {0, 1}] = (sum, sumsq) of block (c, s)
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_stats_partial(const T* __restrict__ x, const float* __restrict__ pivot,
                 float* __restrict__ partial, int channels,
                 unsigned rows, unsigned row_vecs) {
  const int c = blockIdx.x;
  const unsigned s = blockIdx.y, splits = gridDim.y;
  const unsigned total = rows * row_vecs;   // vectors of channel c
  const unsigned per = (total + splits - 1) / splits;
  const unsigned begin = s * per;
  const unsigned end = min(total, begin + per);
  const float p = pivot ? pivot[c] : 0.f;
  const Pack<T, V>* xv = reinterpret_cast<const Pack<T, V>*>(x);

  float sum = 0.f, sq = 0.f;
#pragma unroll 4
  for (unsigned e = begin + threadIdx.x; e < end; e += kThreads) {
    const unsigned n = e / row_vecs;
    const unsigned j = e - n * row_vecs;
    const Pack<T, V> pk = xv[((size_t)n * channels + c) * row_vecs + j];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float d = to_f32(pk.v[k]) - p;
      sum += d;
      sq += d * d;
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_down_sync(0xffffffffu, sum, off);
    sq += __shfl_down_sync(0xffffffffu, sq, off);
  }
  __shared__ float ssum[kWarps], ssq[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    ssum[warp] = sum;
    ssq[warp] = sq;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bs = 0.f, bq = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      bs += ssum[w];
      bq += ssq[w];
    }
    float* out = partial + ((size_t)c * splits + s) * 2;
    out[0] = bs;
    out[1] = bq;
  }
}

__global__ void bn_stats_fold(const float* __restrict__ partial,
                              const float* __restrict__ pivot,
                              float* __restrict__ mean,
                              float* __restrict__ var, int channels,
                              int splits, double inv_count) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= channels) return;
  double s = 0.0, q = 0.0;
  for (int i = 0; i < splits; ++i) {
    s += partial[((size_t)c * splits + i) * 2];
    q += partial[((size_t)c * splits + i) * 2 + 1];
  }
  const double dm = s * inv_count;
  const double v = q * inv_count - dm * dm;
  mean[c] = (float)((pivot ? (double)pivot[c] : 0.0) + dm);
  var[c] = (float)(v > 0.0 ? v : 0.0);
}

// Channels-last stage 1: block (b, s) covers channels [b*W*V, (b+1)*W*V)
// of rows [s*per, (s+1)*per); writes partial[(s * C + c) * 2 + {0, 1}].
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_stats_partial_cl(const T* __restrict__ x, const float* __restrict__ pivot,
                    float* __restrict__ partial, int channels,
                    unsigned rows, int width) {
  const int vecs = channels / V;             // vectors per row
  const int col = threadIdx.x & (width - 1);
  const int lane_row = threadIdx.x / width;
  const int row_step = kThreads / width;
  const int j = blockIdx.x * width + col;    // this thread's vector column
  const unsigned s = blockIdx.y, splits = gridDim.y;
  const unsigned per = (rows + splits - 1) / splits;
  const unsigned begin = s * per;
  const unsigned end = min(rows, begin + per);

  float p[V], sum[V], sq[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    p[k] = (pivot && j < vecs) ? pivot[j * V + k] : 0.f;
    sum[k] = 0.f;
    sq[k] = 0.f;
  }
  if (j < vecs) {
    const Pack<T, V>* xv = reinterpret_cast<const Pack<T, V>*>(x);
#pragma unroll 4
    for (unsigned r = begin + lane_row; r < end; r += row_step) {
      const Pack<T, V> pk = xv[(size_t)r * vecs + j];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float d = to_f32(pk.v[k]) - p[k];
        sum[k] += d;
        sq[k] += d * d;
      }
    }
  }

  // fold the row lanes in a fixed order: smem[(lane_row * W + col) * V + k]
  __shared__ float ssum[kThreads * V], ssq[kThreads * V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    ssum[threadIdx.x * V + k] = sum[k];
    ssq[threadIdx.x * V + k] = sq[k];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < width * V; o += kThreads) {
    const int c = blockIdx.x * width * V + o;
    if (c >= channels) break;
    float bs = 0.f, bq = 0.f;
    for (int lr = 0; lr < row_step; ++lr) {
      bs += ssum[lr * width * V + o];
      bq += ssq[lr * width * V + o];
    }
    float* out = partial + ((size_t)s * channels + c) * 2;
    out[0] = bs;
    out[1] = bq;
  }
}

constexpr int kFoldLanes = 32;

// Channels-last stage 2: block b folds channels [32b, 32b + 32), thread
// (x, y) = (channel, row lane); blockDim = (32, kFoldLanes).
__global__ void __launch_bounds__(32 * kFoldLanes)
bn_stats_fold_cl(const float* __restrict__ partial,
                 const float* __restrict__ pivot, float* __restrict__ mean,
                 float* __restrict__ var, int channels, int splits,
                 double inv_count) {
  const int c = blockIdx.x * 32 + threadIdx.x;
  double s = 0.0, q = 0.0;
  if (c < channels) {
    for (int i = threadIdx.y; i < splits; i += kFoldLanes) {
      s += partial[((size_t)i * channels + c) * 2];
      q += partial[((size_t)i * channels + c) * 2 + 1];
    }
  }
  __shared__ double ss[kFoldLanes][32], sq[kFoldLanes][32];
  ss[threadIdx.y][threadIdx.x] = s;
  sq[threadIdx.y][threadIdx.x] = q;
  __syncthreads();
  if (threadIdx.y != 0 || c >= channels) return;
  s = 0.0;
  q = 0.0;
  for (int r = 0; r < kFoldLanes; ++r) {
    s += ss[r][threadIdx.x];
    q += sq[r][threadIdx.x];
  }
  const double dm = s * inv_count;
  const double v = q * inv_count - dm * dm;
  mean[c] = (float)((pivot ? (double)pivot[c] : 0.0) + dm);
  var[c] = (float)(v > 0.0 ? v : 0.0);
}

template <typename T, int V>
cudaError_t launch_cl(const void* x, const float* pivot, float* partial,
                      float* mean, float* var, long long rows, int channels,
                      int splits, int width, cudaStream_t stream) {
  const int col_blocks = (channels / V + width - 1) / width;
  dim3 grid(col_blocks, splits);
  bn_stats_partial_cl<T, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), pivot, partial, channels, (unsigned)rows,
      width);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_stats_fold_cl<<<(channels + 31) / 32, dim3(32, kFoldLanes), 0,
                     stream>>>(partial, pivot, mean, var, channels, splits,
                               1.0 / (double)rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cl_v(const void* x, const float* pivot, float* partial,
                        float* mean, float* var, long long rows, int channels,
                        int splits, int vec, int width, cudaStream_t stream) {
  switch (vec) {
    case 1: return launch_cl<T, 1>(x, pivot, partial, mean, var, rows, channels, splits, width, stream);
    case 2: return launch_cl<T, 2>(x, pivot, partial, mean, var, rows, channels, splits, width, stream);
    case 4: return launch_cl<T, 4>(x, pivot, partial, mean, var, rows, channels, splits, width, stream);
    case 8:
      if constexpr (sizeof(T) * 8 == 16)
        return launch_cl<T, 8>(x, pivot, partial, mean, var, rows, channels, splits, width, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int V>
cudaError_t launch(const void* x, const float* pivot, float* partial,
                   float* mean, float* var, int n, int channels,
                   long long hw, int splits, cudaStream_t stream) {
  dim3 grid(channels, splits);
  bn_stats_partial<T, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), pivot, partial, channels, (unsigned)n,
      (unsigned)(hw / V));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_stats_fold<<<(channels + 127) / 128, 128, 0, stream>>>(
      partial, pivot, mean, var, channels, splits,
      1.0 / ((double)n * (double)hw));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_v(const void* x, const float* pivot, float* partial,
                     float* mean, float* var, int n, int channels,
                     long long hw, int splits, int vec, cudaStream_t stream) {
  switch (vec) {
    case 1: return launch<T, 1>(x, pivot, partial, mean, var, n, channels, hw, splits, stream);
    case 2: return launch<T, 2>(x, pivot, partial, mean, var, n, channels, hw, splits, stream);
    case 4: return launch<T, 4>(x, pivot, partial, mean, var, n, channels, hw, splits, stream);
    case 8:
      if constexpr (sizeof(T) * 8 == 16)
        return launch<T, 8>(x, pivot, partial, mean, var, n, channels, hw, splits, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x: contiguous (n, channels, hw) on `device`, dtype 0 = fp32, 1 = bf16,
// 2 = fp16;
// pivot: (channels,) fp32 or null; partial: 2 * channels * splits fp32
// scratch; mean, var: (channels,) fp32.  `vec` elements are loaded at a
// time: it must divide hw, and x must be aligned to vec elements (the
// wrapper checks both).  Launches two kernels on `stream` without
// synchronising and returns cudaGetLastError() (0 on success).
int mxt_bn_stats(const void* x, const float* pivot, float* partial,
                 float* mean, float* var, int n, int channels, long long hw,
                 int splits, int vec, int dtype, int device, void* stream) {
  if (n < 1 || channels < 1 || hw < 1 || splits < 1 || splits > 65535 ||
      vec < 1 || hw % vec != 0 || (long long)n * (hw / vec) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: err = launch_v<float>(x, pivot, partial, mean, var, n, channels, hw, splits, vec, s); break;
    case 1: err = launch_v<__nv_bfloat16>(x, pivot, partial, mean, var, n, channels, hw, splits, vec, s); break;
    case 2: err = launch_v<__half>(x, pivot, partial, mean, var, n, channels, hw, splits, vec, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

// x: a row-major (rows, channels) matrix on `device` (NHWC, or NCHW in
// channels_last memory format), dtype as above; pivot, partial, mean, var
// as above.  `vec` elements are loaded at a time: it must divide channels,
// and x must be aligned to vec elements (the wrapper checks both).  A
// stage-1 block spans `width` vectors of a row: a power of two, 1 to 256.
int mxt_bn_stats_cl(const void* x, const float* pivot, float* partial,
                    float* mean, float* var, long long rows, int channels,
                    int splits, int vec, int width, int dtype, int device,
                    void* stream) {
  if (rows < 1 || rows > 0x7fffffffLL || channels < 1 || splits < 1 ||
      splits > 65535 || vec < 1 || channels % vec != 0 || width < 1 ||
      width > kThreads || (width & (width - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: err = launch_cl_v<float>(x, pivot, partial, mean, var, rows, channels, splits, vec, width, s); break;
    case 1: err = launch_cl_v<__nv_bfloat16>(x, pivot, partial, mean, var, rows, channels, splits, vec, width, s); break;
    case 2: err = launch_cl_v<__half>(x, pivot, partial, mean, var, rows, channels, splits, vec, width, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"
