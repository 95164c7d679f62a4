// Greedy non-maximum suppression for Hopper (sm_90a), CUDA C++ with a plain
// C interface, loaded by mxnet_tpu_torch/ops/_build.py through ctypes.
//
// Replaces no TPU kernel: the JAX package's `_greedy_nms_mask`
// (mxnet_tpu/ops/contrib_ops.py:66-81) is a `lax.fori_loop` over every
// sorted row that XLA compiles; `box_nms` and `MultiBoxDetection` run it.
// Torch has no greedy-NMS call, and the plain loop launches a chain of small
// kernels a row (7,236 rows an image at SSD-300), so the port has its own,
// as MXNet 1.5 has one (src/operator/contrib/bounding_box.cu).
//
// Function.  For each image b of a batch, over boxes (n, 4) corner fp32
// already sorted by score, a validity mask (n,) and optional class ids (n,):
//     removed = {}
//     for i in 0 .. n-1:
//         if valid[i] and i not in removed:
//             removed |= {j != i : valid[j], iou(i, j) > thresh,
//                                  cls[i] == cls[j] (when ids are given)}
//     keep = valid & ~removed
// iou is the plain version's: the intersection's width and height clamped
// at 0, areas clamped at 0, union = (area_i + area_j) - inter, inter / union
// where union > 0, else 0; a pair of other classes counts as iou 0.  Every
// operation is rounded as the plain version rounds it (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn: no FMA contraction), and max/min carry
// a NaN through as torch.maximum/minimum do, so each bit equals the plain
// version's.
//
// What bounds it.  Neither bytes nor operations: the boxes, the masks and
// the keep mask are a few MB at most (SSD-300's 7,236 anchors at batch 8
// are 1.3 MB), and the IoU of every pair of valid rows is 13 flops, 2.9
// GFLOP for that batch with every row valid (0.04 ms at the fp32 rate).
// The scan is a chain: row i's fate depends on every kept row before it.
//
// Design: two launches on the caller's stream.
//  - Pass 1, the mask (grid: column tile, row tile, image; 64 threads).  A
//    block stages 64 column boxes, their areas, validity and ids in shared
//    memory; thread t takes row i = 64 * row_tile + t and writes one 64-bit
//    word, bit j set when row i would remove column j.  Only tiles at or
//    right of the diagonal are computed: iou and the class test are
//    symmetric bit for bit (max, min, + and * commute exactly), so a kept
//    row never has a pair above threshold with an earlier valid row that
//    was alive, and the words left of the diagonal could change nothing.
//    The mask is (n, words) per image, words = ceil(n / 64), in scratch the
//    wrapper allocates.
//  - Pass 2, the scan (one block of 128 threads an image).  The removal
//    bitmap (words x 64 bits) lives in shared memory.  For each 64-row tile
//    k in order: the tile's diagonal words and validity bits are staged in
//    shared memory; one thread walks the tile's rows in order against the
//    bitmap's word k and its own running copy, marking a row kept and OR-ing
//    its diagonal word when it is valid and not removed, and lists the kept
//    rows; then every thread ORs the kept rows' words k+1 .. words-1 into
//    the bitmap, one word a thread, eight independent loads at a time.
//    This is the sequential loop above with its row-to-row chain kept in
//    registers and shared memory, and its wide updates spread over the
//    block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kScanThreads = 128;

// torch.maximum / torch.minimum: a NaN in either operand gives NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2) {
  return max_nan(__fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1)), 0.0f);
}

__device__ __forceinline__ float pair_iou(const float* a, float area_a,
                                          const float* b, float area_b) {
  const float iw = max_nan(__fsub_rn(min_nan(a[2], b[2]), max_nan(a[0], b[0])),
                           0.0f);
  const float ih = max_nan(__fsub_rn(min_nan(a[3], b[3]), max_nan(a[1], b[1])),
                           0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
}

__global__ void __launch_bounds__(kTile)
nms_mask_kernel(const float* __restrict__ boxes,
                const uint8_t* __restrict__ valid,
                const float* __restrict__ cls, float thresh, int n, int words,
                unsigned long long* __restrict__ mask) {
  const int col_tile = blockIdx.x, row_tile = blockIdx.y;
  if (col_tile < row_tile) return;
  const long long base = (long long)blockIdx.z * n;
  __shared__ float sbox[kTile][4];
  __shared__ float sarea[kTile];
  __shared__ float scls[kTile];
  __shared__ uint8_t svalid[kTile];
  const int t = threadIdx.x;
  const int j0 = col_tile * kTile;
  const int jn = min(kTile, n - j0);
  if (t < jn) {
    const float* b = boxes + (base + j0 + t) * 4;
    sbox[t][0] = b[0];
    sbox[t][1] = b[1];
    sbox[t][2] = b[2];
    sbox[t][3] = b[3];
    sarea[t] = box_area(b[0], b[1], b[2], b[3]);
    scls[t] = cls != nullptr ? cls[base + j0 + t] : 0.0f;
    svalid[t] = valid[base + j0 + t];
  }
  __syncthreads();
  const int i = row_tile * kTile + t;
  if (i >= n) return;
  const float* bi = boxes + (base + i) * 4;
  const float a[4] = {bi[0], bi[1], bi[2], bi[3]};
  const float area_a = box_area(a[0], a[1], a[2], a[3]);
  const float ci = cls != nullptr ? cls[base + i] : 0.0f;
  unsigned long long bits = 0ull;
  for (int jj = 0; jj < jn; ++jj) {
    if (!svalid[jj] || j0 + jj == i) continue;
    float v = pair_iou(a, area_a, sbox[jj], sarea[jj]);
    if (cls != nullptr && !(ci == scls[jj])) v = 0.0f;
    if (v > thresh) bits |= 1ull << jj;
  }
  mask[(base + i) * words + col_tile] = bits;
}

__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const unsigned long long* __restrict__ mask,
                const uint8_t* __restrict__ valid, int n, int words,
                uint8_t* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];   // words
  __shared__ unsigned long long diag[kTile];
  __shared__ unsigned int valid_bits[kTile / 32];
  __shared__ unsigned long long kept_tile;
  __shared__ int kept_rows[kTile];                   // in row order
  __shared__ int n_kept;
  const long long base = (long long)blockIdx.x * n;
  const unsigned long long* m = mask + base * words;
  const int t = threadIdx.x;
  for (int w = t; w < words; w += kScanThreads) removed[w] = 0ull;
  for (int k = 0; k < words; ++k) {
    const int r0 = k * kTile;
    const int rn = min(kTile, n - r0);
    if (t < kTile) {
      const bool ok = t < rn && valid[base + r0 + t] != 0;
      diag[t] = ok ? m[(long long)(r0 + t) * words + k] : 0ull;
      const unsigned int ballot = __ballot_sync(0xffffffffu, ok);
      if ((t & 31) == 0) valid_bits[t >> 5] = ballot;
    }
    __syncthreads();
    if (t == 0) {
      const unsigned long long vb =
          (unsigned long long)valid_bits[0] |
          ((unsigned long long)valid_bits[1] << 32);
      unsigned long long cur = removed[k];
      unsigned long long kept = 0ull;
      int nk = 0;
      for (int s = 0; s < rn; ++s) {
        if (((vb >> s) & 1ull) && !((cur >> s) & 1ull)) {
          kept |= 1ull << s;
          cur |= diag[s];
          kept_rows[nk++] = r0 + s;
        }
      }
      kept_tile = kept;
      n_kept = nk;
    }
    __syncthreads();
    const unsigned long long kept = kept_tile;
    const int nk = n_kept;
    if (t < rn) keep[base + r0 + t] = (uint8_t)((kept >> t) & 1ull);
    // each word past the tile ORs the kept rows' words, 8 independent
    // loads in flight at a time
    for (int w = k + 1 + t; w < words; w += kScanThreads) {
      unsigned long long acc = 0ull;
      for (int j0 = 0; j0 < nk; j0 += 8) {
        unsigned long long v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          v[u] = j0 + u < nk ? m[(long long)kept_rows[j0 + u] * words + w]
                             : 0ull;
#pragma unroll
        for (int u = 0; u < 8; ++u) acc |= v[u];
      }
      removed[w] |= acc;
    }
  }
}

}  // namespace

extern "C" {

// keep (b, n) uint8 (0/1) from boxes (b, n, 4) fp32 corner boxes sorted by
// score, valid (b, n) uint8, cls (b, n) fp32 or null (no class test),
// thresh.  mask: scratch of at least b * n * ceil(n / 64) 64-bit words.
// All contiguous.  Two launches on `stream`.  Returns a cudaError_t (0 on
// success).
int mxt_nms(const void* boxes, const void* valid, const void* cls,
            float thresh, int b, int n, void* mask, long long mask_cap,
            void* keep, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0 || n <= 0) return 0;
  const int words = (n + kTile - 1) / kTile;
  const size_t shared = sizeof(unsigned long long) * (size_t)words;
  if (b > 65535 || words > 65535 ||
      (long long)b * n * words > mask_cap || shared > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bx = static_cast<const float*>(boxes);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  const float* c = static_cast<const float*>(cls);
  unsigned long long* m = static_cast<unsigned long long*>(mask);
  nms_mask_kernel<<<dim3(words, words, b), kTile, 0, s>>>(bx, v, c, thresh,
                                                          n, words, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_scan_kernel<<<b, kScanThreads, shared, s>>>(
      m, v, n, words, static_cast<uint8_t*>(keep));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
