// BatchNorm batch statistics for Hopper (sm_90a), CUDA C++ with a plain C
// interface, loaded by mxnet_tpu_torch/ops/_build.py through ctypes.
//
// Replaces: benchmark/pallas_bn_stats.py `bn_stats_kernel` (:62-85), launched
// through `pl.pallas_call` by `pallas_stats` (:91).  Same function: per
// channel c, sum(x - p) and sum((x - p)^2) over every other axis in one pass
// with fp32 accumulation, folded in double into mean = p + E[x - p] and the
// biased var = max(E[(x - p)^2] - E[x - p]^2, 0).  p is an optional
// per-channel shift: p = 0 is the TPU kernel's function exactly; the
// training path has the kernel read p = x[0, c, 0, 0] itself (the pivot of
// mxnet_tpu/ops/nn.py:285-296; x[0, 0, 0, c] channels-last), which keeps
// the subtraction from cancelling when |mean| >> std.
//
// Data.  Both layouts the wrapper takes are a row-major (rows, C, K) array:
// contiguous NCHW is rows = N, K = H*W; channels-last (NHWC, or NCHW in
// torch.channels_last memory format) is rows = N*H*W, K = 1.
//
// What bounds it.  One read of the activation and nothing else: at
// ResNet-50's largest BatchNorm input, (32, 64, 112, 112) fp32, 103 MB, 31 us
// at 3.35 TB/s; the outputs are a few KB.  Three flops an element are far
// below the fp32 rate, so bytes bound it.
//
// Design (one launch a call; two runs give the same bits):
//  - A grid of (channel groups) x (S row slices) of 256-thread blocks.  Each
//    thread issues kUnroll independent 16-byte loads before it adds them,
//    so that the blocks keep enough bytes in flight to stream at the
//    memory's rate.  The host side (`dispatch`, `launch`) picks the route,
//    the load width, G and S from the size, the layout and the base
//    address: about two blocks an SM for a large input, ~24 KB a block for
//    a small one, never more than one wave.
//  - `wide` (a channel's run of K elements >= 1 KB, or >= 256 B with at most
//    256 channels, or longer than 256 elements): a group is one channel,
//    whose S slices of the flattened (row, k) space its blocks share; a
//    thread finds (row, k) of a vector with a multiply-high division by
//    K / V (no integer division in the loop).
//  - `rows` (the other small K, and channels-last): a group is G whole
//    channels, which are G*K contiguous columns of every row; the block's
//    `width` column lanes read a row's span with 16-byte loads (at 7x7 a
//    channel is 196 bytes, so 4 channels is the smallest span 16-byte loads
//    tile: no scalar loads) and its 256 / width row lanes take the rows in
//    turn.  Each thread keeps V column sums, folded per channel in shared
//    memory in a fixed order.  G is the smallest whose span reaches 32-128
//    bytes (by input size) and whose groups are at most the blocks wanted.
//  - The fold, one launch whatever S is.  S = 1 (the groups alone give a
//    third of the blocks wanted): a block writes its channels' mean and var.
//    S <= 8: the S blocks of a group are a thread-block cluster; each
//    writes its sums into rank 0's shared memory, and after one cluster
//    barrier rank 0 folds them in rank order, in double (faster than the
//    tickets at the same S: chip_smoke.py phases 7 and 20 time both).
//    Larger S (a large input with few groups): each block writes its sums
//    to a partials buffer and takes a ticket (__threadfence, then atomicAdd
//    on a counter, as CUDA's threadFenceReduction sample); the last block
//    of each team of
//    ~sqrt(S) slices folds the team's partials in index order, in double,
//    and the last team folds the team sums, so that no block folds more
//    than ~sqrt(S) values a channel.  Every fold has a fixed shape: the bits
//    do not depend on which block arrives last.  The last block resets its
//    counter; counters and partials are scratch the wrapper allocates once
//    per (device, stream), so no call needs a memset launch and a call is
//    capturable in a CUDA graph.
//  - The pivot: each channel's first element is read by the blocks of its
//    group, so the training path builds no pivot tensor.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;          // independent loads in flight a thread
constexpr int kMaxGroup = 256;      // channels a `rows` block covers at most
// bytes a block should read at least: below it, more blocks only add
// partials to fold
constexpr long long kBlockBytes = 24 << 10;
// slices that fold through a thread-block cluster (the portable size)
constexpr int kMaxCluster = 8;
// fewest blocks that clusters of a small input must give, else tickets
constexpr long long kMinClusterBlocks = 64;
// `wide` takes a channel whose run of K elements is at least kWideBytes,
// or kWideFewBytes with at most kFewChannels channels (a block each fills
// the card), or longer than kRowsRun elements; `rows` takes the others
constexpr long long kWideBytes = 1024;
constexpr long long kWideFewBytes = 256;
constexpr long long kFewChannels = 256;
constexpr long long kRowsRun = 256;
// rows mode: the least bytes of a row a block reads, by input size: a
// large input streams from DRAM, where whole 128-byte lines pay; a small one
// is read from L2 (the convolution that made it has just written it), where
// narrower spans give more channel groups and fewer splits to fold
constexpr long long kLargeInput = 16 << 20;
constexpr long long kMidInput = 8 << 20;
long long min_span_bytes(long long bytes) {
  return bytes >= kLargeInput ? 128 : (bytes >= kMidInput ? 64 : 32);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// a pack's elements as fp32; 16-bit types convert two at a time
template <int V>
__device__ __forceinline__ void unpack(const Pack<float, V>& p, float* f) {
#pragma unroll
  for (int k = 0; k < V; ++k) f[k] = p.v[k];
}

template <typename T, typename T2, typename Cvt, int V>
__device__ __forceinline__ void unpack2(const Pack<T, V>& p, float* f,
                                        Cvt cvt) {
  if constexpr (V == 1) {
    f[0] = to_f32(p.v[0]);
  } else {
    const T2* h = reinterpret_cast<const T2*>(p.v);
#pragma unroll
    for (int k = 0; k < V / 2; ++k) {
      const float2 t = cvt(h[k]);
      f[2 * k] = t.x;
      f[2 * k + 1] = t.y;
    }
  }
}

template <int V>
__device__ __forceinline__ void unpack(const Pack<__half, V>& p, float* f) {
  unpack2<__half, __half2>(p, f, [](__half2 h) { return __half22float2(h); });
}

template <int V>
__device__ __forceinline__ void unpack(const Pack<__nv_bfloat16, V>& p,
                                       float* f) {
  unpack2<__nv_bfloat16, __nv_bfloat162>(
      p, f, [](__nv_bfloat162 h) { return __bfloat1622float2(h); });
}

struct Args {
  const void* x;
  const float* pivot;     // explicit per-channel pivot, or null
  int self_pivot;         // 1: p = x[0, c, 0] (the first element of c)
  float* partial;         // (C, S) float pairs of (sum, sumsq), then the
                          // (C, teams) double pairs of the team sums
  unsigned* tickets;      // (teams + 1) counters a group, zero between calls
  float* out;             // mean at [c], var at [C + c]
  long long rows;         // the reduced outer extent
  int channels;
  int inner;              // K
  int group;              // G channels a block (rows mode; 1 for wide)
  int width;              // column lanes (rows mode)
  int splits;             // S
  int team, teams;        // slices a first-level fold takes; their count
  int cluster;            // 1: the S slices of a group are one cluster
  unsigned vecs;          // wide: rows * K / V, the vectors of a channel
  unsigned kv;            // wide: K / V
  unsigned magic, shift;  // wide: e / kv == __umulhi(e, magic) >> shift
  double inv_count;       // 1 / (rows * K)
};

template <typename T>
__device__ __forceinline__ float pivot_of(const Args& a, int c) {
  if (a.self_pivot)
    return to_f32(static_cast<const T*>(a.x)[(size_t)c * a.inner]);
  return a.pivot ? a.pivot[c] : 0.f;
}

__device__ __forceinline__ void write_stats(const Args& a, int c, float p,
                                            double s, double q) {
  const double dm = s * a.inv_count;
  const double v = q * a.inv_count - dm * dm;
  a.out[c] = (float)((double)p + dm);
  a.out[a.channels + c] = (float)(v > 0.0 ? v : 0.0);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The sums of n <= kThreads channels, each over the m values that
// get(g, i, s, q) adds to (s, q), in type A: every thread of the block
// takes part, L lanes a channel (a power of two, at most a warp), lane l
// adding i = l, l + L, ... in turn, then the L lanes in a fixed shuffle
// tree.  put(g, s, q) is called by the first lane of channel g.  The loads
// of a lane are independent, so they are in flight together.
template <typename A, typename Get, typename Put>
__device__ __forceinline__ void fold_channels(int n, int m, Get get,
                                              Put put) {
  int npow = 1;
  while (npow < n) npow *= 2;
  const int L = min(32, kThreads / npow);
  const int g = threadIdx.x / L, l = threadIdx.x % L;
  A s = 0, q = 0;
  if (g < n) {
#pragma unroll 4
    for (int i = l; i < m; i += L) get(g, i, s, q);
  }
  for (int off = L / 2; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off, L);
    q += __shfl_down_sync(0xffffffffu, q, off, L);
  }
  if (g < n && l == 0) put(g, s, q);
}

// A cluster's blocks arrive at its barrier when they start and wait there
// before they write to another block's shared memory, which must have
// started (the split barrier costs no stall: they all started long ago).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// True in every thread of the block that takes ticket `t` last of `m`: the
// block's writes are made visible first, and it sees the others' after.
__device__ __forceinline__ bool last_of(unsigned* t, int m) {
  __threadfence();
  __syncthreads();
  __shared__ bool last;
  if (threadIdx.x == 0) last = atomicAdd(t, 1u) == (unsigned)(m - 1);
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The block's sums of channels [c0, c0 + n) of group `grp` are in bsum/bsq
// and their pivots in piv (shared).  With one slice they are the channels'
// statistics.  In a cluster, rank 0 folds the S blocks' sums.  Else they
// become partials (C, S), and the slices fold in a two-level tree of fixed
// shape: the last block of each team of `team` consecutive slices folds
// the team's partials into a team sum (C, teams) in double, and the last
// team to finish folds the team sums.  NMAX: the most channels a block
// of the kernel covers.
template <int NMAX>
__device__ void finish(const Args& a, int grp, int c0, int n, float* bsum,
                       float* bsq, const float* piv) {
  const int S = a.splits;
  if (S == 1) {
    for (int g = threadIdx.x; g < n; g += kThreads)
      write_stats(a, c0 + g, piv[g], (double)bsum[g], (double)bsq[g]);
    return;
  }
  if (a.cluster) {
    // the group's S blocks are one cluster: each writes its sums into rank
    // 0's shared memory, and rank 0 folds them in rank order
    namespace cg = cooperative_groups;
    cg::cluster_group cl = cg::this_cluster();
    const unsigned rank = cl.block_rank();
    __shared__ float2 cpart[kMaxCluster * NMAX];
    cluster_wait();      // every block of the cluster has started
    float2* dst = cl.map_shared_rank(cpart, 0);
    for (int g = threadIdx.x; g < n; g += kThreads)
      dst[rank * n + g] = make_float2(bsum[g], bsq[g]);
    cl.sync();           // rank 0 sees them all
    if (rank == 0)
      fold_channels<double>(
          n, S,
          [&](int g, int i, double& ss, double& qq) {
            const float2 v = cpart[i * n + g];
            ss += v.x;
            qq += v.y;
          },
          [&](int g, double ss, double qq) {
            write_stats(a, c0 + g, piv[g], ss, qq);
          });
    return;
  }
  const int s = blockIdx.y, teams = a.teams;
  const int t = s / a.team, t0 = t * a.team;
  const int m = min(a.team, S - t0);
  float2* part = reinterpret_cast<float2*>(a.partial);
  for (int g = threadIdx.x; g < n; g += kThreads)
    part[(size_t)(c0 + g) * S + s] = make_float2(bsum[g], bsq[g]);
  unsigned* tick = a.tickets + (size_t)grp * (teams + 1);
  if (!last_of(tick + 1 + t, m)) return;
  double2* tsum = reinterpret_cast<double2*>(
      a.partial + ((2 * (size_t)S * a.channels + 3) & ~(size_t)3));
  fold_channels<double>(
      n, m,
      [&](int g, int i, double& ss, double& qq) {
        const float2 v = __ldcg(part + (size_t)(c0 + g) * S + t0 + i);
        ss += v.x;
        qq += v.y;
      },
      [&](int g, double ss, double qq) {
        if (teams == 1)
          write_stats(a, c0 + g, piv[g], ss, qq);
        else
          tsum[(size_t)(c0 + g) * teams + t] = make_double2(ss, qq);
      });
  if (threadIdx.x == 0) tick[1 + t] = 0u;
  if (teams == 1 || !last_of(tick, teams)) return;
  fold_channels<double>(
      n, teams,
      [&](int g, int i, double& ss, double& qq) {
        const double2 v = __ldcg(tsum + (size_t)(c0 + g) * teams + i);
        ss += v.x;
        qq += v.y;
      },
      [&](int g, double ss, double qq) {
        write_stats(a, c0 + g, piv[g], ss, qq);
      });
  if (threadIdx.x == 0) tick[0] = 0u;
}

// wide: block (c, s) reduces slice s of channel c's rows * K elements
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_stats_wide(const Args a) {
  using P = Pack<T, V>;
  if (a.cluster) cluster_arrive();
  const int c = blockIdx.x;
  const unsigned s = blockIdx.y;
  const unsigned per = (a.vecs + a.splits - 1) / a.splits;
  const unsigned begin = s * per;
  const unsigned end = min(a.vecs, begin + per);
  const size_t row_vecs = (size_t)a.channels * a.kv;
  const P* xv = static_cast<const P*>(a.x) + (size_t)c * a.kv;
  const float p = pivot_of<T>(a, c);

  float sum = 0.f, sq = 0.f;
  for (unsigned e0 = begin + threadIdx.x; e0 < end;
       e0 += kThreads * kUnroll) {
    P pk[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned e = e0 + u * kThreads;
      if (e < end) {
        const unsigned r = __umulhi(e, a.magic) >> a.shift;
        pk[u] = xv[r * row_vecs + (e - r * a.kv)];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (e0 + u * kThreads < end) {
        float f[V];
        unpack(pk[u], f);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float d = f[k] - p;
          sum += d;
          sq = fmaf(d, d, sq);
        }
      }
    }
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  __shared__ float wsum[kWarps], wsq[kWarps];
  __shared__ float bsum[1], bsq[1], piv[1];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    wsum[warp] = sum;
    wsq[warp] = sq;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bs = 0.f, bq = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      bs += wsum[w];
      bq += wsq[w];
    }
    bsum[0] = bs;
    bsq[0] = bq;
    piv[0] = p;
  }
  __syncthreads();
  finish<1>(a, c, c, 1, bsum, bsq, piv);
}

// rows: block (b, s) reduces channels [b*G, b*G + G) over row slice s
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_stats_rows(const Args a) {
  using P = Pack<T, V>;
  if (a.cluster) cluster_arrive();
  const int b = blockIdx.x;
  const int c0 = b * a.group;
  const int n = min(a.group, a.channels - c0);
  const int K = a.inner;
  const int cols = n * K;                    // columns of this group
  const int width = a.width;
  const int lanes = kThreads / width;        // row lanes
  const int col = threadIdx.x % width;       // this thread's column vector
  const int lrow = threadIdx.x / width;
  const unsigned rows = (unsigned)a.rows;
  const unsigned per = (rows + a.splits - 1) / a.splits;
  const unsigned begin = blockIdx.y * per;
  const unsigned end = min(rows, begin + per);
  const size_t row_vecs = (size_t)a.channels * K / V;
  const P* xv = static_cast<const P*>(a.x) + (size_t)c0 * K / V + col;
  const bool active = lrow < lanes && col * V < cols;

  // the group's pivots, for the fold (their loads overlap the loop's)
  __shared__ float piv[kMaxGroup];
  for (int g = threadIdx.x; g < n; g += kThreads)
    piv[g] = pivot_of<T>(a, c0 + g);
  float p[V], sum[V], sq[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    p[k] = active ? pivot_of<T>(a, c0 + (col * V + k) / K) : 0.f;
    sum[k] = 0.f;
    sq[k] = 0.f;
  }
  if (active) {
    for (unsigned r0 = begin + lrow; r0 < end; r0 += lanes * kUnroll) {
      P pk[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned r = r0 + u * lanes;
        if (r < end) pk[u] = xv[r * row_vecs];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r0 + u * lanes < end) {
          float f[V];
          unpack(pk[u], f);
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float d = f[k] - p[k];
            sum[k] += d;
            sq[k] = fmaf(d, d, sq[k]);
          }
        }
      }
    }
  }

  // column sums at [row lane][column]: tid * V + k
  __shared__ float ssum[kThreads * V], ssq[kThreads * V];
  __shared__ float bsum[kMaxGroup], bsq[kMaxGroup];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    ssum[threadIdx.x * V + k] = sum[k];
    ssq[threadIdx.x * V + k] = sq[k];
  }
  __syncthreads();
  // a channel's sum: its row lanes x K columns, in a fixed order
  const int span = lanes * K;
  fold_channels<float>(
      n, span,
      [&](int g, int e, float& s, float& q) {
        const int lr = e / K;
        const int i = lr * width * V + g * K + (e - lr * K);
        s += ssum[i];
        q += ssq[i];
      },
      [&](int g, float s, float q) {
        bsum[g] = s;
        bsq[g] = q;
      });
  __syncthreads();
  finish<kMaxGroup>(a, b, c0, n, bsum, bsq, piv);
}

int sm_count(int device) {
  static int cache[64];
  if (device < 0 || device >= 64) return 132;
  if (!cache[device]) {
    int v = 0;
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess || v < 1)
      v = 132;
    cache[device] = v;
  }
  return cache[device];
}

template <typename K>
int blocks_per_sm(K kernel) {
  static int occ = 0;   // one per kernel instantiation
  if (!occ) {
    int v = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&v, kernel, kThreads,
                                                      0) != cudaSuccess ||
        v < 1)
      v = 1;
    occ = v;
  }
  return occ;
}

long long lmin(long long a, long long b) { return a < b ? a : b; }

long long clampll(long long v, long long lo, long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

struct Plan {
  int wide, vec, group, splits, groups, blocks_per_sm, cluster;
};

// S and G as the debug entry forces them (0: chosen by `launch`), and
// `tickets` (1: fold 2-8 slices through the tickets, not a cluster)
struct Force {
  int splits, group, tickets;
};

template <typename T, int V>
cudaError_t launch(Args a, int wide, Force force, long long partial_cap,
                   int ticket_cap, int device, cudaStream_t stream,
                   Plan* plan) {
  const long long es = sizeof(T);
  const long long C = a.channels, K = a.inner;
  Plan pl{wide, V, 1, 1, (int)C, 0, 0};
  if (wide) {
    pl.blocks_per_sm = blocks_per_sm(bn_stats_wide<T, V>);
    const unsigned kv = (unsigned)(K / V);
    a.kv = kv;
    a.vecs = (unsigned)(a.rows * kv);
    // ceil(log2(kv)): e / kv == __umulhi(e, m) >> (l - 1) for e < 2^31
    if (kv < 2) return cudaErrorInvalidValue;
    unsigned l = 0;
    while ((1ull << l) < kv) ++l;
    a.magic = (unsigned)(((1ull << (31 + l)) + kv - 1) / kv);
    a.shift = l - 1;
  } else {
    pl.blocks_per_sm = blocks_per_sm(bn_stats_rows<T, V>);
  }
  // blocks: about 2 an SM for a large input, kBlockBytes each for a small
  // one, never more than fit at once (one wave)
  const long long sms = sm_count(device);
  const long long bytes = a.rows * C * K * es;
  const long long target =
      lmin(lmin(2 * sms, (long long)pl.blocks_per_sm * sms),
           (bytes + kBlockBytes - 1) / kBlockBytes);
  if (!wide) {
    // G: a multiple of V / gcd(K, V) (every span starts on a vector) whose
    // span of a row is at least min_span_bytes, at most kMaxGroup channels
    // and 256 column vectors: the smallest with at most `target` groups,
    // so that slices are split only where the groups are too few
    long long gk = 1, kk = K, vv = V;             // gk = gcd(K, V)
    while (vv % 2 == 0 && kk % 2 == 0) { vv /= 2; kk /= 2; gk *= 2; }
    const long long m = V / gk;
    long long gmax = kThreads * (long long)V / K;
    gmax = gmax < kMaxGroup ? gmax : kMaxGroup;
    gmax -= gmax % m;
    long long cm = ((C + m - 1) / m) * m;
    if (gmax > cm) gmax = cm;
    if (gmax < m) return cudaErrorInvalidValue;
    long long best = m;
    const long long span = min_span_bytes(bytes);
    while (best * K * es < span && best + m <= gmax) best += m;
    while ((C + best - 1) / best > target && best + m <= gmax) best += m;
    if (force.group > 0) {
      if (force.group % m != 0 || force.group > gmax)
        return cudaErrorInvalidValue;
      best = force.group;
    }
    pl.group = (int)best;
    pl.groups = (int)((C + best - 1) / best);
    a.width = (int)(best * K / V);
  }
  // S: none where the groups alone give a third of the blocks wanted (a
  // fold costs an L2 round trip or two, more than the blocks it adds);
  // up to kMaxCluster slices fold in a cluster; more take the tickets,
  // except for a small input whose groups give enough blocks in clusters
  long long S = 3 * pl.groups >= target ? 1 : target / pl.groups;
  S = lmin(S, wide ? (long long)a.vecs : a.rows);
  if (S > kMaxCluster && bytes < kLargeInput &&
      pl.groups * kMaxCluster >= kMinClusterBlocks)
    S = kMaxCluster;
  if (force.splits > 0) S = force.splits;
  S = clampll(S, 1, 65535);
  pl.cluster = S > 1 && S <= kMaxCluster && !force.tickets;
  // teams of ~sqrt(S) slices: both fold levels read ~sqrt(S) pairs a
  // channel
  long long team = 1;
  while (team * team < S) ++team;
  const long long teams = (S + team - 1) / team;
  // scratch: 2 S C floats, then (16-byte aligned) 4 teams C of the team sums
  if (S > 1 && !pl.cluster &&
      (((2 * S * C + 3) & ~3LL) + 4 * teams * C > partial_cap ||
       (long long)pl.groups * (teams + 1) > ticket_cap))
    return cudaErrorInvalidValue;
  pl.splits = (int)S;
  a.group = pl.group;
  a.splits = pl.splits;
  a.team = (int)team;
  a.teams = (int)teams;
  a.cluster = pl.cluster;
  if (plan) *plan = pl;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.groups, pl.splits);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (pl.cluster) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = pl.splits;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  const cudaError_t err =
      wide ? cudaLaunchKernelEx(&cfg, bn_stats_wide<T, V>, a)
           : cudaLaunchKernelEx(&cfg, bn_stats_rows<T, V>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The route and the load width, then the launch: `wide` for a long run of
// a channel, else `rows`; V the widest load of at most 16 bytes that
// divides the run a vector walks (K wide, C * K rows) and the base address.
template <typename T>
cudaError_t dispatch(const Args& a, Force force, long long partial_cap,
                     int ticket_cap, int device, cudaStream_t s, Plan* plan) {
  const long long es = sizeof(T), C = a.channels, K = a.inner;
  const int wide = K * es >= kWideBytes || K > kRowsRun ||
                   (K * es >= kWideFewBytes && C <= kFewChannels);
  const long long run = wide ? K : C * K;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a.x);
  long long vec = 16 / es;
  while (vec > 1 && (run % vec || addr % (vec * es))) vec /= 2;
  if ((wide ? a.rows * (K / vec) : a.rows) > 0x7fffffffLL)
    return cudaErrorInvalidValue;     // over 2^31 loads a channel
  switch (vec) {
    case 1: return launch<T, 1>(a, wide, force, partial_cap, ticket_cap, device, s, plan);
    case 2: return launch<T, 2>(a, wide, force, partial_cap, ticket_cap, device, s, plan);
    case 4: return launch<T, 4>(a, wide, force, partial_cap, ticket_cap, device, s, plan);
    default:
      if constexpr (sizeof(T) == 2)
        return launch<T, 8>(a, wide, force, partial_cap, ticket_cap, device, s, plan);
      return cudaErrorInvalidValue;
  }
}

int bn_stats(const void* x, const float* pivot, int self_pivot,
             float* partial, long long partial_cap, unsigned* tickets,
             int ticket_cap, float* out, long long rows, int channels,
             long long inner, int dtype, int device, void* stream,
             Force force, Plan* plan) {
  if (rows < 1 || channels < 1 || inner < 1 || inner > 0x7fffffffLL ||
      force.splits < 0 || force.group < 0 || force.tickets < 0)
    return (int)cudaErrorInvalidValue;
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  Args a{};
  a.x = x;
  a.pivot = pivot;
  a.self_pivot = self_pivot;
  a.partial = partial;
  a.tickets = tickets;
  a.out = out;
  a.rows = rows;
  a.channels = channels;
  a.inner = (int)inner;
  a.inv_count = 1.0 / ((double)rows * (double)inner);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: err = dispatch<float>(a, force, partial_cap, ticket_cap, device, s, plan); break;
    case 1: err = dispatch<__nv_bfloat16>(a, force, partial_cap, ticket_cap, device, s, plan); break;
    case 2: err = dispatch<__half>(a, force, partial_cap, ticket_cap, device, s, plan); break;
    default: err = cudaErrorInvalidValue;
  }
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

}  // namespace

extern "C" {

// x: a row-major (rows, channels, inner) array on `device` (contiguous
// NCHW: rows = N, inner = H*W; channels-last: rows = N*H*W, inner = 1),
// dtype 0 = fp32, 1 = bf16, 2 = fp16.  The shift p is pivot[c] when
// `pivot` is not null, x[0, c, 0] when `self_pivot`, else 0.  out: 2 *
// channels fp32, mean then var.  partial (`partial_cap` floats) and tickets
// (`ticket_cap` counters, all zero) are the caller's scratch for `stream`,
// kept between calls.  The route, the load width and the grid are chosen
// here, from the sizes and the base address of x.  Launches one kernel on
// `stream` without synchronising and returns cudaGetLastError() (0 on
// success).
int mxt_bn_stats(const void* x, const float* pivot, int self_pivot,
                 float* partial, long long partial_cap, unsigned* tickets,
                 int ticket_cap, float* out, long long rows, int channels,
                 long long inner, int dtype, int device, void* stream) {
  return bn_stats(x, pivot, self_pivot, partial, partial_cap, tickets,
                  ticket_cap, out, rows, channels, inner, dtype, device,
                  stream, Force{0, 0, 0}, nullptr);
}

// mxt_bn_stats for tests and logs: `splits` and `group` > 0 force S and G
// (0: chosen as mxt_bn_stats chooses them), `fold_tickets` = 1 folds 2-8
// slices through the tickets instead of a cluster, and plan receives
// {wide, vec, group, splits, groups, blocks per SM, cluster} of the launch.
int mxt_bn_stats_plan(const void* x, const float* pivot, int self_pivot,
                      float* partial, long long partial_cap,
                      unsigned* tickets, int ticket_cap, float* out,
                      long long rows, int channels, long long inner,
                      int dtype, int device, void* stream, int splits,
                      int group, int fold_tickets, int* plan) {
  Plan pl{};
  const int err = bn_stats(x, pivot, self_pivot, partial, partial_cap,
                           tickets, ticket_cap, out, rows, channels, inner,
                           dtype, device, stream,
                           Force{splits, group, fold_tickets}, &pl);
  plan[0] = pl.wide;
  plan[1] = pl.vec;
  plan[2] = pl.group;
  plan[3] = pl.splits;
  plan[4] = pl.groups;
  plan[5] = pl.blocks_per_sm;
  plan[6] = pl.cluster;
  return err;
}

}  // extern "C"
