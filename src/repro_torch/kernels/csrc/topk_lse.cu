// Top-k + logsumexp summary of logits rows, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/topk_lse.py::topk_lse
// (_topk_lse_kernel): logits [T, V] f32 -> top-k values [T, k] f32
// (descending, ties to the lowest vocab index, jax.lax.top_k order), their
// vocab indices [T, k] i32 and the exact logsumexp [T] f32.
//
// Bound on the H100: memory. The logits are read once (T * V * 4 bytes,
// 4.1 MB at T = 8, V = 128256) and the outputs are tiny, so the floor is
// about 1.2 us at 3.35 TB/s; the arithmetic (one exp per logit) is far
// below the card's rate.
//
// Design: the TPU kernel walks the vocab axis in order on one core and
// carries (max, sumexp, running top-k) in VMEM scratch. Blocks on Hopper run
// in parallel and in no order, and one block per row would leave most of the
// 132 SMs idle at serving batch sizes (T = slots = 8). So the vocab axis is
// cut into kChunk-wide chunks:
//   pass 1 (grid C x T): each block stages its chunk in shared memory, reduces
//     (chunk max, chunk sumexp) and selects the chunk's own top-k;
//   pass 2 (grid T): one block per row merges the C partial (max, sumexp)
//     pairs into the exact lse and the C * k partial candidates into the row's
//     top-k.
// Selection is k rounds of a block-wide argmax under the total order
// (value descending, index ascending); every thread caches the best of its
// own strided entries, so a round costs one warp-shuffle reduction plus two
// barriers and only the winning thread rescans its entries. Any member of the
// row's top-k is in its chunk's top-k under the same order, so the merge is
// exact. This is the simple version: a threshold or radix select that skips
// most of the chunk is the obvious next step.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 4096;    // vocab entries per pass-1 block
constexpr int kMaxK = 64;       // largest k supported
constexpr int kMaxCand = 4096;  // pass-2 candidates per row (C * k)

// a strictly precedes b in the output order
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

__device__ __forceinline__ void warp_best(float& v, int& i, int& p) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    const int op = __shfl_down_sync(0xffffffffu, p, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
      p = op;
    }
  }
}

__device__ float block_max(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_down_sync(0xffffffffu, x, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < kWarps ? red[lane] : -INFINITY;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x = fmaxf(x, __shfl_down_sync(0xffffffffu, x, off));
    if (lane == 0) red[kWarps] = x;
  }
  __syncthreads();
  const float out = red[kWarps];
  __syncthreads();
  return out;
}

__device__ float block_sum(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < kWarps ? red[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) red[kWarps] = x;
  }
  __syncthreads();
  const float out = red[kWarps];
  __syncthreads();
  return out;
}

// k rounds of block argmax over s_v/s_i[0, n); round r writes the r-th best
// (value, index) to out_v/out_i[r]. Taken entries become the sentinel
// (-inf, INT_MAX), which every real entry precedes; if n < k the tail of the
// output is that sentinel.
__device__ void block_topk(float* s_v, int* s_i, int n, int k, float* out_v,
                           int* out_i) {
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int red_p[kWarps];
  __shared__ int win_p;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float bv = -INFINITY;
  int bi = INT_MAX, bp = -1;
  for (int p = tid; p < n; p += kThreads) {
    if (better(s_v[p], s_i[p], bv, bi)) {
      bv = s_v[p];
      bi = s_i[p];
      bp = p;
    }
  }
  for (int r = 0; r < k; ++r) {
    float v = bv;
    int i = bi, p = bp;
    warp_best(v, i, p);
    if (lane == 0) {
      red_v[warp] = v;
      red_i[warp] = i;
      red_p[warp] = p;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < kWarps ? red_v[lane] : -INFINITY;
      i = lane < kWarps ? red_i[lane] : INT_MAX;
      p = lane < kWarps ? red_p[lane] : -1;
      warp_best(v, i, p);
      if (lane == 0) {
        out_v[r] = v;
        out_i[r] = i;
        win_p = p;
      }
    }
    __syncthreads();
    const int wp = win_p;
    if (wp >= 0 && wp % kThreads == tid) {
      s_v[wp] = -INFINITY;
      s_i[wp] = INT_MAX;
      bv = -INFINITY;
      bi = INT_MAX;
      bp = -1;
      for (int q = tid; q < n; q += kThreads) {
        if (better(s_v[q], s_i[q], bv, bi)) {
          bv = s_v[q];
          bi = s_i[q];
          bp = q;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    topk_partial(const float* __restrict__ logits, int V, int k, int C,
                 float* part_v, int* part_i, float* part_m, float* part_s) {
  __shared__ float s_v[kChunk];
  __shared__ int s_i[kChunk];
  __shared__ float red[kWarps + 1];
  const int c = blockIdx.x, t = blockIdx.y;
  const int start = c * kChunk;
  const int n = min(kChunk, V - start);
  const float* row = logits + (size_t)t * V + start;

  float m = -INFINITY;
  for (int p = threadIdx.x; p < n; p += kThreads) {
    const float x = row[p];
    s_v[p] = x;
    s_i[p] = start + p;
    m = fmaxf(m, x);
  }
  m = block_max(m, red);
  float s = 0.f;
  if (m != -INFINITY)
    for (int p = threadIdx.x; p < n; p += kThreads) s += expf(s_v[p] - m);
  s = block_sum(s, red);
  const size_t slot = (size_t)t * C + c;
  if (threadIdx.x == 0) {
    part_m[slot] = m;
    part_s[slot] = s;
  }
  block_topk(s_v, s_i, n, k, part_v + slot * k, part_i + slot * k);
}

__global__ void __launch_bounds__(kThreads)
    topk_merge(int C, int k, const float* __restrict__ part_v,
               const int* __restrict__ part_i,
               const float* __restrict__ part_m,
               const float* __restrict__ part_s, float* vals, int* idx,
               float* lse) {
  __shared__ float s_v[kMaxCand];
  __shared__ int s_i[kMaxCand];
  __shared__ float red[kWarps + 1];
  const int t = blockIdx.x;
  const int n = C * k;
  for (int p = threadIdx.x; p < n; p += kThreads) {
    s_v[p] = part_v[(size_t)t * n + p];
    s_i[p] = part_i[(size_t)t * n + p];
  }
  float m = -INFINITY;
  for (int c = threadIdx.x; c < C; c += kThreads)
    m = fmaxf(m, part_m[(size_t)t * C + c]);
  m = block_max(m, red);
  float s = 0.f;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float mc = part_m[(size_t)t * C + c];
    if (mc != -INFINITY) s += part_s[(size_t)t * C + c] * expf(mc - m);
  }
  s = block_sum(s, red);
  if (threadIdx.x == 0) lse[t] = m == -INFINITY ? -INFINITY : m + logf(s);
  block_topk(s_v, s_i, n, k, vals + (size_t)t * k, idx + (size_t)t * k);
}

}  // namespace

// Launch both passes on `stream`. Scratch: part_v/part_i [T, C, k],
// part_m/part_s [T, C] with C = ceil(V / kChunk). Returns the cudaError_t of
// the launches (0 on success); nothing is synchronised.
extern "C" int topk_lse_f32(const float* logits, int T, int V, int k,
                            float* part_v, int* part_i, float* part_m,
                            float* part_s, float* vals, int* idx, float* lse,
                            void* stream) {
  if (T <= 0 || V <= 0 || k <= 0 || k > kMaxK || k > V || T > 65535)
    return (int)cudaErrorInvalidValue;
  const int C = (V + kChunk - 1) / kChunk;
  if (C * k > kMaxCand) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  topk_partial<<<dim3(C, T), kThreads, 0, s>>>(logits, V, k, C, part_v,
                                                 part_i, part_m, part_s);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  topk_merge<<<T, kThreads, 0, s>>>(C, k, part_v, part_i, part_m, part_s, vals,
                                    idx, lse);
  return (int)cudaGetLastError();
}
