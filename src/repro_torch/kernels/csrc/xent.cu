// Per-token cross-entropy, forward and backward, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/xent.py::xent_fwd
// (_fwd_kernel) and src/repro/kernels/xent.py::xent_bwd (_bwd_kernel):
//   forward:  logits [T, V] (bf16 or f32), labels [T] i32
//             -> loss [T] f32 = lse - logits[label], lse [T] f32;
//             a label below 0 picks nothing (loss = lse);
//   backward: (exp(logits - lse) - onehot(label)) * g -> [T, V] in logits'
//             dtype, from the saved lse alone (a label below 0 subtracts
//             nothing, as jax.nn.one_hot(-1) is a zero row).
//
// Bound on the H100: memory. The forward reads the logits once (T * V * 2
// bytes in bf16: 1.05 GB at T = 4096, V = 128256, 0.31 ms at 3.35 TB/s) and
// writes 8 bytes per row; the backward reads them once more and writes a
// gradient of the same size. One exp per logit is far below the card's
// arithmetic rate.
//
// Design: the TPU kernel walks vocab blocks in order and carries the running
// (max, sumexp, picked) in VMEM scratch across grid steps. Blocks on Hopper
// run in no order, so the vocab walk becomes a loop inside one block per
// row: each thread streams its strided 16-byte vectors of the row (8 bf16
// or 4 f32 values) with an online max / sum-exp in f32, then a warp-shuffle
// and a shared-memory step merge the (max, sum) pairs. Thread 0 reads the
// label's logit directly. Logits are read in their own dtype: no f32 copy of
// [T, V] is ever made. Rows whose byte length is not a multiple of 16 take
// a scalar loop. T >= 1024 on the training path gives 8 or more blocks per
// SM; a split of long rows across blocks would help small T and is left for
// later. The backward is a fused elementwise pass with the same row layout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Running max m and sum of exp(x - m); m == -inf means nothing seen yet.
struct MaxSum {
  float m, s;
};

__device__ __forceinline__ MaxSum merge(MaxSum a, MaxSum b) {
  const float m = fmaxf(a.m, b.m);
  if (m == -INFINITY) return {m, 0.f};
  return {m, a.s * expf(a.m - m) + b.s * expf(b.m - m)};
}

// Fold n values into (m, s): rescale once by the group's max, then one exp
// per value.
template <int N>
__device__ __forceinline__ void fold(MaxSum& acc, const float (&x)[N]) {
  float vm = x[0];
#pragma unroll
  for (int k = 1; k < N; ++k) vm = fmaxf(vm, x[k]);
  if (vm > acc.m) {
    acc.s *= expf(acc.m - vm);
    acc.m = vm;
  }
  const float base = acc.m == -INFINITY ? 0.f : acc.m;
#pragma unroll
  for (int k = 0; k < N; ++k) acc.s += expf(x[k] - base);
}

__device__ MaxSum block_merge(MaxSum v) {
  __shared__ float red_m[kWarps];
  __shared__ float red_s[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    MaxSum o{__shfl_xor_sync(0xffffffffu, v.m, off),
             __shfl_xor_sync(0xffffffffu, v.s, off)};
    v = merge(v, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red_m[warp] = v.m;
    red_s[warp] = v.s;
  }
  __syncthreads();
  MaxSum out{-INFINITY, 0.f};
  for (int w = 0; w < kWarps; ++w) out = merge(out, MaxSum{red_m[w], red_s[w]});
  return out;  // every thread holds the row's result
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    xent_fwd_kernel(const T* __restrict__ logits,
                    const int* __restrict__ labels, int V,
                    float* __restrict__ loss, float* __restrict__ lse) {
  constexpr int kPer = 16 / sizeof(T);  // values per 16-byte vector
  const int t = blockIdx.x;
  const T* row = logits + (size_t)t * V;
  MaxSum acc{-INFINITY, 0.f};
  if (kVec) {
    const uint4* row4 = reinterpret_cast<const uint4*>(row);
    const int nvec = V / kPer;
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      const uint4 raw = __ldg(row4 + i);
      const T* vals = reinterpret_cast<const T*>(&raw);
      float x[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) x[k] = to_f32(vals[k]);
      fold(acc, x);
    }
  } else {
    for (int i = threadIdx.x; i < V; i += kThreads) {
      const float x[1] = {to_f32(row[i])};
      fold(acc, x);
    }
  }
  acc = block_merge(acc);
  if (threadIdx.x == 0) {
    const float l = acc.m == -INFINITY ? -INFINITY : acc.m + logf(acc.s);
    const int lab = labels[t];
    const float picked = (lab >= 0 && lab < V) ? to_f32(row[lab]) : 0.f;
    lse[t] = l;
    loss[t] = l - picked;
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    xent_bwd_kernel(const T* __restrict__ logits,
                    const int* __restrict__ labels,
                    const float* __restrict__ lse, const float* __restrict__ g,
                    int V, T* __restrict__ grad) {
  constexpr int kPer = 16 / sizeof(T);
  const int t = blockIdx.x;
  const T* row = logits + (size_t)t * V;
  T* out = grad + (size_t)t * V;
  const float l = lse[t], gt = g[t];
  const int lab = labels[t];  // < 0 matches no column
  if (kVec) {
    const uint4* row4 = reinterpret_cast<const uint4*>(row);
    uint4* out4 = reinterpret_cast<uint4*>(out);
    const int nvec = V / kPer;
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      const uint4 raw = __ldg(row4 + i);
      const T* vals = reinterpret_cast<const T*>(&raw);
      uint4 res;
      T* o = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const float hit = (i * kPer + k == lab) ? 1.f : 0.f;
        o[k] = from_f32<T>((expf(to_f32(vals[k]) - l) - hit) * gt);
      }
      out4[i] = res;
    }
  } else {
    for (int i = threadIdx.x; i < V; i += kThreads) {
      const float hit = (i == lab) ? 1.f : 0.f;
      out[i] = from_f32<T>((expf(to_f32(row[i]) - l) - hit) * gt);
    }
  }
}

template <typename T>
int launch_fwd(const void* logits, const int* labels, int T_, int V, int vec,
               float* loss, float* lse, cudaStream_t s) {
  const T* x = static_cast<const T*>(logits);
  if (vec)
    xent_fwd_kernel<T, true><<<T_, kThreads, 0, s>>>(x, labels, V, loss, lse);
  else
    xent_fwd_kernel<T, false><<<T_, kThreads, 0, s>>>(x, labels, V, loss, lse);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* logits, const int* labels, const float* lse,
               const float* g, int T_, int V, int vec, void* grad,
               cudaStream_t s) {
  const T* x = static_cast<const T*>(logits);
  T* out = static_cast<T*>(grad);
  if (vec)
    xent_bwd_kernel<T, true><<<T_, kThreads, 0, s>>>(x, labels, lse, g, V,
                                                     out);
  else
    xent_bwd_kernel<T, false><<<T_, kThreads, 0, s>>>(x, labels, lse, g, V,
                                                      out);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. vec = 1 when every row starts on a
// 16-byte boundary (V * itemsize % 16 == 0 and an aligned base pointer).
// Each returns the cudaError_t of its launch (0 on success); nothing is
// synchronised.
extern "C" int xent_fwd(int dtype, const void* logits, const int* labels,
                        int T, int V, int vec, float* loss, float* lse,
                        void* stream) {
  if (T <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float>(logits, labels, T, V, vec, loss, lse, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(logits, labels, T, V, vec, loss, lse, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int xent_bwd(int dtype, const void* logits, const int* labels,
                        const float* lse, const float* g, int T, int V,
                        int vec, void* grad, void* stream) {
  if (T <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(logits, labels, lse, g, T, V, vec, grad, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(logits, labels, lse, g, T, V, vec, grad,
                                     s);
  return (int)cudaErrorInvalidValue;
}
