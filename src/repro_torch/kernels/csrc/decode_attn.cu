// Single-token GQA decode attention against a dense KV cache with a validity
// mask, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attn.py::decode_attn (_decode_kernel):
// q [B, Hq, D], K/V [B, T, Hkv, D], valid [B, T] (bytes, 0 or 1) ->
// out [B, Hq, D] in q's dtype. The mask carries every cache layout: slot
// occupancy, rolling sliding-window slots, windows. A masked score is
// -1e30, as in the Pallas kernel and the plain version, so a row with no
// valid position gets uniform weights: the mean of V over all T.
//
// Bound on the H100: memory. Each attended K and V row is read once (at
// zamba2-2.7b's decode, B = 8, T = 332, Hkv = 32, D = 80 in bf16: about
// 27 MB, 8 us at 3.35 TB/s; at llama3-8b's, Hkv = 8, D = 128, T = 160:
// about 5.2 MB, 1.6 us); the arithmetic is 4 * Hq * D flops per position,
// two orders of magnitude under the bf16 rate.
//
// Design: the TPU grid (B, Hkv, T / bt) carries the online-softmax state
// across its sequential T axis in VMEM scratch. Here one block owns one
// (row, kv head) and turns the T axis into a loop over tiles of kTile
// positions, staged in shared memory as f32 (K rows padded by one float).
// It scores the G = Hq / Hkv query heads of the group together: each score
// is split over 8 lanes that each sum every eighth element of D and meet
// by warp shuffles, so all 128 threads work at G = 1 and any D (zamba2's
// 80 is no multiple of 32). The f32 running (max, sum) of each query head
// lives in shared memory, its accumulator in registers. The block first
// asks whether its row has any valid position; if it has, tiles with none
// are skipped (their weights are exactly 0, so the result is unchanged),
// otherwise every tile is read and weighted alike. T needs no padding.
// Blocks per call are B * Hkv (256 at zamba2's shape, 64 at llama3-8b's):
// splitting long caches across blocks is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxG = 8;    // query heads per kv head
constexpr int kMaxD = 256;  // head dim
constexpr int kDPT = kMaxD / kThreads;
constexpr int kTile = 16;   // positions staged per loop step
constexpr int kSplit = 8;   // lanes that share one score
constexpr float kMasked = -1e30f;

constexpr size_t smem_bytes(int G, int D) {
  return sizeof(float) * ((size_t)G * D + (size_t)kTile * (2 * D + 1) +
                          (size_t)G * kTile + 3 * (size_t)G);
}
static_assert(smem_bytes(kMaxG, kMaxD) <= 48 * 1024,
              "the largest (G, D) must fit the default shared memory");
static_assert(kThreads % kSplit == 0 && 32 % kSplit == 0, "lane groups");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dense_decode(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const uint8_t* __restrict__ valid,
                 T* __restrict__ out, int Hq, int Hkv, int D, int Tn,
                 float scale) {
  extern __shared__ float sm[];
  const int G = Hq / Hkv;
  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int tid = threadIdx.x;
  float* q_s = sm;                     // [G, D]
  float* k_s = q_s + G * D;            // [kTile, D + 1]
  float* v_s = k_s + kTile * (D + 1);  // [kTile, D]
  float* p_s = v_s + kTile * D;        // [G, kTile] scores, then weights
  float* m_s = p_s + G * kTile;        // [G] running max
  float* l_s = m_s + G;                // [G] running sum
  float* c_s = l_s + G;                // [G] this tile's rescale factor

  const size_t qbase = ((size_t)b * Hq + (size_t)h * G) * D;
  for (int x = tid; x < G * D; x += kThreads) q_s[x] = to_f(q[qbase + x]);
  if (tid < G) {
    m_s[tid] = kMasked;
    l_s[tid] = 0.f;
  }
  float acc[kMaxG][kDPT];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int u = 0; u < kDPT; ++u) acc[g][u] = 0.f;

  const uint8_t* vrow = valid + (size_t)b * Tn;
  int mine = 0;
  for (int t = tid; t < Tn; t += kThreads) mine |= vrow[t];
  // also the barrier after q_s and the running state are set
  const int row_any = __syncthreads_or(mine);

  const int part = tid % kSplit;
  for (int t0 = 0; t0 < Tn; t0 += kTile) {
    const int ntok = min(kTile, Tn - t0);
    const int tile_any = __syncthreads_or(tid < ntok && vrow[t0 + tid]);
    if (row_any && !tile_any) continue;  // uniform across the block
    for (int x = tid; x < ntok * D; x += kThreads) {
      const int j = x / D, d = x - j * D;
      const size_t off = (((size_t)b * Tn + t0 + j) * Hkv + h) * D + d;
      k_s[j * (D + 1) + d] = to_f(k[off]);
      v_s[j * D + d] = to_f(v[off]);
    }
    __syncthreads();
    // every thread runs the same number of rounds, so the shuffles below
    // always see full warps
    const int items = G * ntok * kSplit;
    for (int base = 0; base < items; base += kThreads) {
      const int x = base + tid;
      const int gj = x / kSplit;
      const int g = gj / ntok, j = gj - g * ntok;
      float s = 0.f;
      if (x < items) {
        const float* qr = q_s + g * D;
        const float* kr = k_s + j * (D + 1);
        for (int d = part; d < D; d += kSplit) s += qr[d] * kr[d];
      }
#pragma unroll
      for (int o = kSplit / 2; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (x < items && part == 0)
        p_s[g * kTile + j] = vrow[t0 + j] ? s * scale : kMasked;
    }
    __syncthreads();
    if (tid < G) {
      float* pr = p_s + tid * kTile;
      const float m_old = m_s[tid];
      float m_new = m_old;
      for (int j = 0; j < ntok; ++j) m_new = fmaxf(m_new, pr[j]);
      float sum = 0.f;
      for (int j = 0; j < ntok; ++j) {
        const float e = expf(pr[j] - m_new);
        pr[j] = e;
        sum += e;
      }
      const float corr = expf(m_old - m_new);
      l_s[tid] = l_s[tid] * corr + sum;
      m_s[tid] = m_new;
      c_s[tid] = corr;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kDPT; ++u) {
      const int d = tid + u * kThreads;
      if (d < D) {
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const float* pr = p_s + g * kTile;
            float a = acc[g][u] * c_s[g];
            for (int j = 0; j < ntok; ++j) a += pr[j] * v_s[j * D + d];
            acc[g][u] = a;
          }
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int u = 0; u < kDPT; ++u) {
    const int d = tid + u * kThreads;
    if (d < D) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G)
          out[qbase + (size_t)g * D + d] =
              from_f<T>(acc[g][u] / fmaxf(l_s[g], 1e-30f));
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const uint8_t* valid,
           void* out, int B, int Hq, int Hkv, int D, int Tn, float scale,
           cudaStream_t s) {
  const size_t smem = smem_bytes(Hq / Hkv, D);
  dense_decode<T><<<B * Hkv, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid, static_cast<T*>(out), Hq, Hkv, D, Tn,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it); valid holds
// one byte per (row, position). Launches on `stream`, returns the launch's
// cudaError_t (0 on success), never synchronises.
extern "C" int decode_attn(int dtype, const void* q, const void* k,
                           const void* v, const void* valid, void* out, int B,
                           int Hq, int Hkv, int D, int Tn, float scale,
                           void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxG || D <= 0 ||
      D > kMaxD || Tn <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(valid);
  if (dtype == 0)
    return launch<float>(q, k, v, m, out, B, Hq, Hkv, D, Tn, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, m, out, B, Hq, Hkv, D, Tn, scale,
                                 s);
  return (int)cudaErrorInvalidValue;
}
