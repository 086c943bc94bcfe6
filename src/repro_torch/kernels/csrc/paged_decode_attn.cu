// Single-token GQA decode attention through a paged KV pool, hand-written
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attn.py::paged_decode_attn (_paged_decode_kernel):
// q [B, Hq, D], K/V page pools [P, page, Hkv, D], page table [B, NP] i32
// (-1 = unallocated), pos [B] i32 -> out [B, Hq, D]. Position t of row b is
// attended iff t <= pos[b] and its page is allocated.
//
// Bound on the H100: memory. Every K and V row up to pos is read once (at
// B = 8, context 160, Hkv = 8, D = 128 in bf16: about 5.2 MB per layer, about
// 1.6 us at 3.35 TB/s); the arithmetic is 4 * Hq * D flops per position,
// two orders of magnitude under the bf16 rate.
//
// Design: the TPU grid (B, Hkv, NP) carries the online-softmax state across
// its sequential page axis in VMEM scratch. Here one block owns one
// (row, kv-head) pair and turns the page axis into a loop: it reads the
// page id from the table and walks the page's attended positions in tiles
// of kTile, staging each tile's K and V rows of its kv head in shared
// memory (rows padded by one float so the per-position dot products hit
// distinct banks). It scores the G = Hq / Hkv query heads of the group
// together and keeps the f32 running (max, sum, accumulator) of each query
// head, the accumulator in registers. Shared memory is fixed by (G, D) and
// kTile, not by the page size, so any page size runs (at most 41 KiB, at
// G = 8 and D = 256). Pages past pos are never read and unallocated pages
// (-1) are skipped whole, so the bytes moved are exactly the attended K/V
// rows. A page id past the pool's end is a caller's bug: a device assert
// stops the kernel, as an out-of-range index stops the plain version.
// Blocks per layer are B * Hkv (64 at B = 8), under one per SM: splitting
// long contexts across blocks is the next step.

#include <assert.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxG = 8;      // query heads per kv head
constexpr int kMaxD = 256;    // head dim
constexpr int kDPT = kMaxD / kThreads;
constexpr int kTile = 16;     // positions staged per loop step

constexpr size_t smem_bytes(int G, int D) {
  return sizeof(float) * ((size_t)G * D + (size_t)kTile * (2 * D + 1) +
                          (size_t)G * kTile + 3 * (size_t)G);
}
static_assert(smem_bytes(kMaxG, kMaxD) <= 48 * 1024,
              "the largest (G, D) must fit the default shared memory");

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
    paged_decode(const T* __restrict__ q, const T* __restrict__ kp,
                 const T* __restrict__ vp, const int* __restrict__ pt,
                 const int* __restrict__ pos, T* __restrict__ out, int Hq,
                 int Hkv, int D, int page, int NP, int P, float scale) {
  extern __shared__ float sm[];
  const int G = Hq / Hkv;
  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int tid = threadIdx.x;
  float* q_s = sm;                     // [G, D]
  float* k_s = q_s + G * D;            // [kTile, D + 1]
  float* v_s = k_s + kTile * (D + 1);  // [kTile, D]
  float* p_s = v_s + kTile * D;        // [G, kTile]
  float* m_s = p_s + G * kTile;        // [G] running max
  float* l_s = m_s + G;                // [G] running sum
  float* c_s = l_s + G;                // [G] this tile's rescale factor

  const size_t qbase = ((size_t)b * Hq + (size_t)h * G) * D;
  for (int x = tid; x < G * D; x += kThreads) q_s[x] = to_f(q[qbase + x]);
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[kMaxG][kDPT];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int u = 0; u < kDPT; ++u) acc[g][u] = 0.f;
  __syncthreads();

  const int last = pos[b];  // inclusive
  const int npg = last < 0 ? 0 : min(NP, last / page + 1);
  for (int pi = 0; pi < npg; ++pi) {
    const int pg = pt[(size_t)b * NP + pi];
    if (pg < 0) continue;  // unallocated: masked whole, never read
    assert(pg < P);        // a page id past the pool: the table is corrupt
    const int nin = min(page, last - pi * page + 1);  // attended here
    for (int j0 = 0; j0 < nin; j0 += kTile) {
      const int ntok = min(kTile, nin - j0);
      for (int x = tid; x < ntok * D; x += kThreads) {
        const int j = x / D, d = x - j * D;
        const size_t off = (((size_t)pg * page + j0 + j) * Hkv + h) * D + d;
        k_s[j * (D + 1) + d] = to_f(kp[off]);
        v_s[j * D + d] = to_f(vp[off]);
      }
      __syncthreads();
      for (int x = tid; x < G * ntok; x += kThreads) {
        const int g = x / ntok, j = x - g * ntok;
        const float* qr = q_s + g * D;
        const float* kr = k_s + j * (D + 1);
        float s = 0.f;
        for (int d = 0; d < D; ++d) s += qr[d] * kr[d];
        p_s[g * kTile + j] = s * scale;
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
        const float corr = expf(m_old - m_new);  // 0 on the first tile
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
      __syncthreads();
    }
  }

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
int launch(const void* q, const void* kp, const void* vp, const int* pt,
           const int* pos, void* out, int B, int Hq, int Hkv, int D, int page,
           int NP, int P, float scale, cudaStream_t s) {
  const int G = Hq / Hkv;
  const size_t smem = smem_bytes(G, D);
  paged_decode<T><<<B * Hkv, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), pt, pos, static_cast<T*>(out), Hq, Hkv, D,
      page, NP, P, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it). Launches on
// `stream`, returns the launch's cudaError_t (0 on success), never
// synchronises.
extern "C" int paged_decode_attn(int dtype, const void* q, const void* kp,
                                 const void* vp, const int* pt, const int* pos,
                                 void* out, int B, int Hq, int Hkv, int D,
                                 int page, int NP, int P, float scale,
                                 void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxG || D <= 0 ||
      D > kMaxD || page <= 0 || NP <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, kp, vp, pt, pos, out, B, Hq, Hkv, D, page, NP, P,
                         scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, kp, vp, pt, pos, out, B, Hq, Hkv, D, page,
                                 NP, P, scale, s);
  return (int)cudaErrorInvalidValue;
}
