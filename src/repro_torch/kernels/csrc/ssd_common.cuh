// Pieces shared by the SSD scan's forward (ssd.cu) and backward
// (ssd_bwd.cu): shared-memory staging with 16-byte cp.async, the chunk's
// cumulative decay, and the tensor-core fragments of mma.sync m16n8k16
// (bf16 inputs, f32 accumulators) with the hi + lo split of an f32
// operand. Each source includes it in its own anonymous namespace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr size_t kMaxSmem = 232448;  // per block on sm_90

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}
__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

// x = hi + lo: hi the nearest bf16, lo the nearest bf16 to the rest
__device__ __forceinline__ void split_bf16(float x, bf16& hi, bf16& lo) {
  hi = __float2bfloat16(x);
  lo = __float2bfloat16(x - __bfloat162float(hi));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// dst[r, c] = src[r * gstride + c] for r < rows, c < cols, zero for
// rows <= r < rowsp or cols <= c < colsp, by a block of NT threads. `vec`
// (cols and colsp multiples of 16 / sizeof(T), rows 16-byte aligned):
// 16-byte cp.async copies, all in flight at once, complete after
// cp_async_wait_all(); else a plain copy.
template <int NT, typename T>
__device__ void stage(T* dst, int sstride, const T* src, size_t gstride,
                      int rows, int cols, int rowsp, int colsp, bool vec) {
  constexpr int E = 16 / sizeof(T);
  if (vec) {
    const int cv = colsp / E;
    for (int e = threadIdx.x; e < rowsp * cv; e += NT) {
      const int r = e / cv, c = (e - r * cv) * E;
      T* d = dst + r * sstride + c;
      if (r < rows && c < cols)
        cp_async16(d, src + r * gstride + c);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    constexpr int U = 8;  // loads in flight a thread
    for (int e0 = threadIdx.x; e0 < rowsp * colsp; e0 += U * NT) {
      T val[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * NT, r = e / colsp, c = e - r * colsp;
        val[u] = (e < rowsp * colsp && r < rows && c < cols)
                     ? src[r * gstride + c]
                     : static_cast<T>(0.f);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * NT, r = e / colsp, c = e - r * colsp;
        if (e < rowsp * colsp) dst[r * sstride + c] = val[u];
      }
    }
  }
}

// cum[i] = sum_{t <= i} dt[t] * a for i < n, by a block of NT threads: a
// block scan (warp shuffles, then the warps' totals in `sums`, NT / 32
// floats), NT steps at a time
template <int NT>
__device__ void chunk_cumsum(const float* dt_s, float a, float* cum,
                             float* sums, int n) {
  constexpr int W = NT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float carry = 0.f;
  for (int base = 0; base < n; base += NT) {
    const int i = base + threadIdx.x;
    float v = i < n ? dt_s[i] * a : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) sums[warp] = v;
    __syncthreads();
    if (warp == 0) {
      float t = lane < W ? sums[lane] : 0.f;
#pragma unroll
      for (int o = 1; o < W; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, t, o);
        if (lane >= o) t += u;
      }
      if (lane < W) sums[lane] = t;
    }
    __syncthreads();
    if (i < n) cum[i] = v + carry + (warp > 0 ? sums[warp - 1] : 0.f);
    carry += sums[W - 1];
    __syncthreads();
  }
}

// c += a (16 x 16, row-major fragment) . b (16 x 8, column-major
// fragment); not volatile: it touches no memory, so the compiler may put
// independent products side by side
__device__ __forceinline__ void mma_bf16(float& c0, float& c1, float& c2,
                                         float& c3, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c0), "+f"(c1), "+f"(c2), "+f"(c3)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
// the same with the fragments as arrays
__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  mma_bf16(c[0], c[1], c[2], c[3], a[0], a[1], a[2], a[3], b[0], b[1]);
}
__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// The A fragment (16 x 16, row-major) of a matrix kept K-major in shared
// memory: rows k of `s` hold the 16 M values from column m0, `ss` elements
// apart (the four 8 x 8 blocks read transposed)
__device__ __forceinline__ void lds_a_t(uint32_t* a, const bf16* s, int ss,
                                        int k0, int m0) {
  const int lane = threadIdx.x & 31, i = lane >> 3, r = lane & 7;
  const bf16* p = s + (k0 + r + 8 * (i >> 1)) * ss + m0 + 8 * (i & 1);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p)));
}
// The B fragment (16 x 8, column-major) of a matrix kept K-major: rows k of
// `s` hold the 8 N values from column n0
__device__ __forceinline__ void lds_b_t(uint32_t* b, const bf16* s, int ss,
                                        int k0, int n0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = s + (k0 + (lane & 15)) * ss + n0;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo_half, float hi_half) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_half, hi_half);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// two f32 values as the hi and lo halves of a fragment register each
__device__ __forceinline__ void split_pack(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - __low2float(h), v1 - __high2float(h));
}

// the (batch, head, chunk) of a block index without its fastest part
struct Chunk {
  int bh, b, h, g, c, c0, Lc;
};
__device__ __forceinline__ Chunk chunk_of(int bid, int H, int G, int S,
                                          int L, int nc) {
  Chunk k;
  k.c = bid % nc;
  k.bh = bid / nc;
  k.b = k.bh / H;
  k.h = k.bh - k.b * H;
  k.g = k.h / (H / G);
  k.c0 = k.c * L;
  k.Lc = min(L, S - k.c0);
  return k;
}

// A [L, P] x [L, nb] product over a chunk's steps on the tensor cores (the
// forward's state grid, the backward's contribution grid): x [L16, P16 + 8]
// and the f32 factor's hi, lo [L16, nb + 8] in bf16 (rows as in device
// memory; the products read them K-major with ldmatrix.trans), dt, cum, w
// [L16] f32, the scan's sums, a flag
struct StateTC {
  int P16, L16, PS, NBS;
  size_t bhi, blo, dt, cum, w, sums, flag, total;
};
__host__ __device__ inline StateTC state_tc(int L, int P, int nb) {
  StateTC y;
  y.P16 = round_up(P, 16);
  y.L16 = round_up(L, 16);
  y.PS = y.P16 + 8;
  y.NBS = nb + 8;
  size_t o = align16((size_t)y.L16 * y.PS * 2);
  y.bhi = o;
  o += align16((size_t)y.L16 * y.NBS * 2);
  y.blo = o;
  o += align16((size_t)y.L16 * y.NBS * 2);
  y.dt = o;
  o += align16((size_t)y.L16 * 4);
  y.cum = o;
  o += align16((size_t)y.L16 * 4);
  y.w = o;
  o += align16((size_t)y.L16 * 4);
  y.sums = o;
  o += align16(8 * 4);
  y.flag = o;
  o += 16;
  y.total = o;
  return y;
}

// opt a kernel in to the shared memory it needs past the default 48 KB
template <typename K>
cudaError_t opt_in(K kernel, size_t smem, size_t& opted) {
  if (smem <= opted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (err == cudaSuccess) opted = kMaxSmem;
  return err;
}

}  // namespace
