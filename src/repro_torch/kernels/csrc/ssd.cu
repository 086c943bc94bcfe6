// Mamba2 SSD chunk scan, hand-written for Hopper (sm_90a): chunks in
// parallel, products on the tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd.py::ssd
// (_ssd_kernel): x [B, S, H, P], dt [B, S, H] f32 (positive), a [H] f32
// (negative), B and C [B, S, G, N] -> y [B, S, H, P] in x's dtype and the
// final state [B, H, P, N] f32. Per chunk of L steps, with
// cum = cumsum(dt * a) inside the chunk:
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j     (intra)
//         + exp(cum_i) C_i . state_in                               (inter)
//   state_out = exp(cum_L) state_in + x^T (B * exp(cum_L - cum) * dt)
//
// Bound on the H100: at the serving shapes, the operations. A chunk of
// L = 128 costs about 2 L^2 N / 2 + 2 L^2 P / 2 + 4 L N P flops per head
// (7.3 MFLOP at mamba2-370m's P = 64, N = 128), against (2 P + 2 N) L
// bytes of bf16 input: on the CUDA cores' 67 TFLOP/s the work outweighs
// the bytes; on the tensor cores it no longer does.
//
// Design: the TPU grid (B, H, chunks) runs its chunk axis in order and
// carries the [P, N] state in VMEM scratch. Here the chunks of one (batch,
// head) run in parallel, in two grids, as models/ssm.py::ssd_chunked
// computes them:
//   ssd_scan_state*, one block per (batch, head, chunk, half of N when the
//     grid is short of blocks): the chunk's cumsum (a block scan), its
//     contribution x^T (B * w) [P, N] with w = exp(cum_L - cum) dt, and its
//     decay exp(cum_L), both to f32 scratch. The last block of a (batch,
//     head) to finish (a ticket from a counter it puts back to 0) folds the
//     chunks in order, state_in(c + 1) = state_in(c) exp(cum_L(c)) +
//     contribution(c), overwriting each contribution with the state that
//     enters its chunk, and writes the final state: the only sequential
//     part, P N values per chunk, in f32.
//   ssd_scan_out*: y = scores . x + exp(cum_i) C . state_in, the scores
//     (C . B^T) exp(cum_i - cum_j) dt_j taken for j <= i only. In bf16 one
//     block per (batch, head, chunk), FlashAttention-2's shape: each warp
//     computes 16 x 16 slices of its rows' scores on the tensor cores,
//     decays them in registers and feeds them, as the A fragment of the
//     next product, straight into y = scores . x; the scores never touch
//     shared memory. Warps pair the 16-row tiles t and 7 - t, so each has
//     the same share of the triangle. In f32, one block per 64 rows of a
//     chunk, the scores staged in shared memory.
// In bf16 every product runs on the tensor cores (mma.sync m16n8k16, bf16
// inputs, f32 accumulators). C . B^T has bf16 operands on both sides, so
// each product is exact. The other three have an f32 operand (the scores,
// B * w, the entering state): it is split into hi + lo bf16 halves, two
// products each, which keeps about 16 of its 24 bits (a relative error
// near 2^-17 where a plain bf16 operand would give 2^-9), far inside the
// one bf16 unit in the last place that the output's tolerance allows. The
// f32 path (the smoke configurations' card-against-CPU reference) keeps
// every product in f32 on the CUDA cores, register-tiled.
// A block issues every copy of its chunk at once (16-byte cp.async, rows
// padded by 16 bytes so that the eight rows of a fragment or ldmatrix read
// hit distinct banks) and keeps rows as they lie in device memory: where a
// product needs them K-major (x, B * w over the chunk's steps), ldmatrix
// .trans reads them transposed. exp(cum_i - cum_j) is taken only on and
// below the diagonal, where it cannot overflow; a last chunk shorter than L
// runs as it is (the TPU kernel pads it with dt = 0 steps, exact no-ops).
// Shared memory bounds N: a block of the f32 output grid keeps its rows of
// C, and B or the entering state, for all of N, and takes 32 rows instead
// of 64 where 64 do not fit, so at L = 128, P = 64 it takes N up to 272;
// the bf16 output grid keeps all of C, B and the state, N up to 256
// (ssd.py's smem_bytes mirrors the layouts; the wrapper refuses what does
// not fit).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRB = 64;              // output rows per block of ssd_scan_out
constexpr int kRBSmall = 32;         // ... of ssd_scan_out_f32 at a large N
constexpr size_t kMaxSmem = 232448;  // per block on sm_90

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}
__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// ---------------------------------------------------------------------------
// shared-memory layouts (ssd.py mirrors them)
// ---------------------------------------------------------------------------

// ssd_scan_state_f32: x [L, P8], B * w [L, nb4], dt, cum, w [L], sums, flag
struct StateF32 {
  int P8, nb4;
  size_t bw, dt, cum, w, sums, flag, total;
};
__host__ __device__ inline StateF32 state_f32(int L, int P, int nb) {
  StateF32 y;
  y.P8 = round_up(P, 8);
  y.nb4 = round_up(nb, 4);
  size_t o = align16((size_t)L * y.P8 * 4);
  y.bw = o;
  o += align16((size_t)L * y.nb4 * 4);
  y.dt = o;
  o += align16((size_t)L * 4);
  y.cum = o;
  o += align16((size_t)L * 4);
  y.w = o;
  o += align16((size_t)L * 4);
  y.sums = o;
  o += align16(kWarps * 4);
  y.flag = o;
  o += 16;
  y.total = o;
  return y;
}

// ssd_scan_out_f32 with R rows a block: x [L, P8], scores^T [L8, R + 4],
// C [R, CS], then B [L8, CS] or, once the scores are out, state_in^T
// [Np, P8 + 4] in the same bytes; dt, cum [L8], exp(cum) [R], sums (all
// f32)
struct OutF32 {
  int P8, Np, CS, L8;
  size_t st, c, u, dt, cum, ecum, sums, total;
};
template <int R = kRB>
__host__ __device__ inline OutF32 out_f32(int L, int P, int N) {
  OutF32 y;
  y.P8 = round_up(P, 8);
  y.Np = round_up(N, 16);
  y.CS = y.Np + 4;
  y.L8 = round_up(L, 8);
  size_t o = align16((size_t)L * y.P8 * 4);
  y.st = o;
  o += align16((size_t)y.L8 * (R + 4) * 4);
  y.c = o;
  o += align16((size_t)R * y.CS * 4);
  y.u = o;
  const size_t bsz = (size_t)y.L8 * y.CS * 4;
  const size_t ssz = (size_t)y.Np * (y.P8 + 4) * 4;
  o += align16(bsz > ssz ? bsz : ssz);
  y.dt = o;
  o += align16((size_t)y.L8 * 4);
  y.cum = o;
  o += align16((size_t)y.L8 * 4);
  y.ecum = o;
  o += align16(R * 4);
  y.sums = o;
  o += align16(kWarps * 4);
  y.total = o;
  return y;
}

// ssd_scan_state_tc: x [L16, P16 + 8] and B * w hi, lo [L16, nb + 8] in
// bf16 (rows as in device memory; the products read them K-major with
// ldmatrix.trans), dt, cum, w [L16] f32, sums, flag
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
  o += align16(kWarps * 4);
  y.flag = o;
  o += 16;
  y.total = o;
  return y;
}

// ssd_scan_out_tc: C, B [L16, Np + 8], x [L16, P16 + 8] and the entering
// state's hi, lo [P16, Np + 8] in bf16, dt, cum [L16] f32, sums
struct OutTC {
  int P16, Np, CS, PS, L16;
  size_t b, x, shi, slo, dt, cum, sums, total;
};
__host__ __device__ inline OutTC out_tc(int L, int P, int N) {
  OutTC y;
  y.P16 = round_up(P, 16);
  y.Np = round_up(N, 16);
  y.CS = y.Np + 8;
  y.PS = y.P16 + 8;
  y.L16 = round_up(L, 16);
  size_t o = align16((size_t)y.L16 * y.CS * 2);
  y.b = o;
  o += align16((size_t)y.L16 * y.CS * 2);
  y.x = o;
  o += align16((size_t)y.L16 * y.PS * 2);
  y.shi = o;
  o += align16((size_t)y.P16 * y.CS * 2);
  y.slo = o;
  o += align16((size_t)y.P16 * y.CS * 2);
  y.dt = o;
  o += align16((size_t)y.L16 * 4);
  y.cum = o;
  o += align16((size_t)y.L16 * 4);
  y.sums = o;
  o += align16(kWarps * 4);
  y.total = o;
  return y;
}

// ---------------------------------------------------------------------------
// helpers
// ---------------------------------------------------------------------------

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
// rows <= r < rowsp or cols <= c < colsp. `vec` (cols and colsp multiples
// of 16 / sizeof(T), rows 16-byte aligned): 16-byte cp.async copies, all in
// flight at once, complete after cp_async_wait_all(); else a plain copy.
template <typename T>
__device__ void stage(T* dst, int sstride, const T* src, size_t gstride,
                      int rows, int cols, int rowsp, int colsp, bool vec) {
  constexpr int E = 16 / sizeof(T);
  if (vec) {
    const int cv = colsp / E;
    for (int e = threadIdx.x; e < rowsp * cv; e += kThreads) {
      const int r = e / cv, c = (e - r * cv) * E;
      T* d = dst + r * sstride + c;
      if (r < rows && c < cols)
        cp_async16(d, src + r * gstride + c);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    constexpr int U = 8;  // loads in flight a thread
    for (int e0 = threadIdx.x; e0 < rowsp * colsp; e0 += U * kThreads) {
      T val[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * kThreads, r = e / colsp, c = e - r * colsp;
        val[u] = (e < rowsp * colsp && r < rows && c < cols)
                     ? src[r * gstride + c]
                     : static_cast<T>(0.f);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * kThreads, r = e / colsp, c = e - r * colsp;
        if (e < rowsp * colsp) dst[r * sstride + c] = val[u];
      }
    }
  }
}

// cum[i] = sum_{t <= i} dt[t] * a for i < n: a block scan (warp shuffles,
// then the warps' totals), 256 steps at a time
__device__ void chunk_cumsum(const float* dt_s, float a, float* cum,
                             float* sums, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float carry = 0.f;
  for (int base = 0; base < n; base += kThreads) {
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
      float t = lane < kWarps ? sums[lane] : 0.f;
#pragma unroll
      for (int o = 1; o < kWarps; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, t, o);
        if (lane >= o) t += u;
      }
      if (lane < kWarps) sums[lane] = t;
    }
    __syncthreads();
    if (i < n) cum[i] = v + carry + (warp > 0 ? sums[warp - 1] : 0.f);
    carry += sums[kWarps - 1];
    __syncthreads();
  }
}

// c += a (16 x 16, row-major fragment) . b (16 x 8, column-major fragment)
__device__ __forceinline__ void mma_bf16(float& c0, float& c1, float& c2,
                                         float& c3, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c0), "+f"(c1), "+f"(c2), "+f"(c3)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
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

// The last block of a (batch, head) to arrive folds its chunks in order:
// each contribution is replaced by the state entering its chunk, and the
// final state is written. `cache` (at least `cap` floats of shared memory
// the block no longer needs) holds the decays where they fit.
__device__ void fold_chunks(float* contrib, const float* decay,
                            float* state_out, int* ticket, int* flag,
                            float* cache, int cap, int bh, int nblocks,
                            int nc, int P, int N) {
  const int tid = threadIdx.x;
  __threadfence();
  __syncthreads();
  if (tid == 0) flag[0] = atomicAdd(ticket + bh, 1) == nblocks - 1;
  __syncthreads();
  if (!flag[0]) return;
  __threadfence();
  float* cb = contrib + (size_t)bh * nc * P * N;
  float* so = state_out + (size_t)bh * P * N;
  const float* db = decay + (size_t)bh * nc;
  const bool cached = nc <= cap;
  if (cached)
    for (int i = tid; i < nc; i += kThreads) cache[i] = __ldcg(db + i);
  __syncthreads();
  // kF elements a thread at once, kU chunks' loads in flight for each
  constexpr int kF = 4, kU = 8;
  const size_t PN = (size_t)P * N;
  for (size_t e0 = tid; e0 < PN; e0 += (size_t)kF * kThreads) {
    float st[kF];
#pragma unroll
    for (int f = 0; f < kF; ++f) st[f] = 0.f;
    for (int i0 = 0; i0 < nc; i0 += kU) {
      float add[kU][kF];
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int f = 0; f < kF; ++f) {
          const size_t e = e0 + (size_t)f * kThreads;
          add[u][f] = (i0 + u < nc && e < PN)
                          ? __ldcg(cb + (size_t)(i0 + u) * PN + e)
                          : 0.f;
        }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (i0 + u >= nc) break;
        const float d = cached ? cache[i0 + u] : __ldcg(db + i0 + u);
#pragma unroll
        for (int f = 0; f < kF; ++f) {
          const size_t e = e0 + (size_t)f * kThreads;
          if (e < PN) cb[(size_t)(i0 + u) * PN + e] = st[f];  // entering
          st[f] = st[f] * d + add[u][f];
        }
      }
    }
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      const size_t e = e0 + (size_t)f * kThreads;
      if (e < PN) so[e] = st[f];
    }
  }
  if (tid == 0) ticket[bh] = 0;
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

// ---------------------------------------------------------------------------
// f32: every product on the CUDA cores
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    ssd_scan_state_f32(const float* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ a,
                       const float* __restrict__ bm,
                       float* __restrict__ contrib, float* __restrict__ decay,
                       float* __restrict__ state_out, int* __restrict__ ticket,
                       int S, int H, int P, int G, int N, int L, int nc,
                       int ns, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int part = blockIdx.x % ns;  // N parts fastest, then chunks
  const Chunk k = chunk_of(blockIdx.x / ns, H, G, S, L, nc);
  const int nb = round_up((N + ns - 1) / ns, 8), n0 = part * nb;
  const int nbc = max(0, min(nb, N - n0));
  const StateF32 ly = state_f32(L, P, nb);
  float* x_s = reinterpret_cast<float*>(smem);           // [Lc, P8]
  float* bw_s = reinterpret_cast<float*>(smem + ly.bw);  // [Lc, nb4]
  float* dt_s = reinterpret_cast<float*>(smem + ly.dt);
  float* cum = reinterpret_cast<float*>(smem + ly.cum);
  float* w_s = reinterpret_cast<float*>(smem + ly.w);
  float* sums = reinterpret_cast<float*>(smem + ly.sums);
  const int P8 = ly.P8, nb4 = ly.nb4;

  stage<float>(x_s, P8, x + (((size_t)k.b * S + k.c0) * H + k.h) * P,
               (size_t)H * P, k.Lc, P, k.Lc, P8, vec);
  for (int i = tid; i < k.Lc; i += kThreads)
    dt_s[i] = dt[((size_t)k.b * S + k.c0 + i) * H + k.h];
  if (vec) cp_async_wait_all();
  __syncthreads();
  chunk_cumsum(dt_s, a[k.h], cum, sums, k.Lc);
  const float total = cum[k.Lc - 1];
  for (int j = tid; j < k.Lc; j += kThreads)
    w_s[j] = expf(total - cum[j]) * dt_s[j];
  __syncthreads();
  const float* bsrc = bm + (((size_t)k.b * S + k.c0) * G + k.g) * N + n0;
  for (int e = tid; e < k.Lc * nb4; e += kThreads) {
    const int j = e / nb4, n = e - j * nb4;
    bw_s[e] = n < nbc ? bsrc[(size_t)j * G * N + n] * w_s[j] : 0.f;
  }
  __syncthreads();

  // contribution [P, nbc] = x^T (B * w), 4 x 4 outputs a thread
  float* out = contrib + ((size_t)k.bh * nc + k.c) * P * N;
  const int PT = P8 / 4, NT = nb4 / 4;
  for (int tt = tid; tt < PT * NT; tt += kThreads) {
    const int ni = tt % NT, pi = tt / NT;
    float acc[4][4] = {};
    for (int j = 0; j < k.Lc; ++j) {
      float xv[4], bv[4];
      load4(x_s + j * P8 + 4 * pi, xv);
      load4(bw_s + j * nb4 + 4 * ni, bv);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) acc[u][w] += xv[u] * bv[w];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = 4 * pi + u;
      if (p >= P) continue;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int n = 4 * ni + w;
        if (n < nbc) out[(size_t)p * N + n0 + n] = acc[u][w];
      }
    }
  }
  if (part == 0 && tid == 0) decay[(size_t)k.bh * nc + k.c] = expf(total);
  fold_chunks(contrib, decay, state_out, ticket,
              reinterpret_cast<int*>(smem + ly.flag), bw_s, L * nb4, k.bh,
              nc * ns, nc, P, N);
}

// R output rows a block (kRB, or kRBSmall where kRB's do not fit)
template <int R>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_out_f32(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const float* __restrict__ bm,
                     const float* __restrict__ cm,
                     const float* __restrict__ state_in, float* __restrict__ y,
                     int S, int H, int P, int G, int N, int L, int nc, int nrb,
                     int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int rb = nrb - 1 - blockIdx.x % nrb;  // the longer row blocks first
  const Chunk k = chunk_of(blockIdx.x / nrb, H, G, S, L, nc);
  const int i0 = rb * R;
  if (i0 >= k.Lc) return;
  const int nr = min(R, k.Lc - i0);  // rows of this block
  const int ncol = i0 + nr;          // columns j any of them needs
  const int ncol8 = round_up(ncol, 8);
  const OutF32 ly = out_f32<R>(L, P, N);
  const int P8 = ly.P8, Np = ly.Np, CS = ly.CS;
  constexpr int SS = R + 4;  // scores^T row stride
  float* x_s = reinterpret_cast<float*>(smem);            // [ncol, P8]
  float* s_t = reinterpret_cast<float*>(smem + ly.st);    // [ncol8, SS]
  float* c_s = reinterpret_cast<float*>(smem + ly.c);     // [R, CS]
  float* b_s = reinterpret_cast<float*>(smem + ly.u);     // [ncol8, CS]
  float* st_t = reinterpret_cast<float*>(smem + ly.u);    // [Np, P8 + 4]
  float* dt_s = reinterpret_cast<float*>(smem + ly.dt);
  float* cum = reinterpret_cast<float*>(smem + ly.cum);
  float* ecum = reinterpret_cast<float*>(smem + ly.ecum);
  float* sums = reinterpret_cast<float*>(smem + ly.sums);

  const size_t row0 = (size_t)k.b * S + k.c0;  // first step of the chunk
  stage<float>(x_s, P8, x + (row0 * H + k.h) * P, (size_t)H * P, ncol, P,
               ncol, P8, vec);
  stage<float>(c_s, CS, cm + ((row0 + i0) * G + k.g) * N, (size_t)G * N, nr,
               N, R, Np, vec);
  stage<float>(b_s, CS, bm + (row0 * G + k.g) * N, (size_t)G * N, ncol, N,
               ncol8, Np, vec);
  for (int i = tid; i < ncol; i += kThreads)
    dt_s[i] = dt[(row0 + i) * H + k.h];
  if (vec) cp_async_wait_all();
  __syncthreads();
  chunk_cumsum(dt_s, a[k.h], cum, sums, ncol);
  for (int r = tid; r < nr; r += kThreads) ecum[r] = expf(cum[i0 + r]);

  // scores^T[j, r] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i, else 0
  for (int e = tid; e < R * ncol8; e += kThreads) {
    const int row = e % R, col = e / R, i = i0 + row;
    float s = 0.f;
    if (row < nr && col <= i && col < ncol) {
      const float* ci = c_s + row * CS;
      const float* bj = b_s + col * CS;
      float cb = 0.f;
      for (int n = 0; n < N; ++n) cb += ci[n] * bj[n];
      s = cb * expf(cum[i] - cum[col]) * dt_s[col];
    }
    s_t[col * SS + row] = s;
  }
  __syncthreads();  // scores out; B's bytes are free

  const bool inter = k.c > 0;  // the state entering chunk 0 is 0
  if (inter) {
    const float* sp = state_in + ((size_t)k.bh * nc + k.c) * P * N;
    for (int e = tid; e < P8 * N; e += kThreads) {
      const int p = e / N, n = e - p * N;
      st_t[n * (P8 + 4) + p] = p < P ? sp[(size_t)p * N + n] : 0.f;
    }
    __syncthreads();
  }

  // y = scores . x + exp(cum_i) C . state_in: a thread owns rows
  // ri + 16 q (q < R / 16) and columns 4 pi .. 4 pi + 3; a warp spans 8
  // rows and 4 column groups, so its row-strided reads hit distinct banks
  constexpr int Q = R / 16;
  const int PT = P8 / 4, PT4 = round_up(PT, 4);
  for (int tt = tid; tt < 16 * PT4; tt += kThreads) {
    const int ri = (tt & 7) | (((tt >> 5) & 1) << 3);
    const int pi = ((tt >> 3) & 3) | ((tt >> 6) << 2);
    if (pi >= PT) continue;
    float acc[Q][4] = {};
    const int jmax = min(ncol, i0 + ri + 16 * (Q - 1) + 1);
    for (int j = 0; j < jmax; ++j) {
      float xv[4];
      load4(x_s + j * P8 + 4 * pi, xv);
      const float* sr = s_t + j * SS + ri;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float s = sr[16 * q];
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[q][u] += s * xv[u];
      }
    }
    if (inter) {
      float ac2[Q][4] = {};
      for (int n = 0; n < N; ++n) {
        float sv[4];
        load4(st_t + n * (P8 + 4) + 4 * pi, sv);
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const float cq = c_s[(ri + 16 * q) * CS + n];
#pragma unroll
          for (int u = 0; u < 4; ++u) ac2[q][u] += cq * sv[u];
        }
      }
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int r = ri + 16 * q;
        const float e = r < nr ? ecum[r] : 0.f;
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[q][u] += e * ac2[q][u];
      }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int r = ri + 16 * q;
      if (r >= nr) continue;
      float* yr = y + ((row0 + i0 + r) * H + k.h) * P;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (4 * pi + u < P) yr[4 * pi + u] = acc[q][u];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: every product on the tensor cores
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    ssd_scan_state_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ a, const bf16* __restrict__ bm,
                      float* __restrict__ contrib, float* __restrict__ decay,
                      float* __restrict__ state_out, int* __restrict__ ticket,
                      int S, int H, int P, int G, int N, int L, int nc, int ns,
                      int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int part = blockIdx.x % ns;  // N parts fastest, then chunks
  const Chunk k = chunk_of(blockIdx.x / ns, H, G, S, L, nc);
  const int nb = round_up((N + ns - 1) / ns, 8), n0 = part * nb;
  const int nbc = max(0, min(nb, N - n0));
  const StateTC ly = state_tc(L, P, nb);
  const int PS = ly.PS, NBS = ly.NBS, K16 = round_up(k.Lc, 16);
  bf16* x_s = reinterpret_cast<bf16*>(smem);             // [K16, PS]
  bf16* bhi = reinterpret_cast<bf16*>(smem + ly.bhi);    // [K16, NBS]
  bf16* blo = reinterpret_cast<bf16*>(smem + ly.blo);    // [K16, NBS]
  float* dt_s = reinterpret_cast<float*>(smem + ly.dt);
  float* cum = reinterpret_cast<float*>(smem + ly.cum);
  float* w_s = reinterpret_cast<float*>(smem + ly.w);
  float* sums = reinterpret_cast<float*>(smem + ly.sums);

  // every copy in flight at once: x, the raw B columns (into bhi), dt
  const size_t row0 = (size_t)k.b * S + k.c0;
  stage<bf16>(x_s, PS, x + (row0 * H + k.h) * P, (size_t)H * P, k.Lc, P, K16,
              ly.P16, vec);
  stage<bf16>(bhi, NBS, bm + (row0 * G + k.g) * N + n0, (size_t)G * N, k.Lc,
              nbc, K16, nb, vec && n0 % 8 == 0);
  for (int i = tid; i < k.Lc; i += kThreads) dt_s[i] = dt[(row0 + i) * H + k.h];
  __syncthreads();
  chunk_cumsum(dt_s, a[k.h], cum, sums, k.Lc);
  const float total = cum[k.Lc - 1];
  for (int j = tid; j < k.Lc; j += kThreads)
    w_s[j] = expf(total - cum[j]) * dt_s[j];
  if (vec) cp_async_wait_all();
  __syncthreads();
  // B * w, split into hi + lo in place
  for (int e = tid; e < K16 * nb; e += kThreads) {
    const int j = e / nb, n = e - j * nb;
    const float bw = (j < k.Lc && n < nbc)
                         ? __bfloat162float(bhi[j * NBS + n]) * w_s[j]
                         : 0.f;
    split_bf16(bw, bhi[j * NBS + n], blo[j * NBS + n]);
  }
  __syncthreads();

  // contribution [P, nbc] = x^T (B * w): 16 x 8 tiles over the warps, both
  // operands read K-major (K = the chunk's steps)
  float* out = contrib + ((size_t)k.bh * nc + k.c) * P * N;
  const int mtn = ly.P16 / 16, ntn = nb / 8;
  for (int t = warp; t < mtn * ntn; t += kWarps) {
    const int mt = t % mtn, nt = t / mtn;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < K16; k0 += 16) {
      uint32_t af[4], bh[2], bl[2];
      lds_a_t(af, x_s, PS, k0, mt * 16);
      lds_b_t(bh, bhi, NBS, k0, nt * 8);
      lds_b_t(bl, blo, NBS, k0, nt * 8);
      mma_bf16(c[0], c[1], c[2], c[3], af[0], af[1], af[2], af[3], bh[0],
               bh[1]);
      mma_bf16(c[0], c[1], c[2], c[3], af[0], af[1], af[2], af[3], bl[0],
               bl[1]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = mt * 16 + gid + 8 * (r >> 1);
      const int n = nt * 8 + 2 * tig + (r & 1);
      if (p < P && n < nbc) out[(size_t)p * N + n0 + n] = c[r];
    }
  }
  if (part == 0 && tid == 0) decay[(size_t)k.bh * nc + k.c] = expf(total);
  fold_chunks(contrib, decay, state_out, ticket,
              reinterpret_cast<int*>(smem + ly.flag),
              reinterpret_cast<float*>(bhi), K16 * NBS / 2, k.bh, nc * ns, nc,
              P, N);
}

// One block per chunk. Warp w takes the 16-row tiles rg and 7 - rg of each
// eight (rg = w % 4, so every warp has the same share of the triangle) and
// half of P's 8-column tiles (w / 4), four at a time. For each 16 x 16
// slice of scores up to the diagonal it computes C . B^T, applies the decay
// and dt in registers, splits the slice into hi + lo bf16 A fragments
// (the accumulator's layout is the next product's A layout) and multiplies
// them into y with x read K-major, so the scores never leave registers.
__global__ void __launch_bounds__(kThreads)
    ssd_scan_out_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const bf16* __restrict__ bm,
                    const bf16* __restrict__ cm,
                    const float* __restrict__ state_in, bf16* __restrict__ y,
                    int S, int H, int P, int G, int N, int L, int nc,
                    int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kNT = 4;  // 8-column tiles of P a warp holds at once
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const Chunk k = chunk_of(blockIdx.x, H, G, S, L, nc);
  const OutTC ly = out_tc(L, P, N);
  const int Np = ly.Np, CS = ly.CS, PS = ly.PS, P16 = ly.P16;
  const int K16 = round_up(k.Lc, 16);
  bf16* c_s = reinterpret_cast<bf16*>(smem);              // [K16, CS]
  bf16* b_s = reinterpret_cast<bf16*>(smem + ly.b);       // [K16, CS]
  bf16* x_s = reinterpret_cast<bf16*>(smem + ly.x);       // [K16, PS]
  bf16* st_hi = reinterpret_cast<bf16*>(smem + ly.shi);   // [P16, CS]
  bf16* st_lo = reinterpret_cast<bf16*>(smem + ly.slo);   // [P16, CS]
  float* dt_s = reinterpret_cast<float*>(smem + ly.dt);
  float* cum = reinterpret_cast<float*>(smem + ly.cum);
  float* sums = reinterpret_cast<float*>(smem + ly.sums);

  // every copy in flight at once: C, B, x, dt, the entering state
  const size_t row0 = (size_t)k.b * S + k.c0;  // first step of the chunk
  stage<bf16>(c_s, CS, cm + (row0 * G + k.g) * N, (size_t)G * N, k.Lc, N, K16,
              Np, vec);
  stage<bf16>(b_s, CS, bm + (row0 * G + k.g) * N, (size_t)G * N, k.Lc, N, K16,
              Np, vec);
  stage<bf16>(x_s, PS, x + (row0 * H + k.h) * P, (size_t)H * P, k.Lc, P, K16,
              P16, vec);
  for (int i = tid; i < k.Lc; i += kThreads) dt_s[i] = dt[(row0 + i) * H + k.h];
  const bool inter = k.c > 0;  // the state entering chunk 0 is 0
  if (inter) {  // state_in [P, N] f32 -> hi + lo [P16, Np]
    const float* sp = state_in + ((size_t)k.bh * nc + k.c) * P * N;
    constexpr int U = 8;
    const int nst = P16 * Np;
    for (int e0 = tid; e0 < nst; e0 += U * kThreads) {
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * kThreads, p = e / Np, n = e - p * Np;
        v[u] = (e < nst && p < P && n < N) ? __ldg(sp + (size_t)p * N + n)
                                           : 0.f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * kThreads, p = e / Np, n = e - p * Np;
        if (e < nst) split_bf16(v[u], st_hi[p * CS + n], st_lo[p * CS + n]);
      }
    }
  }
  __syncthreads();
  chunk_cumsum(dt_s, a[k.h], cum, sums, k.Lc);
  if (vec) cp_async_wait_all();
  __syncthreads();

  const int rg = warp & 3, half = warp >> 2;
  const int ntp = P16 / 8, nth = (ntp + 1) / 2;
  const int nt_lo = half * nth, nt_hi = min(ntp, nt_lo + nth);
  const int nmt = K16 / 16;
  for (int mb = 0; mb < nmt; mb += 8) {
    for (int pick = 0; pick < 2; ++pick) {
      const int mt = mb + (pick == 0 ? rg : 7 - rg);
      if (mt >= nmt) continue;
      const int i_lo = mt * 16;
      const bf16* ca = c_s + (i_lo + gid) * CS + 2 * tig;  // A rows of C
      for (int g0 = nt_lo; g0 < nt_hi; g0 += kNT) {
        float yv[kNT][4] = {};
        for (int ks = 0; ks <= mt; ++ks) {  // 16-column slices j <= i
          float s[2][4] = {};
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const bf16* bp = b_s + (ks * 16 + 8 * h2 + gid) * CS + 2 * tig;
            for (int k0 = 0; k0 < Np; k0 += 16)
              mma_bf16(s[h2][0], s[h2][1], s[h2][2], s[h2][3], lds32(ca + k0),
                       lds32(ca + 8 * CS + k0), lds32(ca + k0 + 8),
                       lds32(ca + 8 * CS + k0 + 8), lds32(bp + k0),
                       lds32(bp + k0 + 8));
          }
          uint32_t ahi[4], alo[4];
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int i = i_lo + gid + 8 * rr;
              float v[2];
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                const int j = ks * 16 + 8 * h2 + 2 * tig + u;
                v[u] = (j <= i && i < k.Lc)
                           ? s[h2][2 * rr + u] * expf(cum[i] - cum[j]) * dt_s[j]
                           : 0.f;
              }
              const __nv_bfloat162 hi = __floats2bfloat162_rn(v[0], v[1]);
              ahi[2 * h2 + rr] = *reinterpret_cast<const uint32_t*>(&hi);
              alo[2 * h2 + rr] = pack_bf16(v[0] - __low2float(hi),
                                           v[1] - __high2float(hi));
            }
#pragma unroll
          for (int q = 0; q < kNT; ++q) {
            if (g0 + q >= nt_hi) break;
            uint32_t bx[2];
            lds_b_t(bx, x_s, PS, ks * 16, (g0 + q) * 8);
            mma_bf16(yv[q][0], yv[q][1], yv[q][2], yv[q][3], ahi[0], ahi[1],
                     ahi[2], ahi[3], bx[0], bx[1]);
            mma_bf16(yv[q][0], yv[q][1], yv[q][2], yv[q][3], alo[0], alo[1],
                     alo[2], alo[3], bx[0], bx[1]);
          }
        }
        if (inter) {  // + exp(cum_i) C_i . state_in
          float d[kNT][4] = {};
          for (int k0 = 0; k0 < Np; k0 += 16) {
            const uint32_t a0 = lds32(ca + k0), a1 = lds32(ca + 8 * CS + k0);
            const uint32_t a2 = lds32(ca + k0 + 8);
            const uint32_t a3 = lds32(ca + 8 * CS + k0 + 8);
#pragma unroll
            for (int q = 0; q < kNT; ++q) {
              if (g0 + q >= nt_hi) break;
              const int off = ((g0 + q) * 8 + gid) * CS + k0 + 2 * tig;
              mma_bf16(d[q][0], d[q][1], d[q][2], d[q][3], a0, a1, a2, a3,
                       lds32(st_hi + off), lds32(st_hi + off + 8));
              mma_bf16(d[q][0], d[q][1], d[q][2], d[q][3], a0, a1, a2, a3,
                       lds32(st_lo + off), lds32(st_lo + off + 8));
            }
          }
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int i = i_lo + gid + 8 * rr;
            const float e = i < k.Lc ? expf(cum[i]) : 0.f;
#pragma unroll
            for (int q = 0; q < kNT; ++q) {
              yv[q][2 * rr] += e * d[q][2 * rr];
              yv[q][2 * rr + 1] += e * d[q][2 * rr + 1];
            }
          }
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = i_lo + gid + 8 * rr;
          if (i >= k.Lc) continue;
          bf16* yr = y + ((row0 + i) * H + k.h) * P;
#pragma unroll
          for (int q = 0; q < kNT; ++q) {
            if (g0 + q >= nt_hi) break;
            const int p = (g0 + q) * 8 + 2 * tig;
            if (p + 1 < P && P % 2 == 0) {
              *reinterpret_cast<__nv_bfloat162*>(yr + p) =
                  __floats2bfloat162_rn(yv[q][2 * rr], yv[q][2 * rr + 1]);
            } else {
              if (p < P) yr[p] = __float2bfloat16(yv[q][2 * rr]);
              if (p + 1 < P) yr[p + 1] = __float2bfloat16(yv[q][2 * rr + 1]);
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// opt a kernel in to the shared memory it needs past the default 48 KB
template <typename K>
cudaError_t opt_in(K kernel, size_t smem, size_t& opted) {
  if (smem <= opted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (err == cudaSuccess) opted = kMaxSmem;
  return err;
}

int launch_f32(const float* x, const float* dt, const float* a,
               const float* bm, const float* cm, float* y, float* state,
               float* contrib, float* decay, int* ticket, int B, int S, int H,
               int P, int G, int N, int L, int ns, int vec, cudaStream_t s) {
  const int nc = (S + L - 1) / L;
  const int nb = round_up((N + ns - 1) / ns, 8);
  // kRB output rows a block where they fit, else kRBSmall
  const bool small = out_f32(L, P, N).total > kMaxSmem;
  const int rows = small ? kRBSmall : kRB, nrb = (L + rows - 1) / rows;
  const size_t sm1 = state_f32(L, P, nb).total;
  const size_t sm2 = small ? out_f32<kRBSmall>(L, P, N).total
                           : out_f32(L, P, N).total;
  if (sm1 > kMaxSmem || sm2 > kMaxSmem) return (int)cudaErrorInvalidValue;
  const auto out_kernel =
      small ? ssd_scan_out_f32<kRBSmall> : ssd_scan_out_f32<kRB>;
  static size_t opted1 = 48 * 1024, opted2 = 48 * 1024, opted3 = 48 * 1024;
  cudaError_t err = opt_in(ssd_scan_state_f32, sm1, opted1);
  if (err == cudaSuccess)
    err = opt_in(out_kernel, sm2, small ? opted3 : opted2);
  if (err != cudaSuccess) return (int)err;
  const long long bh = (long long)B * H;
  ssd_scan_state_f32<<<(unsigned)(bh * nc * ns), kThreads, sm1, s>>>(
      x, dt, a, bm, contrib, decay, state, ticket, S, H, P, G, N, L, nc, ns,
      vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  out_kernel<<<(unsigned)(bh * nc * nrb), kThreads, sm2, s>>>(
      x, dt, a, bm, cm, contrib, y, S, H, P, G, N, L, nc, nrb, vec);
  return (int)cudaGetLastError();
}

int launch_tc(const bf16* x, const float* dt, const float* a, const bf16* bm,
              const bf16* cm, bf16* y, float* state, float* contrib,
              float* decay, int* ticket, int B, int S, int H, int P, int G,
              int N, int L, int ns, int vec, cudaStream_t s) {
  const int nc = (S + L - 1) / L;
  const int nb = round_up((N + ns - 1) / ns, 8);
  const size_t sm1 = state_tc(L, P, nb).total, sm2 = out_tc(L, P, N).total;
  if (sm1 > kMaxSmem || sm2 > kMaxSmem) return (int)cudaErrorInvalidValue;
  static size_t opted1 = 48 * 1024, opted2 = 48 * 1024;
  cudaError_t err = opt_in(ssd_scan_state_tc, sm1, opted1);
  if (err == cudaSuccess) err = opt_in(ssd_scan_out_tc, sm2, opted2);
  if (err != cudaSuccess) return (int)err;
  const long long bh = (long long)B * H;
  ssd_scan_state_tc<<<(unsigned)(bh * nc * ns), kThreads, sm1, s>>>(
      x, dt, a, bm, contrib, decay, state, ticket, S, H, P, G, N, L, nc, ns,
      vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_scan_out_tc<<<(unsigned)(bh * nc), kThreads, sm2, s>>>(
      x, dt, a, bm, cm, contrib, y, S, H, P, G, N, L, nc, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y share it; dt, a and the
// state are float32). `contrib` is f32 scratch of B * H * ceil(S / L) * P * N
// floats, `decay` of B * H * ceil(S / L), `ticket` B * H int32 counters that
// are 0 before the call and 0 again after it; `ns` (1 or 2) cuts N over the
// first grid's blocks; `vec` = 1 when P and N are multiples of 16 bytes'
// worth of elements and x, B, C start 16-byte aligned. Two grids on
// `stream`; returns the first failing launch's cudaError_t (0 on success),
// never synchronises.
extern "C" int ssd(int dtype, const void* x, const void* dt, const void* a,
                   const void* bm, const void* cm, void* y, void* state,
                   void* contrib, void* decay, void* ticket, int B, int S,
                   int H, int P, int G, int N, int L, int ns, int vec,
                   void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || G <= 0 || H % G != 0 ||
      N <= 0 || L <= 0 || ns < 1 || ns > 2 || contrib == nullptr ||
      decay == nullptr || ticket == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* stf = static_cast<float*>(state);
  float* cf = static_cast<float*>(contrib);
  float* df = static_cast<float*>(decay);
  int* tk = static_cast<int*>(ticket);
  if (dtype == 0)
    return launch_f32(static_cast<const float*>(x), dtf, af,
                      static_cast<const float*>(bm),
                      static_cast<const float*>(cm), static_cast<float*>(y),
                      stf, cf, df, tk, B, S, H, P, G, N, L, ns, vec, s);
  if (dtype == 1)
    return launch_tc(static_cast<const bf16*>(x), dtf, af,
                     static_cast<const bf16*>(bm),
                     static_cast<const bf16*>(cm), static_cast<bf16*>(y), stf,
                     cf, df, tk, B, S, H, P, G, N, L, ns, vec, s);
  return (int)cudaErrorInvalidValue;
}
